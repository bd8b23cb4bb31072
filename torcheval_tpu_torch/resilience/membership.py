"""Live-rank membership for the elastic fleet merge (the port of
``torcheval_tpu/resilience/membership.py``; the fleet merge that feeds it
comes with ROADMAP queue 1 item 6).

A :class:`MembershipView` is one rank's picture of which peers are still
alive.  There is no separate failure detector and no extra heartbeat
traffic: heartbeats ride the merge itself.  Every payload and ack the
hierarchical merge (``parallel/fleet_merge.py``) ships
carries the sender's rank plus its dead-rank gossip; receiving one calls
:meth:`observe` (refreshing the sender) and :meth:`merge_gossip`
(folding in deaths the sender already discovered), and a hop that times
out past its retry budget calls :meth:`excise`.

Excision is how a host leaves mid-eval without killing the run: the
excised rank's contribution is dropped, the merge continues over the
survivors, and the final result is labelled partial with
``world_effective = world_size - len(dead)``.  Every excision emits a
``degraded`` telemetry event whose ``survivors`` field carries the
surviving-rank set (``"0,2,3"``), so ``telemetry.fleet_report`` can
attribute exactly which hosts were lost and as seen from where.

Views are deliberately local: two ranks may briefly disagree about a
slow peer (one excised it, the other got its payload).  The merge layer
resolves that with contributor-set bookkeeping, not with a consensus
round — see ``fleet_merge``'s module docstring for the guarantees.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Iterable, Optional, Set

from torcheval_tpu_torch.telemetry import events as _telemetry
from torcheval_tpu_torch.telemetry import flightrec as _flightrec


class MembershipView:
    """One rank's live/dead bookkeeping over a fixed initial world.

    Thread-safe: the engine's overlap hook runs the merge on a
    background thread while telemetry readers snapshot the view.
    """

    def __init__(self, world_size: int, rank: int) -> None:
        if world_size < 1:
            raise ValueError(f"world_size must be >= 1, got {world_size}")
        if not 0 <= rank < world_size:
            raise ValueError(
                f"rank must be in [0, {world_size}), got {rank}"
            )
        self.world_size = int(world_size)
        self.rank = int(rank)
        self._lock = threading.Lock()
        self._dead: Set[int] = set()
        self._reasons: Dict[int, str] = {}
        # rank -> (merge level last heard at, monotonic time)
        self._last_seen: Dict[int, Any] = {
            rank: (-1, time.monotonic())
        }
        self.generation = 0

    # ----------------------------------------------------------- queries
    @property
    def alive(self) -> Set[int]:
        with self._lock:
            return set(range(self.world_size)) - self._dead

    @property
    def dead(self) -> Set[int]:
        with self._lock:
            return set(self._dead)

    @property
    def world_effective(self) -> int:
        """Live ranks remaining — the ``N - k`` a partial result is
        labelled with."""
        with self._lock:
            return self.world_size - len(self._dead)

    def is_alive(self, rank: int) -> bool:
        with self._lock:
            return rank not in self._dead

    def survivors_label(self) -> str:
        """The surviving-rank set as the compact ``"0,2,3"`` string the
        ``degraded`` telemetry event carries."""
        return ",".join(str(r) for r in sorted(self.alive))

    # ----------------------------------------------------------- updates
    def observe(self, rank: int, *, level: int = -1) -> None:
        """A heartbeat: ``rank`` was heard from (piggybacked on a merge
        payload or ack at ``level``).  A rank heard from again after an
        excision is NOT resurrected — its contribution was already
        dropped from the running merge; re-admission is the next merge
        round's job (each round starts from a fresh view)."""
        with self._lock:
            self._last_seen[rank] = (level, time.monotonic())

    def excise(self, rank: int, reason: str = "") -> bool:
        """Declare ``rank`` dead (retry budget exhausted).  Returns
        True the first time, False for an already-dead rank.  Emits the
        ``degraded`` telemetry event with the surviving-rank set."""
        with self._lock:
            if rank in self._dead or rank == self.rank:
                return False
            self._dead.add(rank)
            self._reasons[rank] = reason
            self.generation += 1
            survivors = ",".join(
                str(r)
                for r in sorted(set(range(self.world_size)) - self._dead)
            )
        if _telemetry.ENABLED:
            _telemetry.record_degraded(
                "membership",
                reason or f"rank {rank} unresponsive",
                fallback="excised",
                survivors=survivors,
            )
        if _flightrec.ENABLED:
            _flightrec.trigger(
                "excision",
                reason or f"rank {rank} unresponsive",
                extra={"membership": self.snapshot()},
            )
        return True

    def merge_gossip(self, dead: Iterable[int], reason: str = "gossip") -> None:
        """Fold a peer's dead-set (shipped on every merge payload/ack)
        into this view."""
        for rank in dead:
            self.excise(int(rank), reason=reason)

    # --------------------------------------------------------- reporting
    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "world_size": self.world_size,
                "rank": self.rank,
                "world_effective": self.world_size - len(self._dead),
                "dead": sorted(self._dead),
                "reasons": dict(self._reasons),
                "generation": self.generation,
                "last_seen": {
                    r: {"level": lv, "age_s": time.monotonic() - t}
                    for r, (lv, t) in self._last_seen.items()
                },
            }

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (
            f"MembershipView(rank={self.rank}, "
            f"alive={sorted(self.alive)}, dead={sorted(self.dead)})"
        )


def resolve_membership(
    view: Optional[MembershipView], world_size: int, rank: int
) -> MembershipView:
    """The merge entry points accept an optional caller-held view (to
    carry knowledge across rounds); absent one, each round starts
    fresh."""
    if view is None:
        return MembershipView(world_size, rank)
    if view.world_size != world_size or view.rank != rank:
        raise ValueError(
            f"membership view is for rank {view.rank}/"
            f"{view.world_size}, group says {rank}/{world_size}."
        )
    return view
