"""Consistent-hash tenant placement for the distributed serve plane (the
port of ``torcheval_tpu/serve/placement.py``; host Python, no tensor).

The placement tier answers one question deterministically on every
host: *which live rank owns tenant T right now?*  It is built so that
two hosts holding the same facts always compute the same answer without
a coordination round, and so that the port's answer is the JAX
package's for the same facts (the same sha256 labels):

* **Ring**: each member rank contributes ``vnodes`` virtual points on
  a sha256 ring (:class:`HashRing`); a tenant hashes to the first
  clockwise point.  Virtual nodes smooth the per-host load to within a
  few percent of uniform, and removing a host moves only the tenants
  that hashed to its arcs (the classic consistent-hashing guarantee:
  survivors' assignments are untouched).
* **Membership-keyed**: the ring is a pure function of the *alive*
  member set, which every host derives from its
  :class:`~torcheval_tpu_torch.resilience.membership.MembershipView`
  plus gossip.  Dead sets only grow, so they merge by union.
* **Migration overrides**: a live migration pins one tenant to an
  explicit owner with a version number.  Overrides merge per tenant by
  max version, so the (dead set, overrides) pair is a join-semilattice:
  any gossip order converges every host to the same state, and the
  :attr:`Placement.epoch`, a pure function of that state, converges
  with it.  An override whose owner has died is ignored (the ring over
  the survivors takes back over), never deleted, so late gossip cannot
  resurrect a stale owner.

Every cluster-level action reports a typed :class:`PlacementOutcome`;
the cluster API never lets an exception escape.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
from dataclasses import dataclass
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

# Matches the SERVE_VNODES flag default (``_flags.py``); the cluster
# reads the flag at construction and passes the value down.
DEFAULT_VNODES = 64


def _point(label: str) -> int:
    """A 64-bit ring position from a stable label (first 8 bytes of
    sha256: uniform, platform-independent, and identical on every
    host, unlike ``hash()``)."""
    return int.from_bytes(
        hashlib.sha256(label.encode("utf-8")).digest()[:8], "big"
    )


class HashRing:
    """Deterministic consistent-hash ring over a member set.

    Immutable once built; the placement tier rebuilds it when the alive
    set changes (host death), which is rare and O(members × vnodes).
    """

    def __init__(
        self, members: Iterable[int], *, vnodes: int = DEFAULT_VNODES
    ) -> None:
        self.members: Tuple[int, ...] = tuple(
            sorted({int(m) for m in members})
        )
        if not self.members:
            raise ValueError("HashRing needs at least one member")
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = int(vnodes)
        points: List[Tuple[int, int]] = []
        for rank in self.members:
            for i in range(self.vnodes):
                points.append((_point(f"vnode/{rank}/{i}"), rank))
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [r for _, r in points]

    def owner_of(self, tenant: str) -> int:
        """The member owning ``tenant``: first vnode point clockwise of
        the tenant's hash (wrapping at the top of the ring)."""
        h = _point(f"tenant/{tenant}")
        i = bisect.bisect_right(self._points, h)
        if i == len(self._points):
            i = 0
        return self._owners[i]

    def spread(self, tenants: Iterable[str]) -> Dict[int, int]:
        """Tenant count per member: the load-balance census."""
        out: Dict[int, int] = {m: 0 for m in self.members}
        for t in tenants:
            out[self.owner_of(t)] += 1
        return out


@dataclass(frozen=True)
class Override:
    """One migration pin: ``tenant`` is owned by ``owner`` as of
    ``version`` (monotone per tenant; max-version wins on merge)."""

    owner: int
    version: int


@dataclass(frozen=True)
class PlacementOutcome:
    """Typed result of a cluster placement action.  ``action`` is the
    branch key; the cluster API returns these instead of raising:

    ``local``      handled on this host (``value`` = the service outcome)
    ``routed``     shipped to ``owner`` over p2p (ack pending)
    ``shed``       backpressure: route window full or remote shedding
    ``rejected``   unknown/closed/quarantined tenant
    ``migrated``   two-phase handoff committed to ``owner``
    ``aborted``    migration abandoned (target died / injected fault);
                   the tenant stayed bit-exact on the source
    ``repaired``   ring repaired around a dead host
    ``recovered``  a dead host's tenant resumed from its spill
    ``lost``       a dead host's unspilled session — state unrecoverable
    ``dead``       this host has been declared dead (no-op)
    ``timeout``    a remote query exceeded its wait budget
    """

    tenant: str
    action: str
    owner: int = -1
    epoch: int = 0
    detail: str = ""
    value: Any = None


class Placement:
    """Membership-keyed placement state: ring over the alive set plus
    migration overrides, merged by gossip.

    Thread-safe; the cluster's router and rebalancer threads both read
    it.  ``epoch`` is a deterministic function of the converged state
    (``len(dead) + Σ override versions``), so "placement converged to
    one consistent ring epoch on all survivors" is checkable by
    comparing integers — and :meth:`fingerprint` hashes the full state
    for the stricter assertion.
    """

    def __init__(
        self, world_size: int, *, vnodes: int = DEFAULT_VNODES
    ) -> None:
        if world_size < 1:
            raise ValueError(f"world_size must be >= 1, got {world_size}")
        self._world = int(world_size)
        self._vnodes = int(vnodes)
        self._lock = threading.Lock()
        self._dead: set = set()
        self._overrides: Dict[str, Override] = {}
        # None once every rank is dead (gossip can legitimately fold
        # in a full dead set): owner_of() then answers -1 instead of
        # consulting a stale pre-death ring.
        self._ring: Optional[HashRing] = HashRing(
            range(world_size), vnodes=vnodes
        )

    # ------------------------------------------------------------ queries
    @property
    def epoch(self) -> int:
        with self._lock:
            return len(self._dead) + sum(
                o.version for o in self._overrides.values()
            )

    @property
    def alive(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(
                r for r in range(self._world) if r not in self._dead
            )

    @property
    def dead(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(sorted(self._dead))

    def owner_of(self, tenant: str) -> int:
        """Current owner: a live override wins; otherwise the ring over
        the survivors.  An override pointing at a dead rank is ignored
        (not deleted — late gossip must not resurrect it).  Returns
        ``-1`` when every rank is dead (no stale pre-death answer; the
        cluster turns it into a typed ``dead`` outcome)."""
        with self._lock:
            if self._ring is None:
                return -1
            ovr = self._overrides.get(tenant)
            if ovr is not None and ovr.owner not in self._dead:
                return ovr.owner
            return self._ring.owner_of(tenant)

    def ring_owner_of(self, tenant: str) -> int:
        """The ring's answer, ignoring overrides (used by ring-repair
        to find which of a dead host's tenants fall to this host);
        ``-1`` when every rank is dead."""
        with self._lock:
            if self._ring is None:
                return -1
            return self._ring.owner_of(tenant)

    def override_version(self, tenant: str) -> int:
        with self._lock:
            ovr = self._overrides.get(tenant)
            return ovr.version if ovr is not None else 0

    def fingerprint(self) -> str:
        """sha256 over the canonical (dead, overrides) state — equal on
        two hosts iff their placements fully converged."""
        with self._lock:
            parts = [",".join(str(r) for r in sorted(self._dead))]
            for tenant in sorted(self._overrides):
                o = self._overrides[tenant]
                parts.append(f"{tenant}={o.owner}@{o.version}")
        return hashlib.sha256("|".join(parts).encode()).hexdigest()

    def snapshot(self) -> Dict[str, Any]:
        """The gossip payload: dead list + overrides as plain tuples."""
        with self._lock:
            return {
                "dead": sorted(self._dead),
                "ovr": {
                    t: (o.owner, o.version)
                    for t, o in self._overrides.items()
                },
            }

    # ------------------------------------------------------------ updates
    def exclude(self, rank: int) -> bool:
        """Mark ``rank`` dead and rebuild the ring over the survivors.
        Returns True when this changed the state."""
        with self._lock:
            if rank in self._dead or not (0 <= rank < self._world):
                return False
            self._dead.add(rank)
            survivors = [
                r for r in range(self._world) if r not in self._dead
            ]
            if survivors:
                self._ring = HashRing(survivors, vnodes=self._vnodes)
            else:
                self._ring = None
            return True

    def note_migration(self, tenant: str, owner: int, version: int) -> bool:
        """Install a migration pin; max version wins (idempotent under
        gossip replay).  Returns True when this advanced the state."""
        with self._lock:
            cur = self._overrides.get(tenant)
            if cur is not None and cur.version >= version:
                return False
            self._overrides[tenant] = Override(
                owner=int(owner), version=int(version)
            )
            return True

    def merge(
        self,
        dead: Iterable[int],
        overrides: Optional[Mapping[str, Tuple[int, int]]] = None,
    ) -> bool:
        """Fold a peer's gossip into this view (semilattice join:
        dead-set union, per-tenant max override version).  Returns True
        when anything changed."""
        changed = False
        for rank in dead:
            changed |= self.exclude(int(rank))
        if overrides:
            for tenant, (owner, version) in overrides.items():
                changed |= self.note_migration(tenant, owner, version)
        return changed
