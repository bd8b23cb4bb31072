"""Elastic hierarchical fleet merge: tree / ring reduction with per-level
retry, live membership and sketch payloads (the port of
``torcheval_tpu/parallel/fleet_merge.py``).

The flat sync (``toolkit.get_synced_metric``) is one world-sized gather
into the recipient: every rank's state lands in one inbox in one step,
and one silent rank stalls the whole collective.  This module reduces
the same state **hierarchically** over the point-to-point channel of any
:class:`~torcheval_tpu_torch.distributed.CollectiveGroup` with
``supports_p2p`` (a :class:`~torcheval_tpu_torch.distributed.LocalGroup`,
or a :class:`~torcheval_tpu_torch.distributed.TorchProcessGroup` over its
c10d store):

* **Bounded fan-in.**  ``topology="tree"`` reduces over a binary heap
  tree rooted at ``dst`` (position ``(rank - dst) % world``, parent
  ``(pos - 1) // 2``): the root's inbox is 2 envelopes, not
  ``world - 1``, and each of the O(log world) levels ships merged state.
  ``topology="ring"`` is the one-fanout chain (O(world) levels).
* **Per-level resilience.**  Every hop runs under its own
  :class:`~torcheval_tpu_torch.resilience.retry.ResilientGroup` with a
  deadline scaled to the subtree beneath it.  A hop that runs out of
  budget *excises* the peer in this rank's
  :class:`~torcheval_tpu_torch.resilience.membership.MembershipView` (one
  ``degraded`` event carrying the surviving ranks) and the protocol routes
  around it: an orphaned child re-sends to its grandparent, a parent that
  excised a child polls for that child's subtree (and the child's own
  late envelope) during a bounded window, and a rank mid-recovery sends
  keepalives up its ancestor chain so no live subtree is excised for
  being slow.  The result is labelled **partial** (``world_effective <
  world_size``) instead of the run dying: no peer failure raises past the
  root.
* **O(bins) payloads.**  ``sketch="reservoir" | "histogram" | "count" |
  "rank"`` ships :mod:`torcheval_tpu_torch.metrics._sketch` summaries
  (``"rank"``: a sketch-mode curve metric's integer compactor counts,
  bit-identical at every world size and topology).  ``sketch=None`` ships
  each rank's prepared state keyed by rank, reassembled in rank order at
  the root: bit-identical to the flat gather-and-merge on a clean run,
  and the root's ``compute()`` takes the same kernels as the flat one's.

Heartbeats ride the merge itself: every envelope and ack refreshes the
sender in the receiver's membership view and carries its dead-rank gossip.

Chaos hooks: the ``merge.level`` fault site fires at every participation
step with ``rank`` / ``level`` / ``round`` / ``topology`` / ``role``
context (``action="drop_rank"`` makes the matched rank vanish,
``"slow_rank"`` makes it a straggler), the JAX package's keys, so one
:class:`~torcheval_tpu_torch.resilience.FaultPlan` drives both packages.
Telemetry: each hop emits a ``sync`` event with ``level`` / ``fanout`` /
``payload_bytes``, as the JAX package's does.

The whole protocol is host threads and pickles: a metric's states travel
through the CPU (``Metric.__getstate__``) and come back on its device.
Front door: ``toolkit.sync_and_compute(metric, group, topology="tree",
sketch=...)``; the engine's overlap hook is
``Evaluator.start_fleet_merge``.
"""

from __future__ import annotations

import copy
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, FrozenSet, List, Optional, Set, Tuple

from torcheval_tpu_torch.distributed import CollectiveGroup, PeerTimeoutError
from torcheval_tpu_torch.metrics._sketch import state_nbytes
from torcheval_tpu_torch.resilience import faults as _faults
from torcheval_tpu_torch.resilience.faults import DroppedRank
from torcheval_tpu_torch.resilience.membership import MembershipView, resolve_membership
from torcheval_tpu_torch.resilience.retry import (
    CollectiveTimeoutError,
    ResilientGroup,
    RetryPolicy,
)
from torcheval_tpu_torch.telemetry import events as _telemetry
from torcheval_tpu_torch.telemetry import trace as _trace

TOPOLOGIES = ("flat", "tree", "ring")
_FAULT_SITE = "merge.level"


@dataclass(frozen=True)
class MergePolicy:
    """Budgets for one hierarchical merge round.

    ``level_deadline`` is the per-level unit budget: a hop expecting a
    subtree of height ``h`` beneath the sender waits up to
    ``h * level_deadline``.  ``attempts`` retries within each hop's
    budget (the per-level ResilientGroup's ``max_attempts``).
    ``ack_deadline`` bounds the wait for a receipt acknowledgement
    before the sender declares its parent dead and re-parents;
    ``reparent_grace`` bounds how long an ancestor polls for orphans of
    an excised child; ``result_deadline`` bounds a non-root rank's wait
    for the root's result under ``recipient="all"`` (defaults scale
    from ``level_deadline``).  ``poll_slice`` is the orphan-poll /
    ring-scan granularity.

    A rank mid failure-recovery (orphan-polling for an excised child's
    subtree) sends **keepalives** up its live ancestor chain every
    :meth:`keepalive_interval`, and each ancestor extends its recv
    deadline on one — so a live node slowed by recovery beneath it is
    never excised by a parent whose own (linear) recv deadline is
    shorter than the (exponential) recovery window.  ``poll_window_max``
    is the absolute cap on any single orphan-poll window: the computed
    :meth:`poll_window` is exponential in the dead subtree's height, so
    without a cap a tall dead subtree whose survivors already delivered
    through the dead node (and so never re-parent) would be waited on
    for minutes; the poll also exits early once every pending orphan is
    accounted for or nothing has arrived for the no-progress bound (see
    :func:`_poll_orphans`).  ``None`` disables the cap."""

    level_deadline: float = 2.0
    attempts: int = 2
    ack_deadline: Optional[float] = None
    reparent_grace: Optional[float] = None
    result_deadline: Optional[float] = None
    poll_slice: float = 0.02
    poll_window_max: Optional[float] = 60.0

    def __post_init__(self) -> None:
        if self.level_deadline <= 0:
            raise ValueError(
                f"level_deadline must be positive, got {self.level_deadline}"
            )
        if self.attempts < 1:
            raise ValueError(f"attempts must be >= 1, got {self.attempts}")

    def ack(self) -> float:
        return (
            self.ack_deadline
            if self.ack_deadline is not None
            else self.level_deadline
        )

    def grace(self) -> float:
        return (
            self.reparent_grace
            if self.reparent_grace is not None
            else self.level_deadline
        )

    def result(self, levels: int) -> float:
        return (
            self.result_deadline
            if self.result_deadline is not None
            else self.level_deadline * (2 * levels + 2)
        )

    def ack_wait(self, target_height: int) -> float:
        """How long a sender waits for its (grand)parent's receipt.

        Two constraints pull in opposite directions: a *busy* target may
        legitimately spend its dead sibling subtree's full recv deadline
        plus the orphan-poll grace before acking (so the wait must grow
        with the target's subtree height), while a *dead* target must be
        detected before the next live ancestor's orphan-poll window
        closes.  Exponential scaling in the target height satisfies
        both: the sum of detection times over any chain of dead
        ancestors below height ``h`` stays under :meth:`poll_window`
        of ``h`` (geometric series)."""
        unit = self.ack() + self.grace()
        return 1.5 * unit * (2 ** max(0, target_height - 1))

    def poll_window(self, dead_child_height: int) -> float:
        """How long an ancestor polls re-parent tags after excising a
        child of the given subtree height: covers every descendant's
        worst-case chain of dead-ancestor detections
        (``sum ack_wait(i) for i <= h`` is under ``2 * unit * 2**h``).
        Call sites apply :meth:`capped_poll_window`."""
        unit = self.ack() + self.grace()
        return 2.0 * unit * (2 ** dead_child_height)

    def capped_poll_window(self, dead_child_height: int) -> float:
        window = self.poll_window(dead_child_height)
        if self.poll_window_max is not None:
            window = min(window, self.poll_window_max)
        return window

    def keepalive_interval(self) -> float:
        """Cadence of the mid-recovery progress signal; well under
        ``level_deadline`` so a parent's extended recv deadline never
        lapses between two keepalives from a live child."""
        return self.level_deadline / 4.0

    def recv_window(self, child_height: int) -> float:
        """Hard cap on a keepalive-extended child-envelope wait.  The
        base recv deadline stays ``level_deadline * child_height``
        (fast detection of a silent child); keepalives extend it while
        the child is visibly mid-recovery, up to this bound — the
        child's own recovery work is at most two excise-and-poll
        passes, so anything beyond is a wedged peer, excised as dead."""
        return (
            self.level_deadline * child_height
            + 4.0 * self.capped_poll_window(child_height)
            + 2.0 * (self.ack() + self.grace())
        )


@dataclass
class MergeOutcome:
    """What a fleet merge returns on every rank — never an exception.

    ``value`` is the computed metric value (on the recipient rank(s));
    ``metric`` is the reassembled merged metric (root, exact mode
    only).  ``partial`` is True when any initial rank's contribution is
    missing: ``world_effective = world_size - len(lost_ranks)``.
    ``delivered`` is False on a rank whose envelope never reached the
    root (partition) or that was fault-dropped (``dropped=True``)."""

    value: Any
    metric: Any
    world_size: int
    world_effective: int
    lost_ranks: Tuple[int, ...]
    partial: bool
    topology: str
    levels: int
    rank: int
    delivered: bool
    dropped: bool = False
    sketch: Optional[str] = None
    payload_bytes_at_root: int = 0
    overlap_skips: int = 0


@dataclass
class Envelope:
    """One hop's payload: merged state plus the membership piggyback.

    ``trace_id``/``span_id`` are the sender's causal-trace identity
    (empty when tracing is off — defaults keep the wire format
    compatible with untraced peers), riding the same piggyback channel
    as the dead-rank gossip: no extra round trips for cross-host trace
    assembly."""

    sender: int
    level: int
    contributors: FrozenSet[int]
    dead: FrozenSet[int]
    mode: str                                   # "exact" | "sketch"
    parts: Dict[int, Any] = field(default_factory=dict)
    part_bytes: Dict[int, int] = field(default_factory=dict)
    sketch: Optional[Any] = None
    trace_id: str = ""
    span_id: str = ""

    def payload_nbytes(self) -> int:
        if self.mode == "exact":
            return sum(self.part_bytes.values())
        return int(self.sketch.nbytes()) if self.sketch is not None else 0


class _Acc:
    """This rank's running reduction: per-rank parts (exact mode, keyed
    by rank so duplicate delivery dedups for free) or one commutative
    sketch (overlapping sketch envelopes are skipped and counted)."""

    def __init__(self, mode: str) -> None:
        self.mode = mode
        self.parts: Dict[int, Any] = {}
        self.part_bytes: Dict[int, int] = {}
        self.sketch: Optional[Any] = None
        self.contributors: Set[int] = set()
        self.overlap_skips = 0

    def add_local(
        self, rank: int, part: Any = None, nbytes: int = 0, sketch: Any = None
    ) -> None:
        if self.mode == "exact":
            self.parts[rank] = part
            self.part_bytes[rank] = nbytes
        else:
            self.sketch = sketch
        self.contributors.add(rank)

    def absorb(self, env: Envelope, view: MembershipView) -> bool:
        view.merge_gossip(env.dead, reason="gossip")
        view.observe(env.sender, level=env.level)
        if self.mode == "exact":
            for r, part in env.parts.items():
                if r not in self.parts:
                    self.parts[r] = part
                    self.part_bytes[r] = env.part_bytes.get(r, 0)
                    self.contributors.add(r)
            return True
        incoming = set(env.contributors)
        if incoming & self.contributors:
            # A duplicate or partially-overlapping sketch cannot be
            # subtracted; skip the whole envelope (its non-overlapping
            # contributors show up as lost, which partial accounting
            # surfaces honestly).
            if not incoming <= self.contributors:
                self.overlap_skips += 1
            return False
        if self.sketch is None:
            self.sketch = env.sketch
        else:
            self.sketch.merge(env.sketch)
        self.contributors |= incoming
        return True

    def to_envelope(
        self, sender: int, level: int, view: MembershipView
    ) -> Envelope:
        env = Envelope(
            sender=sender,
            level=level,
            contributors=frozenset(self.contributors),
            dead=frozenset(view.dead),
            mode=self.mode,
            parts=dict(self.parts),
            part_bytes=dict(self.part_bytes),
            sketch=self.sketch,
        )
        if _trace.ENABLED:
            ctx = _trace.current()
            if ctx is not None:
                env.trace_id = ctx.trace_id
                env.span_id = ctx.span_id
        return env


# ------------------------------------------------------------ tree shape
def _heights(world: int) -> List[int]:
    """Height of the heap subtree rooted at each position (leaf = 1);
    a node *sends up* at level == its height, so the root's height is
    the level count of the whole merge."""
    h = [1] * world
    for pos in range(world - 1, -1, -1):
        left, right = 2 * pos + 1, 2 * pos + 2
        if left < world:
            h[pos] = 1 + max(
                h[left], h[right] if right < world else 0
            )
    return h


def _subtree(pos: int, world: int) -> List[int]:
    out, frontier = [], [pos]
    while frontier:
        p = frontier.pop()
        out.append(p)
        for c in (2 * p + 1, 2 * p + 2):
            if c < world:
                frontier.append(c)
    return sorted(out)


def _next_round(group: CollectiveGroup) -> int:
    """Per-group monotonically increasing round id, attached to the
    innermost transport so repeated merges over re-wrapped groups keep
    distinct wire tags.  All ranks must call merges in the same order
    (the standing collective-ordering requirement)."""
    inner = group
    while hasattr(inner, "inner"):
        inner = inner.inner
    n = int(getattr(inner, "_fleet_merge_round", 0))
    try:
        inner._fleet_merge_round = n + 1
    except (AttributeError, TypeError):  # pragma: no cover - frozen group
        pass
    return n


def _fire(
    role: str, rank: int, level: int, round_id: int, topology: str
) -> None:
    if _faults.ENABLED:
        _faults.fire(
            _FAULT_SITE,
            rank=rank,
            level=level,
            round=round_id,
            topology=topology,
            role=role,
        )


def _level_group(
    group: CollectiveGroup,
    view: MembershipView,
    deadline: float,
    attempts: int,
) -> ResilientGroup:
    policy = RetryPolicy(
        max_attempts=attempts,
        base_delay=0.005,
        max_delay=0.05,
        jitter=0.0,
        deadline=deadline,
    )
    return ResilientGroup(group, policy, membership=view)


def _recv_hop(
    group: CollectiveGroup,
    view: MembershipView,
    src: int,
    tag: str,
    deadline: float,
    attempts: int,
) -> Envelope:
    rg = _level_group(group, view, deadline, attempts)
    per_attempt = max(0.001, deadline / attempts)
    return rg.recv_object(src, tag, timeout=per_attempt)


def _send_hop(
    group: CollectiveGroup,
    view: MembershipView,
    obj: Any,
    dst: int,
    tag: str,
    deadline: float,
    attempts: int,
) -> None:
    rg = _level_group(group, view, deadline, attempts)
    rg.send_object(obj, dst, tag)


def _record_level(
    seconds: float, payload_bytes: int, level: int, fanout: int
) -> None:
    if _telemetry.ENABLED:
        _telemetry.record_sync(
            "fleet_merge", seconds, payload_bytes, level=level, fanout=fanout
        )


def _ack_payload(me: int, view: MembershipView) -> tuple:
    """The wire ack: ``("ack", rank, dead-gossip[, span_id])`` — the
    4th element is this rank's merge span id, the downlink that lets the
    acked child reparent its merge span under the parent's before it
    emits its own level record (the one field cross-host trace assembly
    needs).  Omitted when tracing is off: 3-tuples stay on the wire, so
    traced and untraced builds interoperate."""
    base = ("ack", me, tuple(view.dead))
    if _trace.ENABLED:
        ctx = _trace.current()
        if ctx is not None:
            return base + (ctx.span_id,)
    return base


def _adopt_ack_parent(ack: Any) -> None:
    """Fold the parent span id an ack carried into this rank's active
    merge span (same span id, newly-learned parent).  Call before the
    level record is emitted so the event carries the link."""
    if not _trace.ENABLED:
        return
    if isinstance(ack, tuple) and len(ack) >= 4 and ack[3]:
        ctx = _trace.current()
        if ctx is not None:
            _trace.adopt(_trace.reparent(ctx, ack[3]))


# --------------------------------------------------------- tree protocol
def _tree_round(
    group: CollectiveGroup,
    view: MembershipView,
    acc: _Acc,
    dst: int,
    policy: MergePolicy,
    rid: str,
    round_id: int,
) -> bool:
    """Run this rank's part of one tree reduction.  Returns ``delivered``
    (True on the root, or once an ancestor acked this rank's envelope)."""
    me, world = group.rank, group.world_size
    my_pos = (me - dst) % world
    heights = _heights(world)
    rank_of = lambda pos: (dst + pos) % world  # noqa: E731

    parent_pos = (my_pos - 1) // 2
    ka_last = [float("-inf")]

    def keepalive() -> None:
        """Mid-recovery progress signal: tell the (static) parent this
        rank is alive so its recv deadline extends instead of falsely
        excising a whole live subtree; each ancestor relays it upward,
        so nested recovery anywhere beneath keeps the chain open."""
        if my_pos == 0:
            return
        now = time.monotonic()
        if now - ka_last[0] < policy.keepalive_interval():
            return
        ka_last[0] = now
        try:
            group.send_object(
                ("ka", me), rank_of(parent_pos), f"{rid}/ka/{my_pos}"
            )
        except Exception:  # noqa: BLE001 - keepalive is best-effort
            pass

    # 1. Receive (and ack) each child subtree's merged envelope.  The
    # wait is a raw-transport poll (like _poll_orphans) rather than one
    # ResilientGroup recv: the deadline must be extendable mid-wait by
    # the child's keepalives, which a fixed-budget recv cannot do.
    for child_pos in (2 * my_pos + 1, 2 * my_pos + 2):
        if child_pos >= world:
            continue
        child_rank = rank_of(child_pos)
        level = heights[child_pos]
        _fire("recv", me, level, round_id, "tree")
        hop_deadline = policy.level_deadline * level
        started = time.monotonic()
        hard_cap = started + policy.recv_window(level)
        deadline = started + hop_deadline
        env: Optional[Envelope] = None
        while True:
            try:
                env = group.recv_object(
                    child_rank,
                    f"{rid}/up/{child_pos}",
                    timeout=policy.poll_slice,
                )
                break
            except (PeerTimeoutError, CollectiveTimeoutError):
                pass
            try:
                group.recv_object(
                    child_rank, f"{rid}/ka/{child_pos}", timeout=0.0
                )
            except (PeerTimeoutError, CollectiveTimeoutError):
                pass
            else:
                deadline = time.monotonic() + hop_deadline
                keepalive()  # relay the liveness up the chain
            if time.monotonic() >= min(deadline, hard_cap):
                break
        if env is not None:
            try:
                acc.absorb(env, view)
                _send_hop(
                    group,
                    view,
                    _ack_payload(me, view),
                    child_rank,
                    f"{rid}/ack/{child_pos}",
                    policy.ack(),
                    policy.attempts,
                )
                _record_level(
                    time.monotonic() - started,
                    env.payload_nbytes(),
                    level,
                    2,
                )
                continue
            except (CollectiveTimeoutError, PeerTimeoutError) as exc:
                reason = f"no ack delivery at level {level}: {exc}"
        else:
            reason = f"no envelope at level {level} within deadline"
        view.excise(child_rank, reason=reason)
        _record_level(time.monotonic() - started, 0, level, 2)
        _poll_orphans(
            group, view, acc, child_pos, dst, policy, rid, heights,
            keepalive=keepalive,
        )

    if my_pos == 0:
        return True

    # 2. Send the merged envelope up, climbing past dead ancestors.
    level = heights[my_pos]
    _fire("send", me, level, round_id, "tree")
    env = acc.to_envelope(me, level, view)
    target_pos = (my_pos - 1) // 2
    tag_kind = "up"
    while True:
        target_rank = rank_of(target_pos)
        if view.is_alive(target_rank):
            started = time.monotonic()
            try:
                _send_hop(
                    group,
                    view,
                    env,
                    target_rank,
                    f"{rid}/{tag_kind}/{my_pos}",
                    policy.ack(),
                    policy.attempts,
                )
                ack = _recv_hop(
                    group,
                    view,
                    target_rank,
                    f"{rid}/ack/{my_pos}",
                    policy.ack_wait(heights[target_pos]),
                    policy.attempts,
                )
                view.observe(target_rank, level=level)
                if isinstance(ack, tuple) and len(ack) >= 3:
                    view.merge_gossip(ack[2], reason="ack gossip")
                _adopt_ack_parent(ack)
                _record_level(
                    time.monotonic() - started, env.payload_nbytes(), level, 2
                )
                return True
            except (CollectiveTimeoutError, PeerTimeoutError) as exc:
                view.excise(
                    target_rank,
                    reason=f"no ack at level {level}: {exc}",
                )
                _record_level(time.monotonic() - started, 0, level, 2)
        if target_pos == 0:
            return False  # every ancestor incl. the root is dead
        target_pos = (target_pos - 1) // 2
        tag_kind = "rp"


def _poll_orphans(
    group: CollectiveGroup,
    view: MembershipView,
    acc: _Acc,
    dead_child_pos: int,
    dst: int,
    policy: MergePolicy,
    rid: str,
    heights: List[int],
    keepalive: Optional[Any] = None,
) -> None:
    """After excising a child, poll for its subtree during the grace
    window, acking and absorbing whatever climbs up.

    The excised position itself stays in the poll (on its original
    ``up`` tag, plus ``rp``): a slow-but-alive child whose envelope
    missed the recv deadline is absorbed late instead of its whole
    subtree being lost — it re-sends only toward its *grandparent*,
    which never polls ``rp`` tags for positions it did not excise.

    The window is bounded three ways.  Hard cap:
    ``capped_poll_window`` (the exponential bound, clamped at
    ``poll_window_max``).  No-progress bound: a surviving orphan's
    worst-case chain of dead-ancestor detections sums geometrically
    below ``2 * ack_wait(tallest pending)``, so silence that long
    (plus grace) means nothing can still arrive — and the bound shrinks
    as orphans resolve.  Corroboration: once the dead child's own
    children re-parented around it, only its own late envelope could
    still arrive, and its children's matching excision says it will
    not."""
    world = group.world_size
    me = group.rank
    rank_of = lambda pos: (dst + pos) % world  # noqa: E731
    pending = set(_subtree(dead_child_pos, world))
    started = time.monotonic()
    hard_deadline = started + policy.capped_poll_window(
        heights[dead_child_pos]
    )

    def quiet_budget() -> float:
        tallest = max(heights[p] for p in pending)
        return 2.0 * policy.ack_wait(tallest) + policy.grace()

    quiet_deadline = started + quiet_budget()
    reparented = False
    while pending:
        now = time.monotonic()
        if now >= hard_deadline or now >= quiet_deadline:
            break
        if reparented and pending == {dead_child_pos}:
            break
        if keepalive is not None:
            keepalive()
        progressed = False
        for pos in sorted(pending):
            orphan_rank = rank_of(pos)
            dead_by_gossip = (
                pos != dead_child_pos and not view.is_alive(orphan_rank)
            )
            if dead_by_gossip or orphan_rank in acc.contributors:
                pending.discard(pos)
                progressed = True
                continue
            tags = [f"{rid}/rp/{pos}"]
            if pos == dead_child_pos:
                tags.insert(0, f"{rid}/up/{pos}")
            env: Optional[Envelope] = None
            for tag in tags:
                try:
                    env = group.recv_object(
                        orphan_rank, tag, timeout=policy.poll_slice
                    )
                    break
                except (PeerTimeoutError, CollectiveTimeoutError):
                    continue
            if env is None:
                if pos == dead_child_pos:
                    # A keepalive from the excised child: still alive,
                    # mid-recovery — keep its window open.
                    try:
                        group.recv_object(
                            orphan_rank, f"{rid}/ka/{pos}", timeout=0.0
                        )
                    except (PeerTimeoutError, CollectiveTimeoutError):
                        pass
                    else:
                        progressed = True
                continue
            acc.absorb(env, view)
            try:
                group.send_object(
                    _ack_payload(me, view),
                    orphan_rank,
                    f"{rid}/ack/{pos}",
                )
            except Exception:  # noqa: BLE001 - ack is best-effort
                pass
            if pos != dead_child_pos:
                reparented = True
            # The orphan's envelope covers its whole live subtree.
            for covered in _subtree(pos, world):
                pending.discard(covered)
            progressed = True
        if progressed and pending:
            quiet_deadline = time.monotonic() + quiet_budget()


# --------------------------------------------------------- ring protocol
def _ring_round(
    group: CollectiveGroup,
    view: MembershipView,
    acc: _Acc,
    dst: int,
    policy: MergePolicy,
    rid: str,
    round_id: int,
) -> bool:
    """Chain reduction from position ``world-1`` down to the head at
    ``dst``.  A sender that gets no ack skips to the next live
    downstream position; a receiver polls every upstream candidate
    (the envelope may arrive from any of them after skips)."""
    me, world = group.rank, group.world_size
    my_pos = (me - dst) % world
    rank_of = lambda pos: (dst + pos) % world  # noqa: E731

    if my_pos != world - 1:
        level = world - 1 - my_pos
        _fire("recv", me, level, round_id, "ring")
        budget = policy.level_deadline * level
        started = time.monotonic()
        deadline = started + budget
        candidates = list(range(my_pos + 1, world))
        env: Optional[Envelope] = None
        while env is None and time.monotonic() < deadline:
            for src_pos in candidates:
                src_rank = rank_of(src_pos)
                if not view.is_alive(src_rank):
                    continue
                try:
                    env = group.recv_object(
                        src_rank,
                        f"{rid}/ring/{my_pos}",
                        timeout=policy.poll_slice,
                    )
                except (PeerTimeoutError, CollectiveTimeoutError):
                    continue
                acc.absorb(env, view)
                try:
                    group.send_object(
                        _ack_payload(me, view),
                        src_rank,
                        f"{rid}/ring-ack/{src_pos}",
                    )
                except Exception:  # noqa: BLE001 - ack is best-effort
                    pass
                break
        _record_level(
            time.monotonic() - started,
            env.payload_nbytes() if env is not None else 0,
            level,
            1,
        )
        # No envelope inside the budget: the upstream chain is gone (or
        # partitioned); this rank restarts the chain from its own
        # contribution and the head's contributor set tells the truth.

    if my_pos == 0:
        return True

    level = world - my_pos
    _fire("send", me, level, round_id, "ring")
    env_out = acc.to_envelope(me, level, view)
    target_pos = my_pos - 1
    while target_pos >= 0:
        target_rank = rank_of(target_pos)
        if view.is_alive(target_rank):
            started = time.monotonic()
            try:
                _send_hop(
                    group,
                    view,
                    env_out,
                    target_rank,
                    f"{rid}/ring/{target_pos}",
                    policy.ack(),
                    policy.attempts,
                )
                ack = _recv_hop(
                    group,
                    view,
                    target_rank,
                    f"{rid}/ring-ack/{my_pos}",
                    # The downstream receiver is a round-robin poller;
                    # its ack lands within one sweep of its candidates.
                    policy.ack() + policy.poll_slice * world,
                    policy.attempts,
                )
                view.observe(target_rank, level=level)
                _adopt_ack_parent(ack)
                _record_level(
                    time.monotonic() - started,
                    env_out.payload_nbytes(),
                    level,
                    1,
                )
                return True
            except (CollectiveTimeoutError, PeerTimeoutError) as exc:
                view.excise(
                    target_rank,
                    reason=f"no ring ack at level {level}: {exc}",
                )
                _record_level(time.monotonic() - started, 0, level, 1)
        target_pos -= 1
    return False


# ------------------------------------------------------------ entry point
def fleet_merge(
    metric: Any,
    group: CollectiveGroup,
    *,
    topology: str = "tree",
    sketch: Optional[str] = None,
    sketch_options: Optional[Dict[str, Any]] = None,
    dst: int = 0,
    recipient: Any = None,
    policy: Optional[MergePolicy] = None,
    membership: Optional[MembershipView] = None,
    round_id: Optional[int] = None,
    compute: bool = True,
) -> MergeOutcome:
    """Hierarchically merge ``metric``'s state across ``group``.

    Returns a :class:`MergeOutcome` on **every** rank and never raises
    past the root: peer failures become excisions and a partial result.
    ``recipient`` defaults to ``dst`` (only the root computes the
    value); ``recipient="all"`` has the root distribute the computed
    value point-to-point to every live rank (a rank that misses the
    result inside its deadline degrades to a local-only partial outcome
    with a ``degraded`` telemetry event, because a barrier broadcast
    would hang on the very host losses this merge survives).

    ``sketch=None`` ships whole prepared per-rank states (lossless,
    rank-order reassembly at the root → bit-identical to the flat
    path); a sketch kind ships O(bins) summaries — see
    :meth:`BinaryAUROC.sketch_state` for kinds, options, and bounds.
    """
    if topology not in ("tree", "ring"):
        raise ValueError(
            f"topology must be 'tree' or 'ring', got {topology!r}"
        )
    if sketch == "exact":
        sketch = None  # exact rides the rank-keyed parts map
    policy = policy if policy is not None else MergePolicy()
    me, world = group.rank, group.world_size
    recipient = dst if recipient is None else recipient
    levels = (
        _heights(world)[0] if topology == "tree" else max(1, world - 1)
    ) if world >= 1 else 0

    if world <= 1:
        value = metric.compute() if compute else None
        return MergeOutcome(
            value=value,
            metric=metric,
            world_size=max(world, 1),
            world_effective=max(world, 1),
            lost_ranks=(),
            partial=False,
            topology=topology,
            levels=0,
            rank=max(me, 0),
            delivered=True,
            sketch=sketch,
        )
    if not group.supports_p2p:
        raise ValueError(
            f"{type(group).__name__} has no point-to-point transport; "
            "use topology='flat' (toolkit.sync_and_compute) instead"
        )

    view = resolve_membership(membership, world, me)
    rnd = _next_round(group) if round_id is None else int(round_id)
    rid = f"fm{rnd}"

    acc = _Acc("exact" if sketch is None else "sketch")
    if sketch is None:
        metric._prepare_for_merge_state()
        acc.add_local(me, part=metric, nbytes=state_nbytes(metric))
    else:
        opts = dict(sketch_options or {})
        if sketch == "reservoir":
            opts.setdefault("salt", me)
        acc.add_local(me, sketch=metric.sketch_state(sketch, **opts))

    delivered = True
    round_fn = _tree_round if topology == "tree" else _ring_round
    merge_ctx = None
    if _trace.ENABLED:
        # Every rank of one round derives the SAME trace id from the
        # shared round id — cross-host trace identity with zero extra
        # round trips.  The initial parent link points at whatever
        # scheduled this rank's merge (the engine block span, via
        # PendingMerge's handoff); acks later reparent non-root merge
        # spans under their tree parent's span, and the root keeps the
        # local link — bridging the whole cross-host tree into the
        # root's engine trace.
        local = _trace.current()
        merge_ctx = _trace.derive(
            f"merge-{rid}",
            parent_span_id=local.span_id if local is not None else "",
        )
    try:
        _fire("start", me, 0, rnd, topology)
        if _trace.ENABLED and merge_ctx is not None:
            with _trace.activate(merge_ctx):
                delivered = round_fn(group, view, acc, dst, policy, rid, rnd)
        else:
            delivered = round_fn(group, view, acc, dst, policy, rid, rnd)
    except DroppedRank:
        # This rank "vanished": no sends, no acks, no result — its
        # peers excise it and carry on.  Locally we still return a
        # well-formed (undelivered) outcome so a caller thread joins.
        return MergeOutcome(
            value=None,
            metric=None,
            world_size=world,
            world_effective=view.world_effective,
            lost_ranks=tuple(sorted(view.dead)),
            partial=True,
            topology=topology,
            levels=levels,
            rank=me,
            delivered=False,
            dropped=True,
            sketch=sketch,
        )

    my_pos = (me - dst) % world
    if my_pos == 0:
        outcome = _root_outcome(
            acc, view, world, me, topology, levels, sketch, compute
        )
        if recipient == "all":
            # The value travels through the CPU (send_object pickles its
            # tensors there), as the JAX package's travels as numpy.
            wire = (
                outcome.value,
                outcome.lost_ranks,
                outcome.payload_bytes_at_root,
                outcome.overlap_skips,
            )
            # Send to every initial rank, not just the ones this view
            # thinks are alive: a live rank the root wrongly excised
            # (its envelope arrived late or via an orphan poll) still
            # deserves the result, sends are non-blocking, and an
            # unclaimed message to a truly dead rank is tolerated.
            for peer in range(world):
                if peer == me:
                    continue
                try:
                    group.send_object(wire, peer, f"{rid}/res/{peer}")
                except Exception:  # noqa: BLE001 - peer may have died
                    pass
        return outcome

    if recipient == "all":
        try:
            value, lost, root_bytes, skips = group.recv_object(
                (dst) % world, f"{rid}/res/{me}", timeout=policy.result(levels)
            )
            lost = tuple(lost)
            return MergeOutcome(
                value=value,
                metric=None,
                world_size=world,
                world_effective=world - len(lost),
                lost_ranks=lost,
                partial=bool(lost),
                topology=topology,
                levels=levels,
                rank=me,
                delivered=delivered,
                sketch=sketch,
                payload_bytes_at_root=root_bytes,
                overlap_skips=skips,
            )
        except (PeerTimeoutError, CollectiveTimeoutError) as exc:
            if _telemetry.ENABLED:
                _telemetry.record_degraded(
                    "fleet_merge",
                    f"no result from root: {exc}",
                    "local",
                    survivors=view.survivors_label(),
                )
            # All this rank knows is that the root's result did not
            # arrive: report the root (plus already-known deaths) as
            # lost, not every peer — the rest of the fleet may be fine.
            local_value = metric.compute() if compute else None
            lost = tuple(sorted(view.dead | {dst % world}))
            return MergeOutcome(
                value=local_value,
                metric=None,
                world_size=world,
                world_effective=world - len(lost),
                lost_ranks=lost,
                partial=True,
                topology=topology,
                levels=levels,
                rank=me,
                delivered=delivered,
                sketch=sketch,
            )

    lost = tuple(sorted(view.dead))
    return MergeOutcome(
        value=None,
        metric=None,
        world_size=world,
        world_effective=view.world_effective,
        lost_ranks=lost,
        partial=bool(lost) or not delivered,
        topology=topology,
        levels=levels,
        rank=me,
        delivered=delivered,
        sketch=sketch,
    )


def _root_outcome(
    acc: _Acc,
    view: MembershipView,
    world: int,
    rank: int,
    topology: str,
    levels: int,
    sketch: Optional[str],
    compute: bool,
) -> MergeOutcome:
    contributors = sorted(acc.contributors)
    lost = tuple(sorted(set(range(world)) - acc.contributors))
    metric = None
    value = None
    if acc.mode == "exact":
        metric = _assemble_exact(acc.parts)
        if compute and metric is not None:
            value = metric.compute()
        root_bytes = sum(acc.part_bytes.values())
    else:
        if compute and acc.sketch is not None:
            value = acc.sketch.compute()
        root_bytes = int(acc.sketch.nbytes()) if acc.sketch else 0
    return MergeOutcome(
        value=value,
        metric=metric,
        world_size=world,
        world_effective=len(contributors),
        lost_ranks=lost,
        partial=len(contributors) < world,
        topology=topology,
        levels=levels,
        rank=rank,
        delivered=True,
        sketch=sketch,
        payload_bytes_at_root=root_bytes,
        overlap_skips=acc.overlap_skips,
    )


def _assemble_exact(parts: Dict[int, Any]) -> Any:
    """Reassemble per-rank prepared states in rank order — the exact
    sequence the flat path's ``clone(g[0]).merge_state(g[1:])`` uses,
    so a clean tree/ring merge is bit-identical to the flat gather."""
    if not parts:
        return None
    ranks = sorted(parts)
    base = copy.deepcopy(parts[ranks[0]])
    rest = [parts[r] for r in ranks[1:]]
    if rest:
        base.merge_state(rest)
    return base


class PendingMerge:
    """Handle for a fleet merge overlapped with further eval work
    (``Evaluator.start_fleet_merge``): the merge runs on a daemon
    thread over a state snapshot; :meth:`result` joins and returns the
    :class:`MergeOutcome` (or re-raises the thread's error — which the
    merge itself never produces for *peer* failures, only for
    programming errors)."""

    def __init__(self, target: Any, args: tuple, kwargs: dict) -> None:
        self._outcome: Optional[MergeOutcome] = None
        self._error: Optional[BaseException] = None
        # Explicit thread handoff of the caller's trace context
        # (start_fleet_merge activates the scheduling engine-block span
        # around this constructor) so the merge's spans parent on the
        # block that scheduled them.
        self._trace_ctx = _trace.capture() if _trace.ENABLED else None

        def run() -> None:
            if _trace.ENABLED:
                _trace.adopt(self._trace_ctx)
            try:
                self._outcome = target(*args, **kwargs)
            except BaseException as exc:  # noqa: BLE001 - relayed in result()
                self._error = exc

        self._thread = threading.Thread(
            target=run, name="fleet-merge", daemon=True
        )
        self._thread.start()

    def done(self) -> bool:
        return not self._thread.is_alive()

    def result(self, timeout: Optional[float] = None) -> MergeOutcome:
        self._thread.join(timeout)
        if self._thread.is_alive():
            raise TimeoutError("fleet merge still running")
        if self._error is not None:
            raise self._error
        assert self._outcome is not None
        return self._outcome
