"""Admission control: bounded queues, typed outcomes, load shedding (the
port of ``torcheval_tpu/serve/admission.py``, line for line: pure Python).

Overload must degrade throughput, never kill the process.  Every
``submit()`` passes through an :class:`AdmissionController` that holds
ONE bounded global queue with per-tenant occupancy counts; when a burst
fills it, the configured policy decides who pays:

``reject-newest`` (default)
    The arriving batch is shed.  Cheapest and fairest under uniform
    load — nobody's already-queued work is discarded.
``drop-oldest``
    The oldest queued batch is shed to admit the arrival.  Prefers
    freshness: right when results are only useful within a deadline.
``fair``
    Per-tenant quota ``max(1, global_capacity // queued_tenants)`` on
    top of the global bound — a slow-consumer tenant saturates its own
    quota and sheds only its own batches while light tenants keep
    admitting.

Outcomes are typed (:class:`Admitted` / :class:`Shed` /
:class:`Rejected`) rather than exceptional: overload is an expected
operating mode and callers branch on the type.  ``Shed`` means queue
pressure (retryable later); ``Rejected`` means the tenant cannot submit
at all (unknown, quarantined, draining).

Deadlines are enforced lazily at pop time: an item whose
``enqueued_at + deadline_s`` has passed is shed with reason
``"deadline"`` instead of dispatched — work the caller has already
given up on is never executed.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional, Tuple

POLICIES = ("reject-newest", "drop-oldest", "fair")

DEFAULT_GLOBAL_CAPACITY = 256
DEFAULT_PER_TENANT_CAPACITY = 64


@dataclass(frozen=True)
class Admitted:
    """The batch is queued; ``ticket`` orders it globally."""

    tenant: str
    ticket: int
    queue_depth: int


@dataclass(frozen=True)
class Shed:
    """Queue pressure discarded a batch (the submitted one, or —
    under ``drop-oldest`` — someone's older one to admit this one).
    Retryable once the queue drains."""

    tenant: str
    reason: str  # "global-queue-full" | "tenant-queue-full" | "fair-quota"
    policy: str
    queue_depth: int


@dataclass(frozen=True)
class Rejected:
    """The tenant cannot submit at all right now."""

    tenant: str
    reason: str  # "unknown-tenant" | "quarantined" | "draining" | "closed"


@dataclass
class QueueItem:
    """One queued batch with its admission metadata."""

    ticket: int
    tenant: str
    args: Tuple[Any, ...]
    kwargs: Dict[str, Any]
    enqueued_at: float
    deadline_s: Optional[float]
    trace_ctx: Any = None

    def expired(self, now: float) -> bool:
        return (
            self.deadline_s is not None
            and now - self.enqueued_at > self.deadline_s
        )


@dataclass
class _State:
    queue: Deque[QueueItem] = field(default_factory=deque)
    per_tenant: Dict[str, int] = field(default_factory=dict)


class AdmissionController:
    """Bounded admission with a pluggable shed policy.  Thread-safe;
    every method takes the internal lock, and none calls out under it.
    """

    def __init__(
        self,
        *,
        global_capacity: int = DEFAULT_GLOBAL_CAPACITY,
        per_tenant_capacity: int = DEFAULT_PER_TENANT_CAPACITY,
        policy: str = "reject-newest",
        deadline_s: Optional[float] = None,
    ) -> None:
        if policy not in POLICIES:
            raise ValueError(
                f"policy must be one of {POLICIES}, got {policy!r}"
            )
        if global_capacity < 1:
            raise ValueError(
                f"global_capacity must be >= 1, got {global_capacity}"
            )
        if per_tenant_capacity < 1:
            raise ValueError(
                f"per_tenant_capacity must be >= 1, got {per_tenant_capacity}"
            )
        self.policy = policy
        self.global_capacity = int(global_capacity)
        self.per_tenant_capacity = int(per_tenant_capacity)
        self.deadline_s = deadline_s
        self._lock = threading.Lock()
        self._state = _State()
        self._ticket = 0

    # -- introspection ----------------------------------------------------
    def depth(self, tenant: Optional[str] = None) -> int:
        with self._lock:
            if tenant is None:
                return len(self._state.queue)
            return self._state.per_tenant.get(tenant, 0)

    # -- admission --------------------------------------------------------
    def offer(
        self,
        tenant: str,
        args: Tuple[Any, ...],
        kwargs: Dict[str, Any],
        *,
        now: float,
        deadline_s: Optional[float] = None,
        trace_ctx: Any = None,
    ) -> Tuple[Any, List[QueueItem]]:
        """Try to enqueue one batch.  Returns ``(outcome, dropped)``:
        ``dropped`` is the list of OTHER items the drop-oldest policy
        evicted to make room (shed on the caller's event bus)."""
        if deadline_s is None:
            deadline_s = self.deadline_s
        dropped: List[QueueItem] = []
        with self._lock:
            state = self._state
            queued = state.per_tenant.get(tenant, 0)
            if queued >= self.per_tenant_capacity:
                return (
                    Shed(
                        tenant=tenant,
                        reason="tenant-queue-full",
                        policy=self.policy,
                        queue_depth=len(state.queue),
                    ),
                    dropped,
                )
            if self.policy == "fair":
                tenants = len(state.per_tenant) + (0 if queued else 1)
                quota = max(1, self.global_capacity // max(1, tenants))
                if queued >= quota:
                    return (
                        Shed(
                            tenant=tenant,
                            reason="fair-quota",
                            policy=self.policy,
                            queue_depth=len(state.queue),
                        ),
                        dropped,
                    )
            if len(state.queue) >= self.global_capacity:
                if self.policy != "drop-oldest":
                    return (
                        Shed(
                            tenant=tenant,
                            reason="global-queue-full",
                            policy=self.policy,
                            queue_depth=len(state.queue),
                        ),
                        dropped,
                    )
                victim = state.queue.popleft()
                self._decrement(victim.tenant)
                dropped.append(victim)
            self._ticket += 1
            item = QueueItem(
                ticket=self._ticket,
                tenant=tenant,
                args=tuple(args),
                kwargs=dict(kwargs),
                enqueued_at=now,
                deadline_s=deadline_s,
                trace_ctx=trace_ctx,
            )
            state.queue.append(item)
            state.per_tenant[tenant] = queued + 1
            return (
                Admitted(
                    tenant=tenant,
                    ticket=item.ticket,
                    queue_depth=len(state.queue),
                ),
                dropped,
            )

    def pop(
        self, *, now: float
    ) -> Tuple[Optional[QueueItem], List[QueueItem]]:
        """Next dispatchable item (None when the queue is empty) plus
        the deadline-expired items skipped to reach it."""
        expired: List[QueueItem] = []
        with self._lock:
            state = self._state
            while state.queue:
                item = state.queue.popleft()
                self._decrement(item.tenant)
                if item.expired(now):
                    expired.append(item)
                    continue
                return item, expired
        return None, expired

    def purge(self, tenant: str) -> List[QueueItem]:
        """Drop every queued item of ``tenant`` (quarantine path)."""
        with self._lock:
            state = self._state
            kept, purged = deque(), []
            for item in state.queue:
                (purged if item.tenant == tenant else kept).append(item)
            state.queue = kept
            state.per_tenant.pop(tenant, None)
            return purged

    def _decrement(self, tenant: str) -> None:
        # Caller holds the lock.
        left = self._state.per_tenant.get(tenant, 0) - 1
        if left > 0:
            self._state.per_tenant[tenant] = left
        else:
            self._state.per_tenant.pop(tenant, None)
