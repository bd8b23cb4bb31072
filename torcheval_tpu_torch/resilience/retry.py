"""Retry/timeout/backoff for object collectives (the port of
``torcheval_tpu/resilience/retry.py``).

A collective fails two ways in a real fleet: a transient error (a
coordinator hiccup, a preempted peer rejoining) that a retry absorbs, and
a genuine hang (a peer that is never coming back) that must be cut at a
deadline rather than stalling the whole eval.  :class:`RetryPolicy` names
both budgets; :class:`ResilientGroup` applies them to any
:class:`~torcheval_tpu_torch.distributed.CollectiveGroup` by
composition::

    group = ResilientGroup(world.group(rank), RetryPolicy(max_attempts=3))
    sync_and_compute(metric, group)

The port's tensor collectives (``all_reduce`` / ``all_reduce_many``) run
through ``all_gather_object``, so wrapping the object collectives covers
them too.  Each failed attempt emits a ``retry`` telemetry event (when the
bus is on); exhausted retries raise :class:`CollectiveTimeoutError`, or,
with ``degrade="local"``, fall back to the local single-host view with a
``degraded`` event and a warning, so the fallback is never silent.

Attempts armed with a ``deadline`` run on a daemon thread and are
abandoned at the cutoff: a stuck collective (a ``LocalWorld`` rank whose
peer never joins has no barrier abort) can leak its thread, but the caller
*returns*; the eval never hangs past the deadline.  Backoff jitter draws
from a ``random.Random(policy.seed)`` stream, so chaos tests replay
exactly.
"""

from __future__ import annotations

import random
import threading
import time
import warnings
from dataclasses import dataclass
from typing import Any, Callable, List, Optional

from torcheval_tpu_torch.distributed import CollectiveGroup
from torcheval_tpu_torch.resilience import faults as _faults
from torcheval_tpu_torch.telemetry import events as _telemetry
from torcheval_tpu_torch.telemetry import trace as _trace


class CollectiveTimeoutError(RuntimeError):
    """A collective exhausted its retry budget or overran its deadline.

    Carries the operation name, the attempts spent, the deadline (when
    one was armed), and — when the underlying error identified it — the
    slowest/unresponsive peer rank."""

    def __init__(
        self,
        op: str,
        attempts: int,
        deadline: Optional[float] = None,
        peer: Optional[int] = None,
    ) -> None:
        self.op = op
        self.attempts = attempts
        self.deadline = deadline
        self.peer = peer
        msg = f"collective {op!r} failed after {attempts} attempt(s)"
        if deadline is not None:
            msg += f" (deadline {deadline:g}s)"
        if peer is not None:
            msg += f"; slowest peer: rank {peer}"
        super().__init__(msg)


@dataclass(frozen=True)
class RetryPolicy:
    """Budgets for one retried operation.

    ``max_attempts`` total tries; exponential backoff between them from
    ``base_delay`` doubling up to ``max_delay``, stretched by up to
    ``jitter`` fraction (seeded — deterministic per wrapper instance);
    ``deadline`` is the *total* wall-clock budget in seconds across all
    attempts and sleeps (None = no deadline: rely on the backend's own
    budget)."""

    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    jitter: float = 0.1
    deadline: Optional[float] = None
    seed: int = 0

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}"
            )
        if self.deadline is not None and self.deadline <= 0:
            raise ValueError(
                f"deadline must be positive seconds, got {self.deadline}"
            )

    def backoff(self, attempt: int, rng: random.Random) -> float:
        """Sleep before attempt ``attempt + 1`` (``attempt`` is the
        1-based attempt that just failed)."""
        delay = min(self.base_delay * (2.0 ** (attempt - 1)), self.max_delay)
        if self.jitter:
            delay *= 1.0 + self.jitter * rng.random()
        return delay


class _Exhausted(Exception):
    """Internal: retries exhausted; carries the peer when known."""

    def __init__(self, peer: Optional[int] = None) -> None:
        self.peer = peer
        super().__init__()


def run_with_retry(
    op: str,
    fn: Callable[[], Any],
    policy: RetryPolicy,
    *,
    rng: Optional[random.Random] = None,
    fault_site: Optional[str] = None,
) -> Any:
    """Run ``fn()`` under ``policy``.  Raises :class:`_Exhausted` (from
    the last error) when the budget runs out — callers translate that
    into :class:`CollectiveTimeoutError` or a degraded fallback.

    ``fault_site`` names the chaos hook fired at the top of each attempt
    (inside the try, so injected faults are retried like real ones).
    """
    rng = rng if rng is not None else random.Random(policy.seed)
    start = time.monotonic()

    def remaining() -> Optional[float]:
        if policy.deadline is None:
            return None
        return policy.deadline - (time.monotonic() - start)

    last_exc: Optional[BaseException] = None
    for attempt in range(1, policy.max_attempts + 1):
        budget = remaining()
        if budget is not None and budget <= 0:
            raise _Exhausted(_peer_of(last_exc)) from last_exc
        try:
            if fault_site is not None and _faults.ENABLED:
                _faults.fire(fault_site, op=op, attempt=attempt)
            if budget is None:
                return fn()
            return _call_with_deadline(op, fn, budget, attempt)
        except _Exhausted:
            raise
        except Exception as exc:  # noqa: BLE001 - retried / re-raised below
            last_exc = exc
            if attempt >= policy.max_attempts:
                raise _Exhausted(_peer_of(exc)) from exc
            delay = policy.backoff(attempt, rng)
            budget = remaining()
            if budget is not None:
                if budget <= 0:
                    raise _Exhausted(_peer_of(exc)) from exc
                delay = min(delay, budget)
            if _telemetry.ENABLED:
                if _trace.ENABLED:
                    # One child span per failed attempt: the trace tree
                    # shows a retry storm as distinct siblings under the
                    # operation that retried, not one flat node.
                    with _trace.span("retry_attempt"):
                        _telemetry.record_retry(op, attempt, delay, repr(exc))
                else:
                    _telemetry.record_retry(op, attempt, delay, repr(exc))
            time.sleep(delay)
    raise _Exhausted(_peer_of(last_exc)) from last_exc  # pragma: no cover


def retry_call(
    op: str,
    fn: Callable[[], Any],
    policy: RetryPolicy,
    *,
    rng: Optional[random.Random] = None,
    fault_site: Optional[str] = None,
) -> Any:
    """:func:`run_with_retry` with exhaustion translated into the public
    :class:`CollectiveTimeoutError`: the entry point for callers that
    want retry-or-raise without the degrade option (e.g.
    ``parallel.make_synced_update(retry=...)``)."""
    try:
        return run_with_retry(op, fn, policy, rng=rng, fault_site=fault_site)
    except _Exhausted as exhausted:
        raise CollectiveTimeoutError(
            op,
            attempts=policy.max_attempts,
            deadline=policy.deadline,
            peer=exhausted.peer,
        ) from exhausted.__cause__


def _peer_of(exc: Optional[BaseException]) -> Optional[int]:
    """Pull a peer rank out of an error when the backend attached one
    (``exc.peer``) — best effort; most timeouts don't know."""
    peer = getattr(exc, "peer", None)
    return peer if isinstance(peer, int) else None


def _call_with_deadline(
    op: str, fn: Callable[[], Any], budget: float, attempt: int
) -> Any:
    """Run ``fn`` on a reaper thread, abandoning it at ``budget``
    seconds.  On timeout the daemon thread may leak (a truly stuck RPC
    cannot be cancelled from Python) but the caller returns on time."""
    box: List[Any] = [None, None]  # [result, exception]
    done = threading.Event()
    # Explicit handoff: anything fn() emits on the reaper thread keeps
    # the caller's trace context (contextvars don't cross Thread()).
    ctx = _trace.capture() if _trace.ENABLED else None

    def target() -> None:
        if _trace.ENABLED:
            _trace.adopt(ctx)
        try:
            box[0] = fn()
        except BaseException as e:  # noqa: BLE001 - relayed to caller
            box[1] = e
        finally:
            done.set()

    t = threading.Thread(
        target=target, name=f"resilient-{op}-a{attempt}", daemon=True
    )
    t.start()
    if not done.wait(timeout=budget):
        raise _Exhausted() from TimeoutError(
            f"collective {op!r} attempt {attempt} still in flight after "
            f"{budget:g}s deadline budget"
        )
    if box[1] is not None:
        raise box[1]
    return box[0]


class ResilientGroup(CollectiveGroup):
    """Wrap any :class:`CollectiveGroup` with retry/deadline/degrade
    semantics on its object collectives.

    ``degrade=None`` (default): exhausted retries raise
    :class:`CollectiveTimeoutError`.  ``degrade="local"``: serve the
    local single-host view instead — ``[obj]`` for all-gather, ``obj``
    for broadcast, ``[obj]``/None for gather, as a world of one
    returns, and emit a ``degraded`` telemetry event and a
    ``RuntimeWarning``.  The degraded event carries the surviving-rank
    set: the attached ``membership`` view's live ranks when one was given
    (a :class:`~torcheval_tpu_torch.resilience.membership.MembershipView`),
    else this rank alone, so a report can attribute which hosts were lost,
    not just that a fallback happened.

    Note a *retry* of a real collective is only coherent when every rank
    retries symmetrically (same policy, same failure) — exactly what a
    coordinator hiccup or a deterministic :class:`FaultPlan` produces.
    Point-to-point sends/receives (:meth:`send_object` /
    :meth:`recv_object`) have no such symmetry requirement and are
    retried independently per peer; they never degrade — exhaustion
    raises, and the merge layer above turns that into an excision.
    """

    _DEGRADE_MODES = (None, "local")

    def __init__(
        self,
        group: CollectiveGroup,
        policy: Optional[RetryPolicy] = None,
        *,
        degrade: Optional[str] = None,
        membership: Optional[Any] = None,
    ) -> None:
        if degrade not in self._DEGRADE_MODES:
            raise ValueError(
                f"degrade must be one of {self._DEGRADE_MODES}, got {degrade!r}"
            )
        self.inner = group
        self.policy = policy if policy is not None else RetryPolicy()
        self.degrade = degrade
        self.membership = membership
        self._rng = random.Random(self.policy.seed)

    @property
    def rank(self) -> int:
        return self.inner.rank

    @property
    def world_size(self) -> int:
        return self.inner.world_size

    def _call(self, op: str, fn: Callable[[], Any], local_view: Any) -> Any:
        try:
            return run_with_retry(
                op,
                fn,
                self.policy,
                rng=self._rng,
                fault_site="collective",
            )
        except _Exhausted as exhausted:
            cause = exhausted.__cause__
            if self.degrade == "local":
                reason = repr(cause) if cause is not None else "exhausted"
                if _telemetry.ENABLED:
                    survivors = (
                        self.membership.survivors_label()
                        if self.membership is not None
                        else str(self.rank)
                    )
                    _telemetry.record_degraded(
                        op, reason, "local", survivors=survivors
                    )
                warnings.warn(
                    f"collective {op!r} exhausted its retry budget "
                    f"({reason}); degrading to the local single-host view",
                    RuntimeWarning,
                    stacklevel=3,
                )
                return local_view
            raise CollectiveTimeoutError(
                op,
                attempts=self.policy.max_attempts,
                deadline=self.policy.deadline,
                peer=exhausted.peer,
            ) from cause

    def all_gather_object(self, obj: Any) -> List[Any]:
        return self._call(
            "all_gather_object",
            lambda: self.inner.all_gather_object(obj),
            [obj],
        )

    def broadcast_object(self, obj: Any, src: int) -> Any:
        return self._call(
            "broadcast_object",
            lambda: self.inner.broadcast_object(obj, src),
            obj,
        )

    def gather_object(self, obj: Any, dst: int = 0) -> Optional[List[Any]]:
        local = [obj] if self.inner.rank == dst else None
        return self._call(
            "gather_object",
            lambda: self.inner.gather_object(obj, dst),
            local,
        )

    # Point-to-point: retried per peer, never degraded — a peer that
    # stays silent past the budget raises CollectiveTimeoutError with
    # its rank attached, and the fleet merge turns that into an excision
    # rather than a run-wide fallback.
    @property
    def supports_p2p(self) -> bool:
        return self.inner.supports_p2p

    def send_object(self, obj: Any, dst: int, tag: str) -> None:
        retry_call(
            "send_object",
            lambda: self.inner.send_object(obj, dst, tag),
            self.policy,
            rng=self._rng,
            fault_site="collective",
        )

    def recv_object(
        self, src: int, tag: str, timeout: Optional[float] = None
    ) -> Any:
        return retry_call(
            "recv_object",
            lambda: self.inner.recv_object(src, tag, timeout=timeout),
            self.policy,
            rng=self._rng,
            fault_site="collective",
        )
