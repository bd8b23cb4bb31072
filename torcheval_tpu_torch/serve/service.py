"""EvalService — the overload-safe multi-tenant front door (the port of
``torcheval_tpu/serve/service.py``).

One service owns a :class:`~torcheval_tpu_torch.serve.registry.
SessionRegistry` (tenant seating + shared programs), an
:class:`~torcheval_tpu_torch.serve.admission.AdmissionController` (bounded
queues + shed policies), and the spill/quarantine machinery that keeps
one misbehaving tenant from taking the rest down:

* **Backpressure** — ``submit()`` never blocks and never throws under
  load; it returns a typed outcome the caller branches on.  A 10×
  burst degrades into shed events, not an OOM or a dead process.
* **Poison quarantine** — a tenant whose batch trips the data-health
  monitor (or whose update raises) is rolled back from the
  pre-dispatch state snapshot, its queued work purged, and the tenant
  marked quarantined; a ``QuarantineEvent`` lands on the bus and the
  flight recorder dumps a post-mortem bundle.  Because tenants only
  ever touch their own seat's masked slice, every other tenant's
  results stay bit-identical to a solo run.
* **Idle spill** — past ``max_resident`` seated tenants, the
  least-recently-touched sessions are checkpointed through
  :class:`~torcheval_tpu_torch.resilience.checkpoint.CheckpointManager`
  (per-tenant namespace) and their seats freed; the next touch
  transparently resumes them, possibly on a different seat or group.
* **Graceful drain** — ``drain()`` stops admission, pumps the queue to
  empty under a deadline, and final-checkpoints every resident tenant.

Processing is pull-based: call :meth:`EvalService.pump` from your own
loop, or :meth:`start` a background worker thread (stop it with
:meth:`stop`; :meth:`drain` stops it too).  All hook sites follow the
one-branch zero-cost-when-off contract.

Devices: a tenant's states stay on its metrics' device (``cuda`` by
default, ``device="cpu"`` on a host without a GPU); the service never
moves them.  Every tensor a dispatch makes is made on the group's device,
and every kernel launches on its operands' device, so the worker thread
(whose current CUDA device is its own) never reads the default device.
On a GPU each dispatch of a group with two or more supported members is
one launch of the collection kernel (``mega.cu``).
"""

from __future__ import annotations

import math
import os
import threading
import time
import warnings
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

from torcheval_tpu_torch import _flags
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.resilience import faults as _faults
from torcheval_tpu_torch.resilience.checkpoint import CheckpointManager
from torcheval_tpu_torch.telemetry import events as _telemetry
from torcheval_tpu_torch.telemetry import flightrec as _flightrec
from torcheval_tpu_torch.telemetry import trace as _trace
from torcheval_tpu_torch.telemetry.health import DataCorruptionError

import torcheval_tpu_torch.serve.metering as _metering
from torcheval_tpu_torch.serve.admission import (
    Admitted,
    AdmissionController,
    QueueItem,
    Rejected,
    Shed,
)
from torcheval_tpu_torch.serve.registry import (
    ACTIVE,
    CLOSED,
    QUARANTINED,
    SPILLED,
    DEFAULT_GROUP_WIDTH,
    Session,
    SessionRegistry,
)

# Worker join budget on stop(); a worker alive past it is reported, not
# silently leaked (mirrors engine/prefetch.py).
_JOIN_TIMEOUT_S = 5.0

# Worker idle poll period: a submit sets the wake event, so this only
# bounds shutdown latency when the queue stays empty.
_IDLE_TICK_S = 0.01

# Host-side admit-wait reservoir for stats()/the bench p99 (the bus
# histogram is the durable record; this keeps stats() telemetry-free).
_WAIT_WINDOW = 4096


def _p99(waits: List[float]) -> float:
    if not waits:
        return 0.0
    ordered = sorted(waits)
    rank = max(0, math.ceil(0.99 * len(ordered)) - 1)
    return ordered[rank]


@dataclass(frozen=True)
class DrainResult:
    """Typed outcome of :meth:`EvalService.drain`.

    ``expired`` means the deadline fired before the queue emptied; the
    service then spilled every undispatched resident session it could
    reach (``spilled``) so their state survives the shutdown, and
    ``unspilled`` names the ones it could not.  ``stuck`` flags the
    pathological case: a dispatch wedged inside the pump still holds
    the service lock at expiry, so the rescue spill could not run at
    all (the pump helper is leaked as a daemon, mirroring ``stop()``'s
    contract).  Indexing (``result["processed"]``) is kept for callers
    of the old dict-shaped summary.
    """

    processed: int
    flushed: bool
    pending: int
    expired: bool = False
    spilled: int = 0
    unspilled: Tuple[str, ...] = ()
    stuck: bool = False

    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)


class EvalService:
    """Multi-tenant metric evaluation with admission control.

    Thread-safety: every public method is safe to call from any thread;
    registry and session mutations serialize on one reentrant lock, and
    the admission controller's internal lock is only ever taken under
    it (fixed lock order: service → admission).
    """

    def __init__(
        self,
        *,
        group_width: int = DEFAULT_GROUP_WIDTH,
        bucket: bool = True,
        admission: Optional[AdmissionController] = None,
        spill_dir: Optional[str] = None,
        max_resident: Optional[int] = None,
        keep: int = 2,
    ) -> None:
        self._registry = SessionRegistry(
            group_width=group_width, bucket=bucket
        )
        self._admission = (
            admission if admission is not None else AdmissionController()
        )
        if spill_dir is None:
            spill_dir = _flags.get_str("SERVE_SPILL_DIR")
        self._spill_root = (
            CheckpointManager(spill_dir, keep=keep)
            if spill_dir is not None
            else None
        )
        if max_resident is not None and max_resident < 1:
            raise ValueError(
                f"max_resident must be >= 1, got {max_resident}"
            )
        self._max_resident = max_resident
        self._lock = threading.RLock()
        self._draining = False
        self._closed = False
        self._waits: deque = deque(maxlen=_WAIT_WINDOW)
        self._counts: Dict[str, int] = {
            "admitted": 0,
            "shed": 0,
            "rejected": 0,
            "dispatched": 0,
            "quarantined": 0,
            "spills": 0,
            "resumes": 0,
        }
        self._worker: Optional[threading.Thread] = None
        self._stop_flag = threading.Event()
        self._wake = threading.Event()
        # Cold resolver: the unset TENANT_METERING tribool auto-enables
        # the per-tenant ledger exactly when serve is in use.
        _metering.activate_for_serve()

    # ------------------------------------------------------------ sessions
    def open(
        self,
        tenant: str,
        metrics: Mapping[str, Metric],
        *,
        signature: Optional[Tuple[Any, ...]] = None,
    ) -> Session:
        """Register ``tenant``; same-signature tenants coalesce onto a
        shared sliced collection.  The metrics' current states are
        adopted into the tenant's seat."""
        with self._lock:
            if self._closed or self._draining:
                raise RuntimeError(
                    "EvalService is draining/closed; no new sessions"
                )
            session = self._registry.open(
                tenant, metrics, signature=signature
            )
            if _telemetry.ENABLED:
                _telemetry.record_session("open", tenant)
            self._maybe_spill(exclude=session)
            return session

    def close(self, tenant: str) -> None:
        """End ``tenant``'s session: purge its queue, free its seat,
        and delete its spill namespace (siblings untouched)."""
        with self._lock:
            session = self._registry.session(tenant)
            if session is None:
                raise KeyError(f"unknown tenant {tenant!r}")
            self._admission.purge(tenant)
            self._registry.release(session)
            if self._spill_root is not None:
                self._spill_root.namespace(tenant).delete_all()
            session.state = CLOSED
            if _telemetry.ENABLED:
                _telemetry.record_session("close", tenant)

    # ----------------------------------------------------------- admission
    def submit(
        self,
        tenant: str,
        *args: Any,
        deadline_s: Optional[float] = None,
        **kwargs: Any,
    ) -> Union[Admitted, Shed, Rejected]:
        """Offer one batch.  Non-blocking; returns a typed outcome.
        Positional arrays and ``mask=``/``weight=`` keywords flow to
        the metrics' ``update`` unchanged (``slice_ids`` is owned by
        the service and must not be passed)."""
        if "slice_ids" in kwargs:
            raise TypeError(
                "slice_ids= is assigned by the service (the tenant's seat)"
            )
        if _faults.ENABLED:
            _faults.fire(
                "serve.admit",
                tenant=tenant,
                    # tpulint: disable=TPU006 -- depth() locks internally; fire stays outside self._lock so injected delays can't stall the pump
                    queue_depth=self._admission.depth(),
            )
        with self._lock:
            session = self._registry.session(tenant)
            if session is None or session.state == CLOSED:
                return self._reject(tenant, "unknown-tenant")
            if session.state == QUARANTINED:
                return self._reject(tenant, "quarantined")
            if self._closed:
                return self._reject(tenant, "closed")
            if self._draining:
                return self._reject(tenant, "draining")
            ctx = _trace.capture() if _trace.ENABLED else None
            now = time.monotonic()
            outcome, dropped = self._admission.offer(
                tenant,
                args,
                kwargs,
                now=now,
                deadline_s=deadline_s,
                trace_ctx=ctx,
            )
            for victim in dropped:
                self._counts["shed"] += 1
                if _telemetry.ENABLED:
                    _telemetry.record_admission(
                        victim.tenant,
                        "shed",
                        reason="drop-oldest",
                        policy=self._admission.policy,
                        queue_depth=outcome.queue_depth,
                        wait_s=now - victim.enqueued_at,
                    )
                if _metering.ENABLED:
                    _metering.record_submit(
                        victim.tenant,
                        "shed",
                        queue_depth=self._admission.depth(victim.tenant),
                    )
            if isinstance(outcome, Admitted):
                self._counts["admitted"] += 1
                if _telemetry.ENABLED:
                    _telemetry.record_admission(
                        tenant,
                        "admitted",
                        policy=self._admission.policy,
                        queue_depth=outcome.queue_depth,
                    )
                if _metering.ENABLED:
                    _metering.record_submit(
                        tenant,
                        "admitted",
                        nbytes=_metering.payload_nbytes(args, kwargs),
                        queue_depth=self._admission.depth(tenant),
                    )
            else:
                self._counts["shed"] += 1
                if _telemetry.ENABLED:
                    _telemetry.record_admission(
                        tenant,
                        "shed",
                        reason=outcome.reason,
                        policy=self._admission.policy,
                        queue_depth=outcome.queue_depth,
                    )
                if _metering.ENABLED:
                    _metering.record_submit(
                        tenant,
                        "shed",
                        queue_depth=self._admission.depth(tenant),
                    )
        self._wake.set()
        return outcome

    def _reject(self, tenant: str, reason: str) -> Rejected:
        self._counts["rejected"] += 1
        if _telemetry.ENABLED:
            _telemetry.record_admission(
                tenant,
                "rejected",
                reason=reason,
                policy=self._admission.policy,
                queue_depth=self._admission.depth(),
            )
        if _metering.ENABLED:
            _metering.record_submit(
                tenant,
                "rejected",
                queue_depth=self._admission.depth(tenant),
            )
        return Rejected(tenant=tenant, reason=reason)

    # ---------------------------------------------------------- processing
    def pump(self, max_items: Optional[int] = None) -> int:
        """Process queued batches synchronously; returns how many were
        dispatched.  Deadline-expired items are shed at pop, never
        executed."""
        processed = 0
        while max_items is None or processed < max_items:
            # Same lock order as submit (service, then admission's own
            # lock inside pop) — and the shed accounting must not race
            # submit's counter updates.
            with self._lock:
                now = time.monotonic()
                item, expired = self._admission.pop(now=now)
                for stale in expired:
                    self._counts["shed"] += 1
                    if _telemetry.ENABLED:
                        _telemetry.record_admission(
                            stale.tenant,
                            "shed",
                            reason="deadline",
                            policy=self._admission.policy,
                            queue_depth=self._admission.depth(),
                            # The wait the expired batch actually paid —
                            # exactly the batches that waited longest
                            # must not vanish from the latency record.
                            wait_s=now - stale.enqueued_at,
                        )
                    if _metering.ENABLED:
                        _metering.record_submit(
                            stale.tenant,
                            "shed",
                            queue_depth=self._admission.depth(stale.tenant),
                        )
            if item is None:
                break
            if self._process(item):
                processed += 1
        return processed

    def _process(self, item: QueueItem) -> bool:
        with self._lock:
            session = self._registry.session(item.tenant)
            if session is None or session.state in (QUARANTINED, CLOSED):
                # Quarantined/closed after this item was queued (purge
                # raced the pop): drop it, don't execute it.
                self._counts["shed"] += 1
                if _telemetry.ENABLED:
                    _telemetry.record_admission(
                        item.tenant,
                        "shed",
                        reason="tenant-gone",
                        policy=self._admission.policy,
                        queue_depth=self._admission.depth(),
                        wait_s=time.monotonic() - item.enqueued_at,
                    )
                if _metering.ENABLED:
                    _metering.record_submit(
                        item.tenant,
                        "shed",
                        queue_depth=self._admission.depth(item.tenant),
                    )
                return False
            wait = time.monotonic() - item.enqueued_at
            self._waits.append(wait)
            self._counts["dispatched"] += 1
            if _telemetry.ENABLED:
                _telemetry.record_admission(
                    item.tenant,
                    "dispatched",
                    policy=self._admission.policy,
                    queue_depth=self._admission.depth(),
                    wait_s=wait,
                )
            self._ensure_resident(session)
            col = session.group.collection
            # The bundle writes no state in place, so these tensors are the
            # free rollback point the quarantine path restores from (a
            # health escalation fires AFTER the poisoned states installed).
            snapshot = col._read_states()
            t0 = time.monotonic()
            try:
                if _trace.ENABLED and item.trace_ctx is not None:
                    with _trace.activate(item.trace_ctx):
                        with _trace.span("serve.dispatch"):
                            self._registry.dispatch(
                                session, item.args, item.kwargs
                            )
                else:
                    self._registry.dispatch(session, item.args, item.kwargs)
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as exc:  # noqa: BLE001 - isolation boundary
                col._install_states(snapshot)
                self._quarantine(session, exc)
                return False
            session.batches += 1
            self._registry.touch(session)
            done = time.monotonic()
            if _telemetry.ENABLED:
                _telemetry.record_span(
                    "update",
                    "EvalService.dispatch",
                    done - t0,
                    0,
                )
            if _metering.ENABLED:
                _metering.record_dispatch(
                    item.tenant,
                    _metering.program_id(
                        (session.signature, session.group.width)
                    ),
                    rows=_metering.batch_rows(item.args),
                    seconds=done - t0,
                    wait_s=wait,
                    e2e_s=done - item.enqueued_at,
                    queue_depth=self._admission.depth(item.tenant),
                )
            self._maybe_spill(exclude=session)
            return True

    def _quarantine(self, session: Session, exc: BaseException) -> None:
        # Caller holds the lock and has already rolled the group's
        # states back to the pre-dispatch snapshot.
        reason = (
            "data-corruption"
            if isinstance(exc, DataCorruptionError)
            else "update-error"
        )
        session.state = QUARANTINED
        session.quarantine_reason = f"{type(exc).__name__}: {exc}"
        self._registry.release(session)
        purged = self._admission.purge(session.tenant)
        self._counts["quarantined"] += 1
        self._counts["shed"] += len(purged)
        if _telemetry.ENABLED:
            _telemetry.record_quarantine(
                session.tenant,
                reason,
                error=session.quarantine_reason,
                batches_dropped=len(purged),
            )
        if _metering.ENABLED:
            # The ledger survives quarantine: the tenant's pre-quarantine
            # device-time and shed history is exactly what a postmortem
            # needs.
            _metering.record_quarantine(session.tenant)
        if _flightrec.ENABLED:
            extra: Dict[str, Any] = {
                "serve": {
                    "tenant": session.tenant,
                    "reason": reason,
                    "error": session.quarantine_reason,
                    "batches_dropped": len(purged),
                    "batches_applied": session.batches,
                }
            }
            if _metering.ENABLED:
                extra["tenants"] = _metering.ledger_rows()
            _flightrec.trigger(
                "tenant_quarantine",
                f"tenant={session.tenant} {reason}",
                extra=extra,
            )

    # ------------------------------------------------------------- results
    def results(self, tenant: str) -> Dict[str, Any]:
        """``compute()`` over the tenant's seat (resuming it first if
        spilled).  Quarantined tenants raise with their reason."""
        with self._lock:
            session = self._registry.session(tenant)
            if session is None:
                raise KeyError(f"unknown tenant {tenant!r}")
            if session.state == QUARANTINED:
                raise RuntimeError(
                    f"tenant {tenant!r} is quarantined: "
                    f"{session.quarantine_reason}"
                )
            if session.state == CLOSED:
                raise RuntimeError(f"tenant {tenant!r} session is closed")
            self._ensure_resident(session)
            self._registry.touch(session)
            out = self._registry.compute(session)
            if _telemetry.ENABLED:
                for name, value in out.items():
                    try:
                        _telemetry.record_quality(
                            name,
                            slice_label=tenant,
                            window="lifetime",
                            value=float(value),
                            step=session.batches,
                        )
                    except (TypeError, ValueError):
                        pass  # non-scalar results don't ride the bus
            return out

    # --------------------------------------------------------------- spill
    def spill(self, tenant: str) -> None:
        """Explicitly checkpoint-and-evict one resident tenant."""
        with self._lock:
            session = self._registry.session(tenant)
            if session is None:
                raise KeyError(f"unknown tenant {tenant!r}")
            if session.state != ACTIVE:
                raise RuntimeError(
                    f"tenant {tenant!r} is not resident (state="
                    f"{session.state})"
                )
            if self._spill_root is None:
                raise RuntimeError(
                    "spill requires spill_dir= (or the "
                    "TORCHEVAL_TPU_TORCH_SERVE_SPILL_DIR flag)"
                )
            self._spill_one(session)

    def adopt_spilled(
        self,
        tenant: str,
        metrics: Mapping[str, Metric],
        *,
        signature: Optional[Tuple[Any, ...]] = None,
    ) -> Session:
        """Register a tenant whose state already lives in this
        service's spill namespace (cluster failover / migration
        landing): the session is created directly in the SPILLED state
        and the next touch resumes it through the normal checkpoint
        path — bit-exact, via the same ``load_latest`` validation as
        any other resume."""
        with self._lock:
            if self._closed or self._draining:
                raise RuntimeError(
                    "EvalService is draining/closed; no new sessions"
                )
            if self._spill_root is None:
                raise RuntimeError(
                    "adopt_spilled requires spill_dir= (or the "
                    "TORCHEVAL_TPU_TORCH_SERVE_SPILL_DIR flag)"
                )
            session = self._registry.open(
                tenant, metrics, signature=signature
            )
            self._registry.release(session)
            session.state = SPILLED
            if _telemetry.ENABLED:
                _telemetry.record_session("open", tenant)
            return session

    def resume(self, tenant: str) -> Session:
        """Force a spilled tenant resident now (the cluster needs the
        resumed batch cursor before applying routed batches).  No-op on
        an already-resident tenant."""
        with self._lock:
            session = self._registry.session(tenant)
            if session is None:
                raise KeyError(f"unknown tenant {tenant!r}")
            if session.state in (QUARANTINED, CLOSED):
                raise RuntimeError(
                    f"tenant {tenant!r} cannot resume (state="
                    f"{session.state})"
                )
            self._ensure_resident(session)
            self._registry.touch(session)
            return session

    def evict(self, tenant: str) -> None:
        """Forget a tenant WITHOUT deleting its spill namespace — the
        migration commit: the durable state now belongs to another
        host, so only the local seat and queue are torn down (contrast
        :meth:`close`, which prunes the namespace)."""
        with self._lock:
            session = self._registry.session(tenant)
            if session is None:
                raise KeyError(f"unknown tenant {tenant!r}")
            self._admission.purge(tenant)
            self._registry.forget(session)
            session.state = CLOSED
            if _telemetry.ENABLED:
                _telemetry.record_session("close", tenant)

    def _spill_one(self, session: Session) -> None:
        t0 = time.monotonic()
        flat = self._registry.seat_state_dict(session)
        manager = self._spill_root.namespace(session.tenant)
        path = manager.save(flat, {"batches_seen": session.batches})
        self._registry.release(session)
        session.state = SPILLED
        # tpulint: disable=TPU006 -- caller holds _lock: _spill_one is only reached from locked paths (spill/drain/evict)
        self._counts["spills"] += 1
        if _telemetry.ENABLED:
            _telemetry.record_session(
                "spill",
                session.tenant,
                generation=manager.generations()[-1],
                nbytes=os.path.getsize(path),
                seconds=time.monotonic() - t0,
            )
        if _metering.ENABLED:
            _metering.record_session("spill", session.tenant)

    def _maybe_spill(self, exclude: Optional[Session] = None) -> None:
        if self._spill_root is None or self._max_resident is None:
            return
        lru = self._registry.resident_lru()
        over = len(lru) - self._max_resident
        for session in lru:
            if over <= 0:
                break
            if session is exclude or session.state != ACTIVE:
                continue
            self._spill_one(session)
            over -= 1

    def _ensure_resident(self, session: Session) -> None:
        if session.state != SPILLED:
            return
        t0 = time.monotonic()
        self._registry.attach(session)
        checkpoint = None
        if self._spill_root is not None:
            checkpoint = self._spill_root.namespace(
                session.tenant
            ).load_latest()
        if checkpoint is not None:
            self._registry.load_seat(session, checkpoint.state)
            session.batches = int(
                checkpoint.cursor.get("batches_seen", session.batches)
            )
        elif _telemetry.ENABLED:
            # Spilled state unrecoverable (corrupt/missing generations):
            # the seat restarts from reset — operator-visible data loss.
            _telemetry.record_degraded(
                "serve.resume",
                f"tenant {session.tenant!r}: no valid spill checkpoint; "
                "seat reset",
                "data_loss",
            )
        self._counts["resumes"] += 1
        if _telemetry.ENABLED:
            _telemetry.record_session(
                "resume",
                session.tenant,
                generation=(
                    checkpoint.generation if checkpoint is not None else 0
                ),
                nbytes=checkpoint.nbytes if checkpoint is not None else 0,
                seconds=time.monotonic() - t0,
            )
        if _metering.ENABLED:
            _metering.record_session("resume", session.tenant)

    # --------------------------------------------------------------- drain
    def drain(self, deadline_s: Optional[float] = None) -> DrainResult:
        """Graceful shutdown: stop admission, pump the queue to empty,
        final-checkpoint every resident tenant, and close the service.
        Idempotent.

        ``deadline_s`` is a hard bound against a *stuck pump*: the
        queue is pumped on a helper thread joined against the budget,
        so a wedged dispatch cannot hang the caller.  On expiry the
        undispatched sessions are spilled through the checkpoint path
        (best effort — a dispatch still holding the lock blocks the
        rescue and is reported as ``stuck``) and a typed partial
        :class:`DrainResult` is returned instead of hanging."""
        t0 = time.monotonic()
        with self._lock:
            self._draining = True
        self.stop()
        deadline = None if deadline_s is None else t0 + deadline_s
        expired = False
        stuck = False
        if deadline is None:
            processed = 0
            while self.pump(1):
                processed += 1
        else:
            drained = threading.Event()
            abort = threading.Event()
            counter = {"n": 0}

            def _pump_to_empty() -> None:
                try:
                    while not abort.is_set() and self.pump(1):
                        counter["n"] += 1
                finally:
                    drained.set()

            helper = threading.Thread(
                target=_pump_to_empty,
                name="torcheval-tpu-torch-drain",
                daemon=True,
            )
            helper.start()
            if not drained.wait(
                timeout=max(0.0, deadline - time.monotonic())
            ):
                expired = True
                abort.set()
                # One grace join: a helper BETWEEN items exits at the
                # abort check; one wedged INSIDE a dispatch stays stuck
                # and is leaked as a daemon (stop()'s contract).
                helper.join(timeout=_IDLE_TICK_S)
                stuck = helper.is_alive()
            processed = counter["n"]
        flushed = True
        spilled = 0
        unspilled: List[str] = []
        # The rescue spill must not hang either: a stuck dispatch holds
        # self._lock, so the acquire is bounded and failure is typed.
        locked = self._lock.acquire(timeout=_JOIN_TIMEOUT_S)
        if locked:
            try:
                for session in self._registry.resident_lru():
                    if session.state != ACTIVE:
                        continue
                    if self._spill_root is not None:
                        self._spill_one(session)
                        spilled += 1
                    elif expired:
                        # No checkpoint path configured: the expired
                        # drain can only NAME what it left behind.
                        unspilled.append(session.tenant)
                # tpulint: disable=TPU006 -- lock IS held: acquired via acquire(timeout=) above, released in the finally
                pending = self._admission.depth()
                # tpulint: disable=TPU006 -- lock IS held: acquired via acquire(timeout=) above, released in the finally
                self._closed = True
            finally:
                self._lock.release()
        else:
            stuck = True
            flushed = False
            # tpulint: disable=TPU006 -- gave-up path: the lock is wedged; depth() locks internally
            pending = self._admission.depth()
            # tpulint: disable=TPU006 -- gave-up path: the lock is wedged; a bool store is atomic and monotonic
            self._closed = True
            unspilled = [
                s.tenant
                for s in self._registry.sessions().values()
                if s.state == ACTIVE
            ]
        if stuck and _telemetry.ENABLED:
            _telemetry.record_degraded(
                "serve.drain",
                "drain deadline expired with a dispatch still wedged; "
                "pump helper leaked (daemon)",
                "leaked_thread",
            )
        if _telemetry.ENABLED:
            _telemetry.record_session(
                "drain", "", seconds=time.monotonic() - t0
            )
        return DrainResult(
            processed=processed,
            flushed=flushed and pending == 0 and not expired,
            pending=pending,
            expired=expired,
            spilled=spilled,
            unspilled=tuple(unspilled),
            stuck=stuck,
        )

    # -------------------------------------------------------------- worker
    def start(self) -> "EvalService":
        """Start the background pump thread (idempotent)."""
        with self._lock:
            if self._worker is not None:
                return self
            if self._closed:
                raise RuntimeError("EvalService is closed")
            self._stop_flag.clear()
            # contextvars do not flow into Thread targets; hand the
            # caller's trace context over explicitly (prefetch idiom).
            worker_ctx = _trace.capture() if _trace.ENABLED else None
            self._worker = threading.Thread(
                target=self._run,
                args=(worker_ctx,),
                name="torcheval-tpu-torch-serve",
                daemon=True,
            )
            self._worker.start()
        return self

    def _run(self, worker_ctx: Any) -> None:
        if _trace.ENABLED:
            _trace.adopt(worker_ctx)
        while not self._stop_flag.is_set():
            if self.pump(16) == 0:
                self._wake.wait(timeout=_IDLE_TICK_S)
                self._wake.clear()

    def stop(self) -> None:
        """Stop and join the worker thread (idempotent)."""
        with self._lock:
            worker = self._worker
            self._worker = None
        if worker is None:
            return
        self._stop_flag.set()
        self._wake.set()
        worker.join(timeout=_JOIN_TIMEOUT_S)
        if worker.is_alive():
            # Daemon thread: the process can still exit, but a silent
            # leak would mask a wedged dispatch — report it.
            if _telemetry.ENABLED:
                _telemetry.record_degraded(
                    "serve.stop",
                    f"worker thread still alive after {_JOIN_TIMEOUT_S:g}s "
                    "join",
                    "leaked_thread",
                )
            warnings.warn(
                "EvalService.stop(): worker thread did not exit within "
                f"{_JOIN_TIMEOUT_S:g}s and was leaked (daemon). A metric "
                "dispatch is likely wedged.",
                RuntimeWarning,
                stacklevel=2,
            )

    def session(self, tenant: str) -> Optional[Session]:
        """The tenant's session record, or None (cluster placement and
        tests peek at lifecycle state without reaching into the
        registry)."""
        with self._lock:
            return self._registry.session(tenant)

    # --------------------------------------------------------------- stats
    def stats(self) -> Dict[str, Any]:
        """Host-side service counters (valid with telemetry off)."""
        with self._lock:
            states: Dict[str, int] = {}
            for session in self._registry.sessions().values():
                states[session.state] = states.get(session.state, 0) + 1
            info = self._registry.program_cache_info()
            return {
                "queue_depth": self._admission.depth(),
                "tenants": states,
                "groups": self._registry.group_count(),
                "programs": {
                    "currsize": info.currsize,
                    "hits": info.hits,
                    "misses": info.misses,
                    "evictions": info.evictions,
                },
                "admit_wait_p99_s": _p99(list(self._waits)),
                "counts": dict(self._counts),
            }
