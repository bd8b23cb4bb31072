"""The telemetry event bus: typed events, a bounded ring buffer, and the
aggregate counters the exporters drain (the port of
``torcheval_tpu/telemetry/events.py``).

The port's hook sites feed this one module: bucket padding waste
(``metrics/_bucket``), collective sync calls (``distributed.LocalGroup``
and ``parallel/sync``), update/compute/dispatch spans
(``metrics/metric``, ``metrics/collection``, ``metrics/_fuse``), the
data-health monitor's findings (:mod:`.health`), and the resilience
layer's retry/degraded/checkpoint lifecycle
(:mod:`torcheval_tpu_torch.resilience`).

Every event class of the JAX bus is here, with the same fields and
``kind`` strings, so ``export.read_jsonl`` parses a JAX dump and the JAX
package parses the port's.  Three have no hook site in the port and are
kept for those dumps only: :class:`RetraceEvent` (PyTorch runs eagerly
and traces no program), :class:`DonationEvent` (no buffer is donated to a
compiler) and :class:`CacheEvent` (no sharded-program cache).  The engine,
perfscope, routing, monitor and serve events get their hook sites with
those modules.

Zero-cost-when-off contract
---------------------------
Every hook site is guarded by a single branch on the module-level
:data:`ENABLED` flag::

    from torcheval_tpu_torch.telemetry import events as _telemetry
    ...
    if _telemetry.ENABLED:
        _telemetry.record_bucket_pad(...)

so with telemetry off (the default) the hot path pays one attribute read
and one branch and never calls into this module.

A span (:func:`timed_phase`, the ``dispatch`` span of ``_fuse``, the
collection's ``fused`` span) is the **host** time of the call, as in the
JAX package: no device synchronisation is added, so a phase on the GPU
that does not wait for the device times its enqueue.

The buffer is a bounded deque under a lock: emission is thread-safe (the
ranks of a ``LocalWorld`` emit from their own threads) and memory is
capped: when full, the oldest events are dropped and counted in
``dropped``.  Aggregate counters are updated on every emit and survive
ring overflow, so the Prometheus snapshot and :func:`report` totals stay
exact after the ring has wrapped.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional, Tuple

from torcheval_tpu_torch import _flags
from torcheval_tpu_torch.telemetry import flightrec as _flightrec
from torcheval_tpu_torch.telemetry import trace as _trace

_TRUTHY = _flags.TRUTHY

DEFAULT_CAPACITY = _flags.INT_FLAGS["TELEMETRY_CAPACITY"][0]

# Fixed histogram bucket bounds (seconds) for sync / span durations —
# Prometheus ``le`` convention, +Inf implicit.
DURATION_BUCKETS: Tuple[float, ...] = (
    1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0
)


def _env_capacity() -> int:
    return _flags.get_int("TELEMETRY_CAPACITY")


# Module-level flags: the hooks read these as plain attributes.  Both are
# initialized from the environment at import so
# ``TORCHEVAL_TPU_TORCH_TELEMETRY=1 python eval.py`` needs no code change.
ENABLED: bool = _flags.get("TELEMETRY")
# When also truthy, update/compute spans run under
# ``torch.profiler.record_function`` so they land in profiler traces.
ANNOTATE: bool = _flags.get("TELEMETRY_ANNOTATE")

_lock = threading.Lock()
_events: "deque[Event]" = deque(maxlen=_env_capacity())
_dropped: int = 0
# Per-kind eviction counts (the kind of each event the full ring pushed
# out) — flight-recorder truncation must itself be observable.
_dropped_by_kind: Dict[str, int] = {}


# --------------------------------------------------------------------- events
@dataclass
class Event:
    """Base event: a kind tag, a monotonic timestamp, the user callsite
    (``"file:line"``) the emission is attributed to, and the emitting
    thread's name (the Perfetto track — the prefetch producer and the
    dispatch loop emit concurrently).

    ``trace_id`` / ``span_id`` / ``parent_span_id`` are the causal
    identity stamped by :mod:`torcheval_tpu_torch.telemetry.trace` when
    tracing is on; they default to ``""`` and are omitted from the
    serialized form when empty, so dumps written with tracing off are
    byte-identical to pre-trace dumps and old dumps round-trip through
    ``export.event_from_dict`` unchanged."""

    kind: str = field(init=False, default="event")
    time_s: float = field(default=0.0)
    callsite: str = field(default="<unknown>:0")
    thread: str = field(default="")
    trace_id: str = field(default="")
    span_id: str = field(default="")
    parent_span_id: str = field(default="")


@dataclass
class RetraceEvent(Event):
    """One trace of an update-path program (``_stats.bump_trace``) —
    each is a compile, ~15 s through a remote TPU compiler."""

    kind: str = field(init=False, default="retrace")
    program: str = ""  # "accumulate" | "windowed" | "fused_collection" | ...


@dataclass
class CacheEvent(Event):
    """One lookup in the shared sharded-program memoizer
    (``parallel/_compile_cache.compiled_spmd``) — or, with ``evicted``,
    one entry dropped past an :class:`~torcheval_tpu.parallel.
    _compile_cache.LruCache`'s capacity (``TORCHEVAL_TPU_
    COMPILE_CACHE_CAP``): a revisit of the evicted key will recompile."""

    kind: str = field(init=False, default="spmd_cache_hit")
    hit: bool = True
    evicted: bool = False

    def __post_init__(self) -> None:
        if self.evicted:
            self.kind = "spmd_cache_evict"
        else:
            self.kind = "spmd_cache_hit" if self.hit else "spmd_cache_miss"


@dataclass
class RouteDowngradeEvent(Event):
    """A call-time fast-path decider fell back to a slower formulation
    (``routing.warn_route_downgrade``) — recorded on EVERY occurrence,
    unlike the warning, which dedupes per callsite."""

    kind: str = field(init=False, default="route_downgrade")
    route_kind: str = ""
    message: str = ""


@dataclass
class BucketPadEvent(Event):
    """One ragged batch padded to its power-of-two bucket
    (``metrics/_bucket.pad_to_bucket``): ``rows_padded / bucket`` is the
    wasted compute fraction of that dispatch."""

    kind: str = field(init=False, default="bucket_pad")
    bucket: int = 0
    rows_valid: int = 0
    rows_padded: int = 0


@dataclass
class DonationEvent(Event):
    """Buffer-donation lifecycle on the fused update paths: ``abort``
    when a donated update died mid-trace/mid-flight, ``restore`` when a
    consumed state buffer was re-materialized from its registry default."""

    kind: str = field(init=False, default="donation_restore")
    action: str = "restore"  # "restore" | "abort"

    def __post_init__(self) -> None:
        self.kind = f"donation_{self.action}"


@dataclass
class SyncEvent(Event):
    """One cross-device/cross-process merge: collective wall-clock
    seconds (dispatch + block_until_ready, or host wire round trip) and
    the merged payload size in bytes.

    Hierarchical merges (``parallel.fleet_merge``) additionally stamp
    the tree/ring ``level`` the hop ran at (1 = leaf hop) and the
    ``fanout`` (children merged at that node); flat collectives leave
    the defaults (``level=-1``), so existing emitters are unchanged and
    per-level aggregation only sees real merge hops."""

    kind: str = field(init=False, default="sync")
    op: str = ""
    seconds: float = 0.0
    payload_bytes: int = 0
    level: int = -1
    fanout: int = 0


@dataclass
class EngineBlockEvent(Event):
    """One scan-fused block dispatched by the streaming engine
    (``torcheval_tpu/engine``): ``batches`` real batches plus
    ``pad_steps`` fully-masked tail-pad steps folded through ONE host
    dispatch of ``block_size`` scan steps."""

    kind: str = field(init=False, default="engine_block")
    block_size: int = 0
    batches: int = 0
    pad_steps: int = 0


@dataclass
class PrefetchStallEvent(Event):
    """The engine's dispatch loop found the prefetch queue empty and
    blocked ``seconds`` for the next staged block — a pipeline bubble
    (the host/H2D side could not keep ahead of the device)."""

    kind: str = field(init=False, default="prefetch_stall")
    seconds: float = 0.0


@dataclass
class DataHealthEvent(Event):
    """A data-quality finding from the streaming health monitor
    (:mod:`torcheval_tpu_torch.telemetry.health`): ``count`` offending
    elements/batches of ``check`` kind observed in positional update
    argument ``arg``, attributed to member ``metric`` when the check is
    member-specific (out-of-range labels vs that member's class count;
    empty for input-level checks)."""

    kind: str = field(init=False, default="data_health")
    check: str = ""  # "nan" | "inf" | "constant" | "label_range" | "zero_weight"
    source: str = ""  # "fused_update" | "engine_block"
    metric: str = ""
    arg: int = -1
    count: int = 0


@dataclass
class RetryEvent(Event):
    """One failed attempt of a retried operation (a collective under
    :class:`torcheval_tpu_torch.resilience.ResilientGroup`, or a retried
    synced dispatch): the attempt number that failed, the backoff delay
    chosen before the next attempt, and the error text."""

    kind: str = field(init=False, default="retry")
    op: str = ""
    attempt: int = 0
    delay_s: float = 0.0
    error: str = ""


@dataclass
class DegradedEvent(Event):
    """A resilience fallback fired: after exhausted retries the wrapper
    served the local single-host view instead of the fleet collective
    (``fallback="local"``), or a component shed work to stay live (e.g.
    a prefetch producer thread leaked past its join deadline).  Never
    silent — every degradation is one of these.

    ``survivors`` is the comma-joined set of ranks still considered
    live when the fallback fired (e.g. ``"0,2,3"``) — empty when the
    emitter has no membership view — so ``fleet_report`` can attribute
    WHICH hosts were lost, not just that a fallback happened."""

    kind: str = field(init=False, default="degraded")
    op: str = ""
    reason: str = ""
    fallback: str = "local"
    survivors: str = ""


@dataclass
class CheckpointEvent(Event):
    """One durable-checkpoint lifecycle step from
    :mod:`torcheval_tpu_torch.resilience.checkpoint`: ``action`` is ``save``
    (atomic write landed), ``restore`` (auto-resume loaded a valid
    generation), or ``quarantine`` (hash/manifest validation failed and
    the generation was set aside)."""

    kind: str = field(init=False, default="checkpoint")
    action: str = "save"  # "save" | "restore" | "quarantine"
    path: str = ""
    generation: int = 0
    nbytes: int = 0
    seconds: float = 0.0


@dataclass
class ProgramProfileEvent(Event):
    """One compiled hot-path program priced by XLA at a build site
    (:mod:`torcheval_tpu.telemetry.perfscope`): ``cost_analysis()``
    flops / bytes-accessed, ``memory_analysis()`` peak/temp/argument/
    output bytes, the batch payload bytes of the profiled call (so the
    reread multiplier ``bytes_accessed / batch_bytes`` is derivable),
    and the donation verification verdict (``donated`` requested vs
    ``aliased`` actually present in the program)."""

    kind: str = field(init=False, default="program_profile")
    program: str = ""  # "fused_collection" | "engine_scan" | "spmd:<op>"
    flops: int = 0
    bytes_accessed: int = 0
    peak_bytes: int = 0
    temp_bytes: int = 0
    argument_bytes: int = 0
    output_bytes: int = 0
    batch_bytes: int = 0
    donated: bool = False
    aliased: bool = False


@dataclass
class AlertEvent(Event):
    """One SLO rule violation from the perfscope alert evaluator
    (:func:`torcheval_tpu.telemetry.perfscope.evaluate_slo`): the rule
    name, the observed value vs its threshold, and the rendered
    message.  Fired every evaluation interval the rule stays violated
    — ``alerts_total{rule=...}`` counts re-fires."""

    kind: str = field(init=False, default="alert")
    rule: str = ""
    value: float = 0.0
    threshold: float = 0.0
    message: str = ""


@dataclass
class RouteDecisionEvent(Event):
    """One routing decision resolved by the measured-cost layer
    (:mod:`torcheval_tpu.routing_autotune`): ``decision`` names the
    ambiguous choice (``megakernel`` / ``wavefront`` / ``rank_sketch``
    / ``cm_row_chunk``), ``route`` what was picked for the
    ``signature`` shape bucket, and ``verdict`` whether the pick was
    ``measured`` (the cost store ranked both candidates — ``seconds``
    vs ``alt_seconds`` are the numbers that decided it) or
    ``unmeasured`` (the static heuristic's default stood).  ``source``
    names the winning row's provenance (``measured-race``,
    ``priced-collection``, ``priced-scan``, or ``static``).  Emitted
    once per (decision, signature, store-epoch) — re-lookups hit the
    decision cache silently."""

    kind: str = field(init=False, default="route_decision")
    decision: str = ""
    route: str = ""
    verdict: str = "unmeasured"  # "measured" | "unmeasured"
    signature: str = ""
    seconds: float = 0.0
    alt_seconds: float = 0.0
    source: str = "static"


@dataclass
class QualityEvent(Event):
    """One model-quality reading from the live monitor
    (:mod:`torcheval_tpu.monitor`): member ``metric``'s computed value
    over ``window`` (``"lifetime"`` | ``"decayed"`` | ``"window"``),
    restricted to ``slice_label`` ("" for the global, unsliced figure).
    ``step`` is the publisher's progress cursor (engine blocks
    dispatched, or the caller's own counter)."""

    kind: str = field(init=False, default="quality")
    metric: str = ""
    slice_label: str = ""
    window: str = "lifetime"
    value: float = 0.0
    step: int = 0


@dataclass
class SpanEvent(Event):
    """A timed metric phase (``update`` / ``compute`` / ``dispatch``)
    with the metric's state-memory footprint after the phase."""

    kind: str = field(init=False, default="span")
    phase: str = "update"
    name: str = ""
    seconds: float = 0.0
    state_bytes: int = 0


@dataclass
class AdmissionEvent(Event):
    """One admission decision of the multi-tenant serve layer
    (:mod:`torcheval_tpu.serve`): ``outcome`` is ``admitted`` (enqueued),
    ``shed`` (load-shedding dropped it — ``reason`` names which policy
    limit: per-tenant/global queue full, deadline expired at pop,
    drop-oldest victim, quarantine purge), ``rejected`` (never eligible:
    unknown/quarantined/draining tenant), or ``dispatched`` (an admitted
    batch reached its collection; ``wait_s`` is its queue wait — the
    admit-latency histogram the p99 SLO rule reads)."""

    kind: str = field(init=False, default="admission")
    tenant: str = ""
    outcome: str = "admitted"  # "admitted" | "shed" | "rejected" | "dispatched"
    reason: str = ""
    policy: str = ""
    queue_depth: int = 0
    wait_s: float = 0.0


@dataclass
class QuarantineEvent(Event):
    """A poison tenant was isolated by the serve layer: its batch raised
    (or tripped ``DataCorruptionError``), its group state was rolled
    back to the pre-dispatch snapshot, its queued batches were purged
    (``batches_dropped``), and it now rejects new submissions — every
    other tenant's results remain bit-identical to a solo run."""

    kind: str = field(init=False, default="quarantine")
    tenant: str = ""
    reason: str = ""
    error: str = ""
    batches_dropped: int = 0


@dataclass
class SessionEvent(Event):
    """Tenant-session lifecycle in the serve registry: ``open`` (seat
    acquired), ``spill`` (idle state checkpointed to disk and the seat's
    device buffers reset), ``resume`` (spilled state reloaded on next
    touch), ``close`` (seat released, spill namespace pruned), ``drain``
    (flushed under the shutdown deadline).  ``generation``/``nbytes``
    carry the checkpoint identity for spill/resume."""

    kind: str = field(init=False, default="session_open")
    action: str = "open"  # "open" | "spill" | "resume" | "close" | "drain"
    tenant: str = ""
    generation: int = 0
    nbytes: int = 0
    seconds: float = 0.0

    def __post_init__(self) -> None:
        self.kind = f"session_{self.action}"


@dataclass
class PlacementEvent(Event):
    """Serve-cluster placement lifecycle (``serve/cluster.py``).
    ``action`` is the branch: ``route`` (a batch crossed hosts to its
    owner), ``migrate`` (a two-phase live handoff landed on ``dst``),
    ``repair`` (the ring was rebuilt around dead host ``src``),
    ``recovered`` (a dead host's tenant resumed from its durable
    spill), ``lost`` (a dead host's unspilled session — state
    unrecoverable).  ``epoch`` is the placement epoch the action was
    taken under; ``generation`` carries the checkpoint identity for
    migrate/recovered."""

    kind: str = field(init=False, default="placement")
    action: str = "route"
    tenant: str = ""
    src: int = -1
    dst: int = -1
    epoch: int = 0
    generation: int = 0
    seconds: float = 0.0


@dataclass
class TenantSampleEvent(Event):
    """One cumulative per-tenant metering sample from the serve plane's
    ledger (:mod:`torcheval_tpu.serve.metering`): traffic counters,
    latency quantiles from the queue-wait / end-to-end StreamDigest
    ladders, attributed device-seconds, and the noisy-neighbor verdict
    (``dominant_program`` non-empty when this tenant holds more than
    the configured share of a shared program's rows).  Samples are
    cumulative snapshots, so folding keeps only the LATEST per tenant —
    replaying a dump reconstructs the ledger exactly."""

    kind: str = field(init=False, default="tenant_sample")
    tenant: str = ""
    submits: int = 0
    admitted: int = 0
    shed: int = 0
    rejected: int = 0
    dispatched: int = 0
    quarantined: int = 0
    spills: int = 0
    resumes: int = 0
    rows: int = 0
    payload_bytes: int = 0
    queue_depth: int = 0
    shed_rate: float = 0.0
    wait_p50_s: float = 0.0
    wait_p99_s: float = 0.0
    e2e_p50_s: float = 0.0
    e2e_p99_s: float = 0.0
    device_seconds: float = 0.0
    dominant_program: str = ""
    dominant_share: float = 0.0
    owner: str = ""


# Every event kind the bus can carry → its dataclass, for the JSON-lines
# round trip (``export.event_from_dict``).
KIND_TO_CLASS: Dict[str, type] = {
    "retrace": RetraceEvent,
    "spmd_cache_hit": CacheEvent,
    "spmd_cache_miss": CacheEvent,
    "spmd_cache_evict": CacheEvent,
    "route_downgrade": RouteDowngradeEvent,
    "bucket_pad": BucketPadEvent,
    "donation_restore": DonationEvent,
    "donation_abort": DonationEvent,
    "sync": SyncEvent,
    "span": SpanEvent,
    "engine_block": EngineBlockEvent,
    "prefetch_stall": PrefetchStallEvent,
    "data_health": DataHealthEvent,
    "retry": RetryEvent,
    "degraded": DegradedEvent,
    "checkpoint": CheckpointEvent,
    "program_profile": ProgramProfileEvent,
    "alert": AlertEvent,
    "route_decision": RouteDecisionEvent,
    "quality": QualityEvent,
    "admission": AdmissionEvent,
    "quarantine": QuarantineEvent,
    "session_open": SessionEvent,
    "session_spill": SessionEvent,
    "session_resume": SessionEvent,
    "session_close": SessionEvent,
    "session_drain": SessionEvent,
    "tenant_sample": TenantSampleEvent,
    "placement": PlacementEvent,
}


# ----------------------------------------------------------------- aggregates
def _zero_aggregates() -> Dict[str, Any]:
    return {
        "retrace": {},          # (program, callsite) -> count
        "cache": {"hits": 0, "misses": 0, "evictions": 0},
        "route_downgrade": {},  # (route_kind, callsite) -> count
        "bucket_pad": {},       # bucket -> {"rows_valid": n, "rows_padded": n, "calls": n}
        "donation": {"restore": 0, "abort": 0},
        # op -> {"calls", "seconds", "payload_bytes", "hist": [..]}
        "sync": {},
        # Hierarchical-merge hops only (SyncEvents with level >= 0):
        # (op, level) -> {"calls", "seconds", "payload_bytes",
        # "fanout": max observed, "hist": [..]} — the merge-depth
        # timing spread fleet_report and the merge_level_seconds
        # Prometheus family read.
        "merge_levels": {},
        # (name, phase) -> {"calls", "seconds", "state_bytes", "hist": [..]}
        "spans": {},
        # The streaming engine's dispatch accounting: blocks is the host
        # dispatch count, batches the real batches folded into them.
        "engine": {
            "blocks": 0,
            "batches": 0,
            "pad_steps": 0,
            "prefetch_stalls": 0,
            "stall_seconds": 0.0,
        },
        # (check, metric) -> {"count": offending elements/batches,
        # "events": emissions}; metric is "" for input-level checks.
        "data_health": {},
        # Fault-tolerance accounting (resilience/):
        # retries:    op -> {"attempts": failed attempts, "last_error": str}
        # degraded:   (op, fallback) -> count
        # checkpoint: action -> {"count": n, "seconds": total,
        #                        "nbytes": last payload size}
        "resilience": {
            "retries": {},
            "degraded": {},
            "checkpoint": {},
        },
        # Perfscope program accounting: program -> {"profiles": distinct
        # compiled signatures priced, "flops"/"bytes_accessed"/
        # "batch_bytes": sums over them, memory fields: max observed,
        # "donated"/"aliased": last verdict}.
        "perf": {},
        # SLO alerting: rule -> {"count": fires, "value": last observed,
        # "threshold": rule bound, "message": last rendered text}.
        "alerts": {},
        # Measured-cost routing (torcheval_tpu/routing_autotune):
        # (decision, route, verdict) -> {"count": resolutions,
        # "seconds": winner cost last observed, "alt_seconds": runner-up
        # cost, "source": winning row provenance, "signature": last
        # shape bucket resolved}.
        "route_decisions": {},
        # Live model-quality readings (torcheval_tpu/monitor):
        # (metric, slice_label, window) -> {"value": last, "count":
        # emissions, "min"/"max": extrema observed since clear, "step":
        # last publisher cursor}.
        "quality": {},
        # Multi-tenant serve-layer accounting (torcheval_tpu/serve):
        # shed/rejected key by reason; sessions by lifecycle action;
        # dispatched carries the queue-wait (admit-latency) histogram.
        "serve": {
            "admitted": 0,
            "shed": {},
            "rejected": {},
            "dispatched": {
                "calls": 0,
                "wait_seconds": 0.0,
                "hist": [0] * (len(DURATION_BUCKETS) + 1),
            },
            "quarantined": 0,
            "sessions": {},
        },
        # Per-tenant serve metering: tenant -> the LATEST cumulative
        # TenantSampleEvent row (samples are snapshots of the metering
        # ledger, so last-wins replay reconstructs it exactly).
        "tenants": {},
        "emitted": 0,
    }


_agg: Dict[str, Any] = _zero_aggregates()


def _hist_slot(seconds: float) -> int:
    for i, le in enumerate(DURATION_BUCKETS):
        if seconds <= le:
            return i
    return len(DURATION_BUCKETS)


# ------------------------------------------------------------------- control
def enable(
    *, capacity: Optional[int] = None, annotate: Optional[bool] = None
) -> None:
    """Turn the bus on (equivalently: ``TORCHEVAL_TPU_TORCH_TELEMETRY=1``).

    ``capacity`` resizes the ring buffer (existing events are kept up to
    the new bound); ``annotate=True`` additionally wraps update/compute
    spans in ``torch.profiler.record_function``.
    """
    global ENABLED, ANNOTATE, _events
    with _lock:
        if capacity is not None:
            if capacity < 1:
                raise ValueError(f"capacity must be >= 1, got {capacity}")
            _events = deque(_events, maxlen=int(capacity))
    # Publish the flags only after the ring is resized.  The flags are
    # deliberately lock-free (hooks read them on every update); keeping
    # the writes outside the lock documents that contract instead of
    # implying the lock guards them.
    if annotate is not None:
        ANNOTATE = bool(annotate)
    ENABLED = True


def disable() -> None:
    """Turn the bus off — hooks go back to their single disabled branch.
    Captured events and counters are kept (drain/inspect after a run)."""
    global ENABLED
    ENABLED = False


def enabled() -> bool:
    return ENABLED


def clear() -> None:
    """Drop every captured event and zero the aggregates (test hook)."""
    global _dropped, _agg
    with _lock:
        _events.clear()
        _dropped = 0
        _dropped_by_kind.clear()
        _agg = _zero_aggregates()


def capacity() -> int:
    with _lock:
        return _events.maxlen or 0


def dropped() -> int:
    """Events evicted from the ring since the last :func:`clear`."""
    with _lock:
        return _dropped


def dropped_by_kind() -> Dict[str, int]:
    """Evictions since the last :func:`clear`, keyed by the evicted
    event's kind (sums to :func:`dropped`) — the per-kind truncation
    breakdown ``report()`` and the Prometheus
    ``events_dropped_total{kind=...}`` family surface."""
    with _lock:
        return dict(_dropped_by_kind)


def events(kind: Optional[str] = None) -> List[Event]:
    """Snapshot of the ring buffer, oldest first, optionally filtered by
    ``kind`` (safe to hold; the bus keeps emitting)."""
    with _lock:
        snap = list(_events)
    if kind is None:
        return snap
    return [e for e in snap if e.kind == kind]


def aggregates() -> Dict[str, Any]:
    """Deep-enough copy of the aggregate counters (exporter feed)."""
    with _lock:
        return {
            "retrace": dict(_agg["retrace"]),
            "cache": dict(_agg["cache"]),
            "route_downgrade": dict(_agg["route_downgrade"]),
            "bucket_pad": {
                k: dict(v) for k, v in _agg["bucket_pad"].items()
            },
            "donation": dict(_agg["donation"]),
            "sync": {k: _copy_hist_entry(v) for k, v in _agg["sync"].items()},
            "merge_levels": {
                k: _copy_hist_entry(v)
                for k, v in _agg["merge_levels"].items()
            },
            "spans": {k: _copy_hist_entry(v) for k, v in _agg["spans"].items()},
            "engine": dict(_agg["engine"]),
            "data_health": {
                k: dict(v) for k, v in _agg["data_health"].items()
            },
            "resilience": {
                "retries": {
                    k: dict(v)
                    for k, v in _agg["resilience"]["retries"].items()
                },
                "degraded": dict(_agg["resilience"]["degraded"]),
                "checkpoint": {
                    k: dict(v)
                    for k, v in _agg["resilience"]["checkpoint"].items()
                },
            },
            "perf": {k: dict(v) for k, v in _agg["perf"].items()},
            "alerts": {k: dict(v) for k, v in _agg["alerts"].items()},
            "route_decisions": {
                k: dict(v) for k, v in _agg["route_decisions"].items()
            },
            "quality": {k: dict(v) for k, v in _agg["quality"].items()},
            "serve": {
                "admitted": _agg["serve"]["admitted"],
                "shed": dict(_agg["serve"]["shed"]),
                "rejected": dict(_agg["serve"]["rejected"]),
                "dispatched": _copy_hist_entry(_agg["serve"]["dispatched"]),
                "quarantined": _agg["serve"]["quarantined"],
                "sessions": dict(_agg["serve"]["sessions"]),
            },
            "tenants": {
                k: dict(v) for k, v in _agg["tenants"].items()
            },
            "emitted": _agg["emitted"],
        }


def _copy_hist_entry(entry: Dict[str, Any]) -> Dict[str, Any]:
    out = dict(entry)
    out["hist"] = list(entry["hist"])
    return out


# ------------------------------------------------------------------ emission
_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__))) + os.sep
_skip_dirs: Tuple[str, ...] = ()


def _callsite() -> str:
    """The first stack frame outside the port's package and torch's (a
    span under ``record_function``): the user's call line.  When the 40
    innermost frames are all internal, the outermost of them, so an event
    is never unattributed.  Walks the frames without reading their source
    lines, which ``traceback.extract_stack`` would."""
    global _skip_dirs
    if not _skip_dirs:
        import torch

        _skip_dirs = (_PKG_DIR, os.path.dirname(os.path.abspath(torch.__file__)) + os.sep)
    frame = sys._getframe(2)  # past _callsite and emit
    outer = None
    for _ in range(40):
        if frame is None:
            break
        filename = frame.f_code.co_filename or ""
        if not filename.startswith(_skip_dirs):
            return f"{filename}:{frame.f_lineno or 0}"
        outer = frame
        frame = frame.f_back
    if outer is not None:
        return f"{outer.f_code.co_filename or '<unknown>'}:{outer.f_lineno or 0}"
    return "<unknown>:0"


def emit(event: Event) -> None:
    """Append ``event`` to the ring and fold it into the aggregates.
    Timestamp/callsite/thread — and, when tracing is on, the causal
    trace identity — are stamped here when the caller left defaults."""
    global _dropped
    if event.time_s == 0.0:
        event.time_s = time.monotonic()
    if event.callsite == "<unknown>:0":
        event.callsite = _callsite()
    if not event.thread:
        event.thread = threading.current_thread().name
    if _trace.ENABLED and not event.span_id:
        ctx = _trace.current()
        if ctx is not None:
            event.trace_id = ctx.trace_id
            event.span_id = ctx.span_id
            event.parent_span_id = ctx.parent_span_id
    if _flightrec.ENABLED:
        _flightrec.observe(event)
    with _lock:
        if len(_events) == _events.maxlen:
            _dropped += 1
            evicted = _events[0].kind
            _dropped_by_kind[evicted] = (
                _dropped_by_kind.get(evicted, 0) + 1
            )
        _events.append(event)
        _agg["emitted"] += 1
        _fold(event)


def _fold(event: Event) -> None:
    """Update aggregates for one event.  Caller holds ``_lock``."""
    if isinstance(event, RetraceEvent):
        key = (event.program, event.callsite)
        _agg["retrace"][key] = _agg["retrace"].get(key, 0) + 1
    elif isinstance(event, CacheEvent):
        if event.evicted:
            _agg["cache"]["evictions"] += 1
        else:
            _agg["cache"]["hits" if event.hit else "misses"] += 1
    elif isinstance(event, RouteDowngradeEvent):
        key = (event.route_kind, event.callsite)
        _agg["route_downgrade"][key] = (
            _agg["route_downgrade"].get(key, 0) + 1
        )
    elif isinstance(event, BucketPadEvent):
        entry = _agg["bucket_pad"].setdefault(
            event.bucket, {"rows_valid": 0, "rows_padded": 0, "calls": 0}
        )
        entry["rows_valid"] += event.rows_valid
        entry["rows_padded"] += event.rows_padded
        entry["calls"] += 1
    elif isinstance(event, DonationEvent):
        _agg["donation"][event.action] = (
            _agg["donation"].get(event.action, 0) + 1
        )
    elif isinstance(event, SyncEvent):
        entry = _agg["sync"].setdefault(
            event.op,
            {
                "calls": 0,
                "seconds": 0.0,
                "payload_bytes": 0,
                "hist": [0] * (len(DURATION_BUCKETS) + 1),
            },
        )
        entry["calls"] += 1
        entry["seconds"] += event.seconds
        entry["payload_bytes"] += event.payload_bytes
        entry["hist"][_hist_slot(event.seconds)] += 1
        if event.level >= 0:
            lvl = _agg["merge_levels"].setdefault(
                (event.op, event.level),
                {
                    "calls": 0,
                    "seconds": 0.0,
                    "payload_bytes": 0,
                    "fanout": 0,
                    "hist": [0] * (len(DURATION_BUCKETS) + 1),
                },
            )
            lvl["calls"] += 1
            lvl["seconds"] += event.seconds
            lvl["payload_bytes"] += event.payload_bytes
            lvl["fanout"] = max(lvl["fanout"], event.fanout)
            lvl["hist"][_hist_slot(event.seconds)] += 1
    elif isinstance(event, EngineBlockEvent):
        entry = _agg["engine"]
        entry["blocks"] += 1
        entry["batches"] += event.batches
        entry["pad_steps"] += event.pad_steps
    elif isinstance(event, PrefetchStallEvent):
        entry = _agg["engine"]
        entry["prefetch_stalls"] += 1
        entry["stall_seconds"] += event.seconds
    elif isinstance(event, DataHealthEvent):
        entry = _agg["data_health"].setdefault(
            (event.check, event.metric), {"count": 0, "events": 0}
        )
        entry["count"] += event.count
        entry["events"] += 1
    elif isinstance(event, RetryEvent):
        entry = _agg["resilience"]["retries"].setdefault(
            event.op, {"attempts": 0, "last_error": ""}
        )
        entry["attempts"] += 1
        entry["last_error"] = event.error
    elif isinstance(event, DegradedEvent):
        key = (event.op, event.fallback)
        _agg["resilience"]["degraded"][key] = (
            _agg["resilience"]["degraded"].get(key, 0) + 1
        )
    elif isinstance(event, CheckpointEvent):
        entry = _agg["resilience"]["checkpoint"].setdefault(
            event.action, {"count": 0, "seconds": 0.0, "nbytes": 0}
        )
        entry["count"] += 1
        entry["seconds"] += event.seconds
        entry["nbytes"] = event.nbytes  # last observed payload size
    elif isinstance(event, ProgramProfileEvent):
        entry = _agg["perf"].setdefault(
            event.program,
            {
                "profiles": 0,
                "flops": 0,
                "bytes_accessed": 0,
                "batch_bytes": 0,
                "peak_bytes": 0,
                "temp_bytes": 0,
                "argument_bytes": 0,
                "output_bytes": 0,
                "donated": False,
                "aliased": False,
            },
        )
        entry["profiles"] += 1
        entry["flops"] += event.flops
        entry["bytes_accessed"] += event.bytes_accessed
        entry["batch_bytes"] += event.batch_bytes
        entry["peak_bytes"] = max(entry["peak_bytes"], event.peak_bytes)
        entry["temp_bytes"] = max(entry["temp_bytes"], event.temp_bytes)
        entry["argument_bytes"] = max(
            entry["argument_bytes"], event.argument_bytes
        )
        entry["output_bytes"] = max(
            entry["output_bytes"], event.output_bytes
        )
        entry["donated"] = event.donated
        entry["aliased"] = event.aliased
    elif isinstance(event, AlertEvent):
        entry = _agg["alerts"].setdefault(
            event.rule,
            {"count": 0, "value": 0.0, "threshold": 0.0, "message": ""},
        )
        entry["count"] += 1
        entry["value"] = event.value
        entry["threshold"] = event.threshold
        entry["message"] = event.message
    elif isinstance(event, RouteDecisionEvent):
        entry = _agg["route_decisions"].setdefault(
            (event.decision, event.route, event.verdict),
            {
                "count": 0,
                "seconds": 0.0,
                "alt_seconds": 0.0,
                "source": "static",
                "signature": "",
            },
        )
        entry["count"] += 1
        entry["seconds"] = event.seconds
        entry["alt_seconds"] = event.alt_seconds
        entry["source"] = event.source
        entry["signature"] = event.signature
    elif isinstance(event, QualityEvent):
        entry = _agg["quality"].setdefault(
            (event.metric, event.slice_label, event.window),
            {
                "value": 0.0,
                "count": 0,
                "min": float("inf"),
                "max": float("-inf"),
                "step": 0,
            },
        )
        entry["value"] = event.value
        entry["count"] += 1
        entry["min"] = min(entry["min"], event.value)
        entry["max"] = max(entry["max"], event.value)
        entry["step"] = event.step
    elif isinstance(event, AdmissionEvent):
        serve = _agg["serve"]
        if event.outcome == "admitted":
            serve["admitted"] += 1
        elif event.outcome == "shed":
            serve["shed"][event.reason] = (
                serve["shed"].get(event.reason, 0) + 1
            )
        elif event.outcome == "rejected":
            serve["rejected"][event.reason] = (
                serve["rejected"].get(event.reason, 0) + 1
            )
        elif event.outcome == "dispatched":
            entry = serve["dispatched"]
            entry["calls"] += 1
            entry["wait_seconds"] += event.wait_s
            entry["hist"][_hist_slot(event.wait_s)] += 1
    elif isinstance(event, TenantSampleEvent):
        # Cumulative snapshot: replace, never add (see TenantSampleEvent).
        _agg["tenants"][event.tenant] = {
            "tenant": event.tenant,
            "submits": event.submits,
            "admitted": event.admitted,
            "shed": event.shed,
            "rejected": event.rejected,
            "dispatched": event.dispatched,
            "quarantined": event.quarantined,
            "spills": event.spills,
            "resumes": event.resumes,
            "rows": event.rows,
            "payload_bytes": event.payload_bytes,
            "queue_depth": event.queue_depth,
            "shed_rate": event.shed_rate,
            "wait_p50_s": event.wait_p50_s,
            "wait_p99_s": event.wait_p99_s,
            "e2e_p50_s": event.e2e_p50_s,
            "e2e_p99_s": event.e2e_p99_s,
            "device_seconds": event.device_seconds,
            "dominant_program": event.dominant_program,
            "dominant_share": event.dominant_share,
            "owner": event.owner,
        }
    elif isinstance(event, QuarantineEvent):
        _agg["serve"]["quarantined"] += 1
    elif isinstance(event, SessionEvent):
        sessions = _agg["serve"]["sessions"]
        sessions[event.action] = sessions.get(event.action, 0) + 1
    elif isinstance(event, SpanEvent):
        entry = _agg["spans"].setdefault(
            (event.name, event.phase),
            {
                "calls": 0,
                "seconds": 0.0,
                "state_bytes": 0,
                "hist": [0] * (len(DURATION_BUCKETS) + 1),
            },
        )
        entry["calls"] += 1
        entry["seconds"] += event.seconds
        entry["state_bytes"] = event.state_bytes  # last observed footprint
        entry["hist"][_hist_slot(event.seconds)] += 1


# ------------------------------------------------------- typed record helpers
# One helper per hook site.  Callers MUST branch on ENABLED before calling
# (the zero-overhead contract); the helpers do not re-check.
def record_retrace(program: str) -> None:
    emit(RetraceEvent(program=program))


def record_cache(hit: bool, evicted: bool = False) -> None:
    emit(CacheEvent(hit=hit, evicted=evicted))


def record_route_downgrade(
    route_kind: str, message: str, callsite: Optional[str] = None
) -> None:
    emit(
        RouteDowngradeEvent(
            route_kind=route_kind,
            message=message,
            callsite=callsite or "<unknown>:0",
        )
    )


def record_bucket_pad(bucket: int, rows_valid: int, rows_padded: int) -> None:
    emit(
        BucketPadEvent(
            bucket=int(bucket),
            rows_valid=int(rows_valid),
            rows_padded=int(rows_padded),
        )
    )


def record_donation(action: str) -> None:
    emit(DonationEvent(action=action))


def record_sync(
    op: str,
    seconds: float,
    payload_bytes: int,
    level: int = -1,
    fanout: int = 0,
) -> None:
    emit(
        SyncEvent(
            op=op,
            seconds=float(seconds),
            payload_bytes=int(payload_bytes),
            level=int(level),
            fanout=int(fanout),
        )
    )


def record_engine_block(
    block_size: int, batches: int, pad_steps: int
) -> None:
    emit(
        EngineBlockEvent(
            block_size=int(block_size),
            batches=int(batches),
            pad_steps=int(pad_steps),
        )
    )


def record_prefetch_stall(seconds: float) -> None:
    emit(PrefetchStallEvent(seconds=float(seconds)))


def record_data_health(
    check: str, source: str, metric: str, arg: int, count: int
) -> None:
    emit(
        DataHealthEvent(
            check=check,
            source=source,
            metric=metric,
            arg=int(arg),
            count=int(count),
        )
    )


def record_retry(op: str, attempt: int, delay_s: float, error: str) -> None:
    emit(
        RetryEvent(
            op=op,
            attempt=int(attempt),
            delay_s=float(delay_s),
            error=error,
        )
    )


def record_degraded(
    op: str, reason: str, fallback: str = "local", survivors: str = ""
) -> None:
    emit(
        DegradedEvent(
            op=op, reason=reason, fallback=fallback, survivors=survivors
        )
    )


def record_checkpoint(
    action: str, path: str, generation: int, nbytes: int, seconds: float
) -> None:
    emit(
        CheckpointEvent(
            action=action,
            path=path,
            generation=int(generation),
            nbytes=int(nbytes),
            seconds=float(seconds),
        )
    )


def record_program_profile(
    program: str,
    flops: int,
    bytes_accessed: int,
    peak_bytes: int,
    temp_bytes: int,
    argument_bytes: int,
    output_bytes: int,
    batch_bytes: int,
    donated: bool,
    aliased: bool,
) -> None:
    emit(
        ProgramProfileEvent(
            program=program,
            flops=int(flops),
            bytes_accessed=int(bytes_accessed),
            peak_bytes=int(peak_bytes),
            temp_bytes=int(temp_bytes),
            argument_bytes=int(argument_bytes),
            output_bytes=int(output_bytes),
            batch_bytes=int(batch_bytes),
            donated=bool(donated),
            aliased=bool(aliased),
        )
    )


def record_alert(
    rule: str, value: float, threshold: float, message: str
) -> None:
    emit(
        AlertEvent(
            rule=rule,
            value=float(value),
            threshold=float(threshold),
            message=message,
        )
    )


def record_route_decision(
    decision: str,
    route: str,
    verdict: str,
    signature: str = "",
    seconds: float = 0.0,
    alt_seconds: float = 0.0,
    source: str = "static",
) -> None:
    emit(
        RouteDecisionEvent(
            decision=decision,
            route=route,
            verdict=verdict,
            signature=signature,
            seconds=float(seconds),
            alt_seconds=float(alt_seconds),
            source=source,
        )
    )


def record_quality(
    metric: str,
    slice_label: str,
    window: str,
    value: float,
    step: int = 0,
) -> None:
    emit(
        QualityEvent(
            metric=metric,
            slice_label=slice_label,
            window=window,
            value=float(value),
            step=int(step),
        )
    )


def record_span(
    phase: str, name: str, seconds: float, state_bytes: int
) -> None:
    emit(
        SpanEvent(
            phase=phase,
            name=name,
            seconds=float(seconds),
            state_bytes=int(state_bytes),
        )
    )


def record_admission(
    tenant: str,
    outcome: str,
    reason: str = "",
    policy: str = "",
    queue_depth: int = 0,
    wait_s: float = 0.0,
) -> None:
    emit(
        AdmissionEvent(
            tenant=tenant,
            outcome=outcome,
            reason=reason,
            policy=policy,
            queue_depth=int(queue_depth),
            wait_s=float(wait_s),
        )
    )


def record_quarantine(
    tenant: str, reason: str, error: str = "", batches_dropped: int = 0
) -> None:
    emit(
        QuarantineEvent(
            tenant=tenant,
            reason=reason,
            error=error,
            batches_dropped=int(batches_dropped),
        )
    )


def record_session(
    action: str,
    tenant: str,
    generation: int = 0,
    nbytes: int = 0,
    seconds: float = 0.0,
) -> None:
    emit(
        SessionEvent(
            action=action,
            tenant=tenant,
            generation=int(generation),
            nbytes=int(nbytes),
            seconds=float(seconds),
        )
    )


def record_placement(
    action: str,
    tenant: str,
    src: int = -1,
    dst: int = -1,
    epoch: int = 0,
    generation: int = 0,
    seconds: float = 0.0,
) -> None:
    emit(
        PlacementEvent(
            action=action,
            tenant=tenant,
            src=int(src),
            dst=int(dst),
            epoch=int(epoch),
            generation=int(generation),
            seconds=float(seconds),
        )
    )


def record_tenant_sample(
    tenant: str,
    submits: int = 0,
    admitted: int = 0,
    shed: int = 0,
    rejected: int = 0,
    dispatched: int = 0,
    quarantined: int = 0,
    spills: int = 0,
    resumes: int = 0,
    rows: int = 0,
    payload_bytes: int = 0,
    queue_depth: int = 0,
    shed_rate: float = 0.0,
    wait_p50_s: float = 0.0,
    wait_p99_s: float = 0.0,
    e2e_p50_s: float = 0.0,
    e2e_p99_s: float = 0.0,
    device_seconds: float = 0.0,
    dominant_program: str = "",
    dominant_share: float = 0.0,
    owner: str = "",
) -> None:
    emit(
        TenantSampleEvent(
            tenant=tenant,
            submits=int(submits),
            admitted=int(admitted),
            shed=int(shed),
            rejected=int(rejected),
            dispatched=int(dispatched),
            quarantined=int(quarantined),
            spills=int(spills),
            resumes=int(resumes),
            rows=int(rows),
            payload_bytes=int(payload_bytes),
            queue_depth=int(queue_depth),
            shed_rate=float(shed_rate),
            wait_p50_s=float(wait_p50_s),
            wait_p99_s=float(wait_p99_s),
            e2e_p50_s=float(e2e_p50_s),
            e2e_p99_s=float(e2e_p99_s),
            device_seconds=float(device_seconds),
            dominant_program=dominant_program,
            dominant_share=float(dominant_share),
            owner=str(owner),
        )
    )


# --------------------------------------------------------------- span helper
def state_nbytes(metric: Any) -> int:
    """Total bytes of a metric's registered tensor states (any leaf with a
    ``shape`` and a ``dtype.itemsize``: tensors and numpy arrays)."""
    total = 0
    for name in getattr(metric, "_state_name_to_default", {}):
        value = getattr(metric, name, None)
        if isinstance(value, dict):
            leaves = list(value.values())
        elif isinstance(value, (list, tuple, deque)):
            leaves = list(value)
        else:
            leaves = [value]
        for leaf in leaves:
            try:
                shape = leaf.shape
                itemsize = leaf.dtype.itemsize
            except AttributeError:
                continue
            n = 1
            for d in shape:
                n *= int(d)
            total += n * itemsize
    return total


def timed_phase(obj: Any, phase: str, fn, args, kwargs):
    """Run ``fn(obj, *args, **kwargs)`` as a recorded ``phase`` span
    (with :data:`ANNOTATE`, under ``torch.profiler.record_function``).
    Only called from hook wrappers after their ENABLED branch."""
    name = type(obj).__name__
    if ANNOTATE:
        from torch.profiler import record_function

        with record_function(f"torcheval_tpu_torch.{name}.{phase}"):
            t0 = time.monotonic()
            out = fn(obj, *args, **kwargs)
            seconds = time.monotonic() - t0
    else:
        t0 = time.monotonic()
        out = fn(obj, *args, **kwargs)
        seconds = time.monotonic() - t0
    record_span(phase, name, seconds, state_nbytes(obj))
    return out


def event_fields(cls: type) -> Tuple[str, ...]:
    """The dataclass field names of an event class (exporter helper)."""
    return tuple(f.name for f in fields(cls))
