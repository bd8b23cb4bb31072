"""Perfscope: live roofline accounting, donation verification, one merged
host and device trace, and SLO alerting for the eval hot path (the port
of ``torcheval_tpu/telemetry/perfscope.py``).

This module prices each hot-path program ONCE per signature at its
dispatch site and folds the result into the telemetry ring as a
:class:`~torcheval_tpu_torch.telemetry.events.ProgramProfileEvent`.

The JAX package prices a program with a shadow ``lower().compile()`` and
reads XLA's ``cost_analysis()`` / ``memory_analysis()``.  PyTorch runs
eagerly and has no compiled program to ask, so the port prices the
dispatch it has just run, from what it can observe, and launches nothing
extra:

* ``bytes_accessed``: the batch's bytes, plus every state's bytes read
  before the dispatch and written by it (plus, for a sharded call, the
  merged counts it writes): each input read once, each output written
  once, the byte model of the kernels' bounds (``PERF.md`` §6).
* ``flops``: 0.  Every priced program here (the collection update, the
  engine's block, serve's shared group program, the sharded histograms)
  counts: its work is integer compares and adds, which no floating-point
  peak bounds, so its roofline is its bytes alone.
* ``peak_bytes`` / ``temp_bytes``: on a GPU, how far the caching
  allocator's high-water mark rose over the first dispatch of the
  signature (the peak counter is reset once, at that dispatch), and that
  rise less the bytes of the fresh state tensors it wrote; on the CPU,
  the argument plus output bytes, and no temporaries.
* ``aliased``: whether every state tensor kept its ``data_ptr`` across
  the dispatch, which is what donation means in PyTorch: the counts were
  added into the states' own storage.  Donation asked for and nothing
  aliased fires the ``"donation-verify"`` route-downgrade warning, as in
  the JAX package.

Instrumented dispatch sites (the one-branch ``if _perfscope.ENABLED``
contract of the event bus, the health monitor and the fault hooks):

* ``MetricCollection.fused_update``: ``"mega_collection"`` when the
  collection kernel takes the members, else ``"fused_collection"``;
* the engine's block (``engine/scan.py``): ``"mega_scan"`` /
  ``"engine_scan"``; the engine also runs :func:`maybe_evaluate_slo`
  after every block;
* the sharded histograms (``parallel/sync.py``): ``"spmd:<op>"``;
* serve's shared group program (``serve/registry.py``):
  ``"serve_group"``.

What you get out:

* :func:`explain_perf`: the per-route table: achieved GB/s against the
  device's peaks (:mod:`torcheval_tpu_torch.tools.roofline`), the reread
  multiplier (bytes accessed over batch bytes), the dispatch overhead
  beside the bandwidth-floor device time, and memory peaks;
* :func:`profile`: a ``torch.profiler`` capture (CPU and CUDA activities)
  around a block, with the telemetry ring's host spans merged into it on
  one clock: one ``merged_trace.json`` for ``ui.perfetto.dev``;
* SLO alerting: threshold rules (:class:`SloRule` /
  :func:`default_rules`) evaluated every N engine blocks
  (:func:`maybe_evaluate_slo`) or by hand (:func:`evaluate_slo`), each
  violation an :class:`~torcheval_tpu_torch.telemetry.events.AlertEvent`.

Cost: off, one attribute read and one branch a dispatch.  On, the call's
signature and one set lookup a dispatch, and once a signature the byte
sums, a ``data_ptr`` compare a state, and on a GPU one reset of the
allocator's peak counter.

Example::

    from torcheval_tpu_torch import telemetry
    from torcheval_tpu_torch.telemetry import perfscope

    telemetry.enable()
    perfscope.enable(rules=perfscope.default_rules())
    ... run the eval loop ...
    print(telemetry.explain_perf(as_text=True))
    with perfscope.profile("trace_dir") as capture:
        evaluator.run(stream)
    print(capture["merged"])   # one host + device Perfetto JSON
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from torcheval_tpu_torch import _flags
from torcheval_tpu_torch.telemetry import events as _events
from torcheval_tpu_torch.telemetry import flightrec as _flightrec

# Module-level flag: hook sites read this as a plain attribute (the
# one-branch zero-overhead contract, see events.ENABLED).
ENABLED: bool = _flags.get("PERFSCOPE")

# How many dispatched engine blocks between SLO evaluations.
DEFAULT_SLO_EVERY_BLOCKS = _flags.INT_FLAGS["PERFSCOPE_SLO_EVERY"][0]

SLO_EVERY_BLOCKS: int = _flags.get_int("PERFSCOPE_SLO_EVERY")

# (program, signature) pairs already priced: the steady-state gate.  A hit
# costs one set lookup, and a failed pricing is not retried every dispatch.
# The ranks of a LocalWorld dispatch from their own threads, so the gate
# takes a lock.
_seen: set = set()
_seen_lock = threading.Lock()

# Installed SLO rules; empty means the evaluator is a no-op.
_rules: Tuple["SloRule", ...] = ()
_last_slo_blocks: int = 0

# The name of the profiler range :func:`profile` aligns the clocks on.
_CLOCK_MARKER = "torcheval_tpu_torch.perfscope.clock"


# ------------------------------------------------------------------- control
def enable(
    *,
    rules: Optional[Tuple["SloRule", ...]] = None,
    slo_every_blocks: Optional[int] = None,
) -> None:
    """Turn perfscope on (equivalently ``TORCHEVAL_TPU_TORCH_PERFSCOPE=1``).
    ``rules`` installs the SLO rule set (see :func:`default_rules`);
    ``slo_every_blocks`` changes the evaluation interval."""
    global ENABLED, SLO_EVERY_BLOCKS, _rules
    if rules is not None:
        _rules = tuple(rules)
    if slo_every_blocks is not None:
        if int(slo_every_blocks) < 1:
            raise ValueError(
                f"slo_every_blocks must be >= 1, got {slo_every_blocks}"
            )
        SLO_EVERY_BLOCKS = int(slo_every_blocks)
    ENABLED = True


def disable() -> None:
    """Turn perfscope off: hook sites go back to one cold branch."""
    global ENABLED
    ENABLED = False


def enabled() -> bool:
    return ENABLED


def reset() -> None:
    """Drop the seen-signature gate, the installed rules and the SLO block
    cursor (a test isolation hook: profile events live in the telemetry
    ring and are cleared by ``telemetry.clear()``)."""
    global _rules, _last_slo_blocks
    with _seen_lock:
        _seen.clear()
    _rules = ()
    _last_slo_blocks = 0


def rules() -> Tuple["SloRule", ...]:
    return _rules


def install_rules(rules: Tuple["SloRule", ...]) -> None:
    """Replace the installed SLO rule set (works before :func:`enable`)."""
    global _rules
    _rules = tuple(rules)


# -------------------------------------------------------------- accounting
def batch_nbytes(tree: Any) -> int:
    """Bytes of the tensor and array leaves of a tree of dicts, lists and
    tuples (one batch: the reread denominator); metadata only."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(batch_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(batch_nbytes(v) for v in tree)
    return int(getattr(tree, "nbytes", 0) or 0)


def _state_leaves(states: Any) -> Dict[Tuple[str, str], torch.Tensor]:
    """``{(member, state): tensor}`` of a ``_read_states()`` mapping."""
    if not isinstance(states, dict):
        return {}
    return {
        (name, s): v
        for name, per in states.items()
        for s, v in per.items()
        if isinstance(v, torch.Tensor)
    }


@dataclass
class Pending:
    """A dispatch being priced: made by :func:`begin` before the dispatch,
    read by :func:`profile_program` after it."""

    program: str
    signature: Any
    device: Optional[torch.device]
    allocated: int = 0


def begin(
    program: str, signature: Any, device: Optional[torch.device] = None
) -> Optional[Pending]:
    """The gate, before a dispatch: ``None`` when ``(program, signature)``
    was priced already (the steady state: one set lookup), else a
    :class:`Pending` for :func:`profile_program`.  On a GPU it marks the
    allocator's live bytes and resets its peak counter, so the dispatch's
    own high-water mark can be read after it.  Only called from hook sites
    after their ``ENABLED`` branch."""
    key = (program, signature)
    with _seen_lock:
        if key in _seen:
            return None
        _seen.add(key)  # a failed pricing is not retried every dispatch
    pending = Pending(program, signature, device)
    if device is not None and device.type == "cuda":
        pending.allocated = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    return pending


def profile_program(
    pending: Pending,
    before: Any,
    after: Any,
    *,
    batch_args: Any = (),
    donate: bool = False,
    written_bytes: int = 0,
) -> Optional[Dict[str, Any]]:
    """Price the dispatch ``pending`` was opened for and emit ONE
    :class:`ProgramProfileEvent`: ``before`` / ``after`` are the states as
    ``_read_states()`` gave them around the dispatch, ``batch_args`` the
    batch it read, ``written_bytes`` what else it wrote (a sharded call's
    merged counts).  The module docstring says how each figure is taken.
    Pricing never breaks a dispatch: a failure gives ``None``."""
    try:
        old = _state_leaves(before)
        new = _state_leaves(after)
        batch = batch_nbytes(batch_args)
        read = sum(batch_nbytes(v) for v in old.values())
        written = sum(batch_nbytes(v) for v in new.values())
        aliased = bool(old) and all(
            key in new and new[key].data_ptr() == v.data_ptr()
            for key, v in old.items()
        )
        argument_bytes = batch + read
        output_bytes = written + int(written_bytes)
        device = pending.device
        if device is not None and device.type == "cuda":
            rise = max(torch.cuda.max_memory_allocated(device) - pending.allocated, 0)
            fresh = sum(
                batch_nbytes(v)
                for key, v in new.items()
                if key not in old or old[key].data_ptr() != v.data_ptr()
            )
            peak_bytes, temp_bytes = rise, max(rise - fresh, 0)
        else:
            peak_bytes, temp_bytes = argument_bytes + output_bytes, 0
        profile = {
            "program": pending.program,
            "flops": 0,
            "bytes_accessed": argument_bytes + output_bytes,
            "peak_bytes": int(peak_bytes),
            "temp_bytes": int(temp_bytes),
            "argument_bytes": int(argument_bytes),
            "output_bytes": int(output_bytes),
            "batch_bytes": int(batch),
            "donated": bool(donate),
            "aliased": aliased,
        }
    except Exception:
        return None
    _events.record_program_profile(**profile)
    from torcheval_tpu_torch import routing_autotune as _autotune

    if _autotune.ENABLED:
        # Feed the measured-cost store: the priced figures become
        # roofline-estimated cost rows the routing layer ranks routes by.
        _autotune.observe_profile(pending.program, batch_args, profile)
    if donate and not aliased:
        # Donation was asked for, but the dispatch wrote new tensors: the
        # in-place state update the flag promises did not happen.
        from torcheval_tpu_torch.routing import warn_route_downgrade

        warn_route_downgrade(
            "donation-verify",
            f"donation is on but the {pending.program!r} dispatch wrote new "
            "state tensors: a member outside the collection kernel's plan "
            "rebinds its states, so not every state kept its storage.",
        )
    return profile


# ------------------------------------------------------------ explain_perf
# Program name -> the span aggregate key measuring its dispatch wall
# clock ((name, phase) in agg["spans"]).
_PROGRAM_TO_SPAN = {
    "fused_collection": ("MetricCollection.fused", "update"),
    "engine_scan": ("Evaluator", "engine_block"),
    # The serve plane's shared group program: dispatch wall clock lands
    # under the EvalService.dispatch span.
    "serve_group": ("EvalService.dispatch", "update"),
    # Kernel-routed builds of the same two hot paths: the dispatch sites
    # time them under the same spans, only the program name differs.
    "mega_collection": ("MetricCollection.fused", "update"),
    "mega_scan": ("Evaluator", "engine_block"),
}

# Collection-kernel program -> the per-member program computing the same
# collection update.  When both were priced in one process, explain_perf
# annotates the kernel row with the per-member reread multiplier and the
# reduction factor.
_MEGA_TO_LEGACY = {
    "mega_collection": "fused_collection",
    "mega_scan": "engine_scan",
}


def explain_perf(
    *, device_kind: Optional[str] = None, as_text: bool = False
) -> Any:
    """The per-route performance report: for every profiled program, its
    byte and memory figures, the reread multiplier, and (when the
    telemetry bus also captured dispatch spans) achieved GB/s and GFLOP/s
    against the device peak table, roofline percentages, and the dispatch
    overhead split (measured wall clock per dispatch beside the
    bandwidth-floor device time).

    Returns a JSON-able dict (``as_text=True`` renders the table via
    :func:`torcheval_tpu_torch.telemetry.export.format_explain_perf`).
    """
    from torcheval_tpu_torch.tools import roofline as _roofline

    peaks = _roofline.device_peaks(device_kind)
    agg = _events.aggregates()
    routes: Dict[str, Dict[str, Any]] = {}
    for program, entry in sorted(agg["perf"].items()):
        profiles = max(entry["profiles"], 1)
        # Per-program means over the priced signatures: a program family
        # (e.g. two bucket shapes) reports the average signature cost.
        flops = entry["flops"] / profiles
        nbytes = entry["bytes_accessed"] / profiles
        batch = entry["batch_bytes"] / profiles
        route: Dict[str, Any] = {
            "profiles": entry["profiles"],
            "flops": flops,
            "bytes_accessed": nbytes,
            "batch_bytes": batch,
            "reread_multiplier": _roofline.reread_multiplier(nbytes, batch),
            "peak_bytes": entry["peak_bytes"],
            "temp_bytes": entry["temp_bytes"],
            "argument_bytes": entry["argument_bytes"],
            "output_bytes": entry["output_bytes"],
            "donated": entry["donated"],
            "aliased": entry["aliased"],
        }
        span = _span_for_program(program, agg)
        if span is not None and span["calls"]:
            wall = span["seconds"] / span["calls"]
            roof = _roofline.roofline(
                flops=flops, bytes_accessed=nbytes, seconds=wall, peaks=peaks
            )
            overhead = max(wall - roof["device_seconds_floor"], 0.0)
            route.update(roof)
            route.update(
                {
                    "dispatches": span["calls"],
                    "wall_seconds_per_dispatch": wall,
                    "dispatch_overhead_seconds": overhead,
                    "dispatch_overhead_pct": 100.0 * overhead / wall
                    if wall
                    else 0.0,
                }
            )
            if roof["hbm_pct"] < 1.0 and roof["flops_pct"] < 1.0:
                route["bound"] = "dispatch"
        routes[program] = route
    for mega, legacy in _MEGA_TO_LEGACY.items():
        if mega in routes and legacy in routes:
            lm = routes[legacy]["reread_multiplier"]
            mm = routes[mega]["reread_multiplier"]
            routes[mega]["legacy_reread_multiplier"] = lm
            if mm > 0:
                routes[mega]["reread_reduction_x"] = lm / mm
    result = {
        "device_kind": peaks["device_kind"],
        "peaks": peaks,
        "routes": routes,
        "alerts": {rule: dict(e) for rule, e in agg["alerts"].items()},
    }
    # Which members run on the rank-sketch tier, at what capacity, and the
    # worst documented epsilon.
    from torcheval_tpu_torch.metrics._rank_state import sketch_census

    census = sketch_census()
    if census:
        result["rank_sketch"] = census
    from torcheval_tpu_torch import routing_autotune as _autotune

    if _autotune.ENABLED:
        # Measured crossover numbers outrank the static estimates: when the
        # cost store has priced or raced BOTH choices of a decision on this
        # device, the stamp names the winner and the measured seconds.
        for decision in ("rank_sketch", "megakernel", "cm_row_chunk"):
            crossover = _autotune.measured_crossover(decision)
            if crossover is None:
                continue
            stamp = {
                "measured_choice": crossover["choice"],
                "measured_seconds": crossover["seconds"],
                "alt_choice": crossover["alt_choice"],
                "alt_seconds": crossover["alt_seconds"],
                "site": crossover["site"],
                "signature": crossover["signature"],
            }
            if decision == "rank_sketch" and census:
                result["rank_sketch"]["measured_crossover"] = stamp
            else:
                result.setdefault("measured_crossovers", {})[decision] = stamp
    if as_text:
        from torcheval_tpu_torch.telemetry.export import format_explain_perf

        return format_explain_perf(result)
    return result


def _span_for_program(
    program: str, agg: Dict[str, Any]
) -> Optional[Dict[str, Any]]:
    """The wall-clock aggregate measuring ``program``'s dispatches: a
    telemetry span for the collection / engine / serve paths, the sync
    entry for ``spmd:<op>`` programs (their dispatch wrapper times the
    call to its end)."""
    if program.startswith("spmd:"):
        return agg["sync"].get(program[len("spmd:"):])
    key = _PROGRAM_TO_SPAN.get(program)
    if key is None:
        return None
    return agg["spans"].get(key)


# ------------------------------------------------------------- SLO alerting
@dataclass(frozen=True)
class SloRule:
    """One declarative threshold rule: fire when ``metric``'s current
    value compares ``op`` (``">"`` or ``"<"``) against ``threshold``.
    ``metric`` names a builtin extractor (:data:`SLO_METRICS`)."""

    name: str
    metric: str
    op: str
    threshold: float
    message: str = ""

    def __post_init__(self) -> None:
        if self.op not in (">", "<"):
            raise ValueError(f"SloRule op must be '>' or '<', got {self.op!r}")
        if self.metric not in SLO_METRICS:
            raise ValueError(
                f"unknown SLO metric {self.metric!r}; expected one of "
                f"{sorted(SLO_METRICS)}"
            )

    def violated(self, value: float) -> bool:
        return value > self.threshold if self.op == ">" else value < self.threshold


def _metric_retrace_total(agg: Dict[str, Any]) -> float:
    return float(sum(agg["retrace"].values()))


def _metric_prefetch_stall_ratio(agg: Dict[str, Any]) -> float:
    blocks = agg["engine"]["blocks"]
    return agg["engine"]["prefetch_stalls"] / blocks if blocks else 0.0


def _metric_sync_imbalance(agg: Dict[str, Any]) -> float:
    """Single-host proxy for collective skew: the slowest op family's
    mean seconds over the fastest's."""
    means = [
        e["seconds"] / e["calls"]
        for e in agg["sync"].values()
        if e["calls"]
    ]
    if len(means) < 2 or min(means) <= 0:
        return 1.0 if means else 0.0
    return max(means) / min(means)


def _metric_data_health_corrupt(agg: Dict[str, Any]) -> float:
    from torcheval_tpu_torch.telemetry.health import CORRUPT_CHECKS

    return float(
        sum(
            entry["count"]
            for (check, _metric), entry in agg["data_health"].items()
            if check in CORRUPT_CHECKS
        )
    )


def _metric_throughput(agg: Dict[str, Any]) -> float:
    """Engine batches per second of measured block-dispatch wall clock
    (0.0 until the first block span lands; floor rules skip then)."""
    span = agg["spans"].get(("Evaluator", "engine_block"))
    if span is None or span["seconds"] <= 0:
        return 0.0
    return agg["engine"]["batches"] / span["seconds"]


def _metric_roofline_pct(agg: Dict[str, Any]) -> float:
    """Best achieved memory-roof percentage across profiled routes with
    measured dispatches (0.0 until both sides exist)."""
    best = 0.0
    from torcheval_tpu_torch.tools import roofline as _roofline

    peaks = _roofline.device_peaks()
    for program, entry in agg["perf"].items():
        span = _span_for_program(program, agg)
        if span is None or not span["calls"]:
            continue
        profiles = max(entry["profiles"], 1)
        wall = span["seconds"] / span["calls"]
        roof = _roofline.roofline(
            flops=entry["flops"] / profiles,
            bytes_accessed=entry["bytes_accessed"] / profiles,
            seconds=wall,
            peaks=peaks,
        )
        best = max(best, roof["hbm_pct"])
    return best


def _metric_quality_min(agg: Dict[str, Any]) -> float:
    """Lowest current quality reading across every (metric, slice,
    window) the monitor has published; ``inf`` until the first reading
    lands, so a ``"<"`` floor rule can never fire on no data."""
    values = [entry["value"] for entry in agg["quality"].values()]
    return min(values) if values else float("inf")


def _metric_quality_worst_drop(agg: Dict[str, Any]) -> float:
    """Largest (lifetime − decayed/window) gap over matching (metric,
    slice) pairs: how far the freshest readings have fallen under the
    run-so-far figure.  0.0 when no windowed reading has a lifetime
    counterpart yet."""
    lifetime = {
        (metric, slice_label): entry["value"]
        for (metric, slice_label, window), entry in agg["quality"].items()
        if window == "lifetime"
    }
    worst = 0.0
    for (metric, slice_label, window), entry in agg["quality"].items():
        if window == "lifetime":
            continue
        base = lifetime.get((metric, slice_label))
        if base is None:
            continue
        worst = max(worst, base - entry["value"])
    return worst


def _metric_serve_shed_rate(agg: Dict[str, Any]) -> float:
    """Shed fraction of the serve layer's admission offers
    (``shed / (admitted + shed)``); 0.0 before any traffic."""
    serve = agg["serve"]
    shed = sum(serve["shed"].values())
    offered = serve["admitted"] + shed
    return shed / offered if offered else 0.0


def _metric_serve_admit_p99(agg: Dict[str, Any]) -> float:
    """Approximate p99 queue wait (seconds) of dispatched serve batches:
    the upper edge of the DURATION_BUCKETS histogram bucket where the
    cumulative count crosses 99% (the overflow bucket reports the last
    edge doubled).  0.0 before the first dispatch."""
    entry = agg["serve"]["dispatched"]
    total = entry["calls"]
    if not total:
        return 0.0
    target = 0.99 * total
    cumulative = 0
    for le, count in zip(_events.DURATION_BUCKETS, entry["hist"]):
        cumulative += count
        if cumulative >= target:
            return le
    return _events.DURATION_BUCKETS[-1] * 2.0


def _tenant_slo_rows(agg: Dict[str, Any]) -> List[Dict[str, Any]]:
    # The live metering ledger when this process meters serve traffic,
    # else the folded TenantSampleEvent rows: the selection every tenant
    # surface uses, so an alert names the tenant the report shows.
    from torcheval_tpu_torch.telemetry import tenants as _tenants

    return _tenants.collect_rows(agg)


def _metric_tenant_wait_p99(agg: Dict[str, Any]) -> float:
    """Worst per-tenant p99 queue wait (seconds) over the tenant metering
    ledger; 0.0 before any metered dispatch."""
    return max(
        (r.get("wait_p99_s", 0.0) for r in _tenant_slo_rows(agg)),
        default=0.0,
    )


def _metric_tenant_shed_rate(agg: Dict[str, Any]) -> float:
    """Worst per-tenant shed fraction (``shed / (admitted + shed)``) over
    the tenant metering ledger; 0.0 before any metered offer."""
    return max(
        (r.get("shed_rate", 0.0) for r in _tenant_slo_rows(agg)),
        default=0.0,
    )


SLO_METRICS: Dict[str, Callable[[Dict[str, Any]], float]] = {
    "retrace_total": _metric_retrace_total,
    "prefetch_stall_ratio": _metric_prefetch_stall_ratio,
    "sync_imbalance": _metric_sync_imbalance,
    "data_health_corrupt": _metric_data_health_corrupt,
    "throughput_batches_per_sec": _metric_throughput,
    "roofline_hbm_pct": _metric_roofline_pct,
    "quality_min": _metric_quality_min,
    "quality_worst_drop": _metric_quality_worst_drop,
    "serve_shed_rate": _metric_serve_shed_rate,
    "serve_admit_p99_s": _metric_serve_admit_p99,
    "tenant_wait_p99_s": _metric_tenant_wait_p99,
    "tenant_shed_rate": _metric_tenant_shed_rate,
}

# Tenant-scope metrics are per-tenant maxima; fired alerts name the argmax
# tenant by appending it to the message (ledger row field here).
_TENANT_METRIC_FIELD = {
    "tenant_wait_p99_s": "wait_p99_s",
    "tenant_shed_rate": "shed_rate",
}

# Floor rules stay quiet until their signal exists at all (a throughput
# floor cannot fire before the first measured block).
_FLOOR_METRICS = frozenset(
    {"throughput_batches_per_sec", "roofline_hbm_pct"}
)


def default_rules(
    *,
    retrace_max: float = 32,
    prefetch_stall_ratio_max: float = 0.5,
    sync_imbalance_max: float = 4.0,
    data_health_corrupt_max: float = 0,
    throughput_floor: float = 0.0,
    roofline_floor_pct: float = 0.0,
    quality_floor: float = 0.0,
    quality_drop_max: float = 0.0,
    serve_shed_rate_max: float = 0.0,
    serve_admit_p99_max_s: float = 0.0,
    tenant_p99_max_s: float = 0.0,
    tenant_shed_rate_max: float = 0.0,
) -> Tuple[SloRule, ...]:
    """A conservative starter rule set; floors default to 0 (disabled:
    pass your workload's numbers).  The rules, names and messages are the
    JAX package's."""
    out = [
        SloRule(
            "retrace_storm",
            "retrace_total",
            ">",
            retrace_max,
            "program (re)traces exceed the budget — the stream is "
            "churning shapes (bucket it, or aot.warmup the sweep)",
        ),
        SloRule(
            "prefetch_starved",
            "prefetch_stall_ratio",
            ">",
            prefetch_stall_ratio_max,
            "the dispatch loop is outrunning the prefetch thread on "
            "most blocks — the host/H2D side is the bottleneck",
        ),
        SloRule(
            "sync_imbalance",
            "sync_imbalance",
            ">",
            sync_imbalance_max,
            "collective op families differ widely in mean wall clock — "
            "check fleet_report() skew for the slow host",
        ),
        SloRule(
            "data_corrupt",
            "data_health_corrupt",
            ">",
            data_health_corrupt_max,
            "the data-health monitor found corrupt input "
            "(NaN/Inf/label-range) — quarantine the feed",
        ),
    ]
    if throughput_floor > 0:
        out.append(
            SloRule(
                "throughput_floor",
                "throughput_batches_per_sec",
                "<",
                throughput_floor,
                "engine throughput fell under the floor",
            )
        )
    if roofline_floor_pct > 0:
        out.append(
            SloRule(
                "roofline_floor",
                "roofline_hbm_pct",
                "<",
                roofline_floor_pct,
                "no route sustains the HBM-utilization floor — the hot "
                "path is dispatch/reread-bound",
            )
        )
    if quality_floor > 0:
        out.append(
            SloRule(
                "quality_floor",
                "quality_min",
                "<",
                quality_floor,
                "a monitored metric (some slice/window) fell under the "
                "quality floor — check report()['quality']['worst_slice'] "
                "and the data-health findings for input drift",
            )
        )
    if quality_drop_max > 0:
        out.append(
            SloRule(
                "quality_drop",
                "quality_worst_drop",
                ">",
                quality_drop_max,
                "a decayed/windowed reading dropped this far below its "
                "lifetime figure — recent quality regressed (cross-check "
                "data_corrupt / data-health drift to separate feed issues "
                "from model issues)",
            )
        )
    if serve_shed_rate_max > 0:
        out.append(
            SloRule(
                "serve_shed_storm",
                "serve_shed_rate",
                ">",
                serve_shed_rate_max,
                "the serve layer is shedding more than the budgeted "
                "fraction of offered batches — raise capacity, widen "
                "queues, or slow the producers",
            )
        )
    if serve_admit_p99_max_s > 0:
        out.append(
            SloRule(
                "serve_admit_latency",
                "serve_admit_p99_s",
                ">",
                serve_admit_p99_max_s,
                "p99 queue wait of dispatched serve batches exceeds the "
                "admit-latency budget — the pump is falling behind "
                "admission",
            )
        )
    if tenant_p99_max_s > 0:
        out.append(
            SloRule(
                "tenant_p99_max",
                "tenant_wait_p99_s",
                ">",
                tenant_p99_max_s,
                "a tenant's p99 queue wait exceeds its latency budget — "
                "check rebalance_hints() / report()['tenants'] for the "
                "noisy neighbour starving it",
            )
        )
    if tenant_shed_rate_max > 0:
        out.append(
            SloRule(
                "tenant_shed_rate_max",
                "tenant_shed_rate",
                ">",
                tenant_shed_rate_max,
                "a tenant is shedding more than its budgeted fraction of "
                "offered batches — rebalance it or widen its queue",
            )
        )
    return tuple(out)


def evaluate_slo(
    rules: Optional[Tuple[SloRule, ...]] = None,
) -> List[Dict[str, Any]]:
    """Evaluate ``rules`` (default: the installed set) against the current
    aggregates; emit one :class:`AlertEvent` per violated rule.  Returns
    the fired findings."""
    active = _rules if rules is None else tuple(rules)
    if not active:
        return []
    agg = _events.aggregates()
    fired: List[Dict[str, Any]] = []
    for rule in active:
        value = SLO_METRICS[rule.metric](agg)
        if rule.metric in _FLOOR_METRICS and value == 0.0:
            continue
        if rule.violated(value):
            message = (
                f"{rule.message or rule.name}: {rule.metric}={value:.4g} "
                f"{rule.op} {rule.threshold:.4g}"
            )
            field = _TENANT_METRIC_FIELD.get(rule.metric)
            if field is not None:
                rows = _tenant_slo_rows(agg)
                worst = max(
                    rows, key=lambda r: r.get(field, 0.0), default=None
                )
                if worst is not None:
                    message += f" (tenant {worst['tenant']!r})"
            _events.record_alert(rule.name, value, rule.threshold, message)
            fired.append(
                {
                    "rule": rule.name,
                    "value": value,
                    "threshold": rule.threshold,
                    "message": message,
                }
            )
    if fired and _flightrec.ENABLED:
        _flightrec.trigger(
            "alert_fired",
            ", ".join(f["rule"] for f in fired),
            extra={"alerts": fired},
        )
    return fired


def maybe_evaluate_slo(blocks_dispatched: int) -> None:
    """Engine hook: run the rule set every :data:`SLO_EVERY_BLOCKS`
    dispatched blocks.  Only called after the ``ENABLED`` branch."""
    global _last_slo_blocks
    if not _rules:
        return
    if blocks_dispatched - _last_slo_blocks >= SLO_EVERY_BLOCKS:
        _last_slo_blocks = blocks_dispatched
        evaluate_slo()


# ------------------------------------------------------- unified timeline
@contextlib.contextmanager
def profile(trace_dir: str, *, merged_name: str = "merged_trace.json"):
    """Capture a ``torch.profiler`` trace (CPU activity, and CUDA activity
    when a GPU is present) around the enclosed block and merge the
    telemetry ring's host spans into it on exit, on the profiler's clock,
    as ONE Perfetto JSON (``<trace_dir>/<merged_name>``).

    Yields a dict filled at exit: ``"merged"`` (the merged trace path),
    ``"device_trace"`` (the profiler's own export), ``"events"``
    (telemetry events merged) and ``"device_events"`` (the profiler's
    GPU kernel events in it; 0 on the CPU).

    Clock alignment: the profiler stamps microseconds on its own base
    (``baseTimeNanoseconds``), the telemetry ring ``time.monotonic()``.
    A marker range (``torcheval_tpu_torch.perfscope.clock``) opened at a
    known monotonic instant is found in the export, and every host event
    is shifted by the difference: the error is the marker's own entry
    time, microseconds.  A profiler that fails to start (a concurrent
    capture) degrades to host spans only; the eval loop never breaks.
    """
    from torch.profiler import ProfilerActivity, record_function
    from torch.profiler import profile as _torch_profile

    os.makedirs(trace_dir, exist_ok=True)
    capture: Dict[str, Any] = {
        "merged": None,
        "device_trace": None,
        "events": 0,
        "device_events": 0,
    }
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = None
    try:
        prof = _torch_profile(activities=activities)
        prof.__enter__()
    except Exception:
        prof = None
    t0 = time.monotonic()
    marker_at = None
    if prof is not None:
        before = time.monotonic()
        with record_function(_CLOCK_MARKER):
            marker_at = 0.5 * (before + time.monotonic())
    ring_start = len(_events.events())
    try:
        yield capture
    finally:
        device_path = None
        if prof is not None:
            try:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                prof.__exit__(None, None, None)
                device_path = os.path.join(trace_dir, "device_trace.json")
                prof.export_chrome_trace(device_path)
            except Exception:
                device_path = None
        try:
            _merge_trace(
                trace_dir, merged_name, t0, marker_at, device_path, ring_start, capture
            )
        except Exception:
            pass


def _merge_trace(
    trace_dir: str,
    merged_name: str,
    t0: float,
    marker_at: Optional[float],
    device_path: Optional[str],
    ring_start: int,
    capture: Dict[str, Any],
) -> None:
    from torcheval_tpu_torch.telemetry.export import to_perfetto

    device_rows: List[Dict[str, Any]] = []
    display_unit = "ms"
    if device_path is not None and os.path.exists(device_path):
        capture["device_trace"] = device_path
        with open(device_path, encoding="utf-8") as fh:
            device = json.load(fh)
        device_rows = device.get("traceEvents", [])
        display_unit = device.get("displayTimeUnit", display_unit)
    marker = next(
        (r for r in device_rows if r.get("name") == _CLOCK_MARKER and "ts" in r),
        None,
    )
    if marker is not None and marker_at is not None:
        # Host events stamp monotonic seconds; shift them onto the
        # profiler's microsecond base through the marker.
        offset_us = float(marker["ts"]) - marker_at * 1e6
    else:
        stamps = [r["ts"] for r in device_rows if "ts" in r]
        offset_us = (min(stamps) if stamps else 0.0) - t0 * 1e6
    host_events = [
        e for e in _events.events()[ring_start:] if e.time_s >= t0
    ]
    capture["events"] = len(host_events)
    capture["device_events"] = sum(
        1 for r in device_rows if r.get("cat") == "kernel"
    )
    pids = [r.get("pid") for r in device_rows]
    host_pid = max((p for p in pids if isinstance(p, int)), default=0) + 1
    host = to_perfetto(
        host_events, pid=host_pid, process_name="torcheval_tpu_torch telemetry"
    )
    for row in host["traceEvents"]:
        if "ts" in row:
            row["ts"] = row["ts"] + offset_us
    merged = {
        "displayTimeUnit": display_unit,
        "traceEvents": device_rows + host["traceEvents"],
    }
    out_path = os.path.join(trace_dir, merged_name)
    with open(out_path, "w", encoding="utf-8") as fh:
        json.dump(merged, fh)
    capture["merged"] = out_path


__all__ = [
    "DEFAULT_SLO_EVERY_BLOCKS",
    "Pending",
    "SLO_METRICS",
    "SloRule",
    "batch_nbytes",
    "begin",
    "default_rules",
    "disable",
    "enable",
    "enabled",
    "evaluate_slo",
    "explain_perf",
    "install_rules",
    "maybe_evaluate_slo",
    "profile",
    "profile_program",
    "reset",
    "rules",
]
