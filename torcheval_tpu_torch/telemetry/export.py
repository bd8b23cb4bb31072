"""Exporters draining the telemetry bus: JSON-lines, Chrome/Perfetto,
Prometheus text format, and the report formatter (the port of
``torcheval_tpu/telemetry/export.py``).

* :func:`export_jsonl` writes one JSON object per captured event;
  :func:`read_jsonl` / :func:`event_from_dict` read a line back into its
  typed event.  The format is the JAX package's, both ways: a dump of
  either package reads in the other.
* :func:`to_perfetto` gives the events as a Chrome/Perfetto trace.
* :func:`prometheus_text` is a text-format snapshot of the aggregate
  counters and histograms, and :func:`serve_prometheus` serves it.  The
  metric families keep the JAX package's ``torcheval_tpu_`` prefix, so a
  dashboard built on one package reads the other.
* :func:`format_report` renders ``telemetry.report()``.
* :func:`format_explain_perf` renders perfscope's ``explain_perf``; the
  Prometheus text carries the per-tenant families of the serve metering
  ledger (``telemetry/tenants.py``).

* :func:`fleet_to_perfetto` merges per-host snapshots
  (``telemetry/aggregate.py``) into one trace, a ``pid`` a host, and
  :func:`format_fleet_report` renders ``telemetry.fleet_report()``.

Live spans in a profiler trace are not a drain:
``telemetry.events.annotate()`` (or
``TORCHEVAL_TPU_TORCH_TELEMETRY_ANNOTATE=1``, or
``telemetry.enable(annotate=True)`` with the bus) opens every span as a
profiler range (``telemetry.events.span``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import io
import json
import math
import os
from typing import Any, Dict, List, Optional, TextIO, Union

from torcheval_tpu_torch.telemetry import events as _events

# The JAX package's metric-family prefix, kept so the two packages' scrapes
# and traces read alike.
_PREFIX = "torcheval_tpu"

# Optional causal-identity fields (telemetry/trace.py): omitted from the
# serialized form when empty so dumps written with tracing off stay
# byte-identical to pre-trace dumps.
_TRACE_FIELDS = ("trace_id", "span_id", "parent_span_id")


# ------------------------------------------------------------------ JSON-lines
def event_to_dict(event: "_events.Event") -> Dict[str, Any]:
    payload = dataclasses.asdict(event)
    for key in _TRACE_FIELDS:
        if not payload.get(key):
            payload.pop(key, None)
    return payload


def event_from_dict(payload: Dict[str, Any]) -> "_events.Event":
    """Rebuild the typed event a JSON line came from (inverse of
    :func:`event_to_dict`)."""
    kind = payload.get("kind")
    cls = _events.KIND_TO_CLASS.get(kind)
    if cls is None:
        raise ValueError(f"unknown telemetry event kind {kind!r}")
    kwargs = {
        k: v
        for k, v in payload.items()
        if k != "kind" and k in _events.event_fields(cls)
    }
    event = cls(**kwargs)
    if event.kind != kind:
        raise ValueError(
            f"payload kind {kind!r} does not match rebuilt {event.kind!r}"
        )
    return event


def export_jsonl(
    target: Union[str, "os.PathLike", TextIO],
    kind: Optional[str] = None,
) -> int:
    """Write every captured event (oldest first, optionally filtered by
    ``kind``) as JSON lines to a path or open text file.  Returns the
    number of events written."""
    snapshot = _events.events(kind)
    if isinstance(target, (str, os.PathLike)):
        with open(target, "w", encoding="utf-8") as fh:
            return _write_jsonl(fh, snapshot)
    return _write_jsonl(target, snapshot)


def _write_jsonl(fh: TextIO, snapshot: List["_events.Event"]) -> int:
    for event in snapshot:
        fh.write(json.dumps(event_to_dict(event), sort_keys=True))
        fh.write("\n")
    return len(snapshot)


def read_jsonl(
    source: Union[str, "os.PathLike", TextIO], *, strict: bool = False
) -> List["_events.Event"]:
    """Parse a JSON-lines dump back into typed events.

    Forward-compatible by default: lines whose ``kind`` this build does
    not know (a dump written by a newer version) are skipped and counted
    into ONE summary warning instead of raising, so old tooling keeps
    loading new reports.  Pass ``strict=True`` to raise on the first
    unknown kind instead.
    """
    if isinstance(source, (str, os.PathLike)):
        with open(source, "r", encoding="utf-8") as fh:
            lines = fh.readlines()
    else:
        lines = source.readlines()
    out: List["_events.Event"] = []
    skipped: Dict[str, int] = {}
    for line in lines:
        if not line.strip():
            continue
        payload = json.loads(line)
        kind = payload.get("kind")
        if not strict and kind not in _events.KIND_TO_CLASS:
            key = str(kind)
            skipped[key] = skipped.get(key, 0) + 1
            continue
        out.append(event_from_dict(payload))
    if skipped:
        import warnings

        detail = ", ".join(
            f"{kind} x{count}" for kind, count in sorted(skipped.items())
        )
        warnings.warn(
            f"read_jsonl skipped {sum(skipped.values())} event(s) of "
            f"unknown kind ({detail}) — written by a newer "
            "torcheval_tpu? Pass strict=True to raise instead.",
            stacklevel=2,
        )
    return out


# -------------------------------------------------------------------- Perfetto
# Kinds that carry a duration → their Chrome trace-event name.  Their
# ``time_s`` stamp is taken at emission (the END of the measured
# interval), so ts = (time_s - seconds) and dur = seconds.
_DURATION_NAME = {
    "span": lambda e: f"{e.name}.{e.phase}",
    # Hierarchical-merge hops render one slice per level
    # ("sync.merge_tree.L2") so the viewer shows the merge depth as
    # nested-looking stacks; flat collectives keep the plain name.
    "sync": lambda e: (
        f"sync.{e.op}.L{e.level}"
        if getattr(e, "level", -1) >= 0
        else f"sync.{e.op}"
    ),
    "prefetch_stall": lambda e: "prefetch_wait",
    # Checkpoint save/restore are timed I/O phases; quarantines carry
    # seconds=0 and render as zero-width slices at the discovery point.
    "checkpoint": lambda e: f"checkpoint.{e.action}",
}


def _perfetto_args(event: "_events.Event") -> Dict[str, Any]:
    return {
        k: v
        for k, v in event_to_dict(event).items()
        if k not in ("kind", "time_s", "thread") and v not in ("", None)
    }


def _flow_id(span_id: str) -> int:
    # Stable across processes (CLI merging dumps from many hosts must
    # agree), unlike the salted builtin ``hash``.
    digest = hashlib.sha1(span_id.encode("utf-8")).digest()
    return int.from_bytes(digest[:6], "big")


def _convert_events(
    events: List["_events.Event"],
    *,
    pid: int,
    process_name: str,
    trace: List[Dict[str, Any]],
    span_slices: Dict[str, Dict[str, Any]],
    flow_links: List[Dict[str, Any]],
) -> None:
    """Append one host's trace events to ``trace``, registering duration
    slices by span id into ``span_slices`` and parent links into
    ``flow_links`` so the caller can resolve flow arrows after every
    host has been converted (cross-host flows resolve in
    :func:`fleet_to_perfetto`)."""
    trace.append(
        {
            "ph": "M",
            "name": "process_name",
            "pid": pid,
            "tid": 0,
            "args": {"name": process_name},
        }
    )
    # Stable tracks: MainThread pins to 0 so the primary dispatch loop
    # always renders first; other threads take 1..n in sorted-name
    # order, independent of event arrival order.
    present = {e.thread or "MainThread" for e in events}
    names = sorted(present - {"MainThread"})
    tids = {"MainThread": 0}
    tids.update({name: i + 1 for i, name in enumerate(names)})
    for name in (["MainThread"] if "MainThread" in present else []) + names:
        trace.append(
            {
                "ph": "M",
                "name": "thread_name",
                "pid": pid,
                "tid": tids[name],
                "args": {"name": name},
            }
        )

    for event in events:
        tid = tids[event.thread or "MainThread"]
        namer = _DURATION_NAME.get(event.kind)
        if namer is not None:
            seconds = float(getattr(event, "seconds", 0.0))
            ts = (event.time_s - seconds) * 1e6
            trace.append(
                {
                    "ph": "X",
                    "name": namer(event),
                    "cat": event.kind,
                    "ts": ts,
                    "dur": seconds * 1e6,
                    "pid": pid,
                    "tid": tid,
                    "args": _perfetto_args(event),
                }
            )
            sid = getattr(event, "span_id", "")
            if sid and sid not in span_slices:
                span_slices[sid] = {"ts": ts, "pid": pid, "tid": tid}
            parent = getattr(event, "parent_span_id", "")
            if sid and parent:
                flow_links.append(
                    {
                        "span_id": sid,
                        "parent_span_id": parent,
                        "ts": ts,
                        "pid": pid,
                        "tid": tid,
                    }
                )
        else:
            trace.append(
                {
                    "ph": "i",
                    "name": event.kind,
                    "cat": event.kind,
                    "ts": event.time_s * 1e6,
                    "pid": pid,
                    "tid": tid,
                    "s": "t",
                    "args": _perfetto_args(event),
                }
            )


def _flow_events(
    span_slices: Dict[str, Dict[str, Any]],
    flow_links: List[Dict[str, Any]],
) -> List[Dict[str, Any]]:
    """Flow arrows (``ph:"s"`` at the parent slice, ``ph:"f"`` binding
    to the enclosing child slice) for every parent link whose parent
    span has a slice in the converted sample.  Dangling links (parent
    rotated out of the ring, or on an unsampled host) are silently
    skipped — the output stays schema-valid with or without trace
    context."""
    flows: List[Dict[str, Any]] = []
    for link in flow_links:
        parent = span_slices.get(link["parent_span_id"])
        if parent is None:
            continue
        fid = _flow_id(link["span_id"])
        flows.append(
            {
                "ph": "s",
                "id": fid,
                "name": "causal",
                "cat": "trace",
                "ts": parent["ts"],
                "pid": parent["pid"],
                "tid": parent["tid"],
            }
        )
        flows.append(
            {
                "ph": "f",
                "bp": "e",
                "id": fid,
                "name": "causal",
                "cat": "trace",
                "ts": link["ts"],
                "pid": link["pid"],
                "tid": link["tid"],
            }
        )
    return flows


def to_perfetto(
    events: Optional[List["_events.Event"]] = None,
    *,
    pid: int = 0,
    process_name: Optional[str] = None,
) -> Dict[str, Any]:
    """Convert captured events into a Chrome/Perfetto trace-event JSON
    object (load the dumped dict straight into ``ui.perfetto.dev``).

    Timed kinds (metric spans, collective syncs, checkpoint saves and
    loads) become complete events (``ph:"X"`` with microsecond
    ``ts``/``dur``); every other kind becomes a thread-scoped instant
    (``ph:"i"``).  Tracks separate by emitting thread (``tid``: each
    ``LocalWorld`` rank is a thread).  Events stamped with trace context
    (:mod:`torcheval_tpu_torch.telemetry.trace`) additionally get flow arrows
    (``ph:"s"``/``ph:"f"``) from each parent slice to its children, so
    the viewer draws the causal chain across threads.

    ``events=None`` drains the live ring buffer.
    """
    if events is None:
        events = _events.events()
    trace: List[Dict[str, Any]] = []
    span_slices: Dict[str, Dict[str, Any]] = {}
    flow_links: List[Dict[str, Any]] = []
    if process_name is None:
        process_name = f"{_PREFIX} host {pid}"
    _convert_events(
        events,
        pid=pid,
        process_name=process_name,
        trace=trace,
        span_slices=span_slices,
        flow_links=flow_links,
    )
    trace.extend(_flow_events(span_slices, flow_links))
    return {"traceEvents": trace, "displayTimeUnit": "ms"}


def fleet_to_perfetto(snapshots: List[Dict[str, Any]]) -> Dict[str, Any]:
    """One merged Perfetto trace over per-host snapshots (from
    :func:`torcheval_tpu_torch.telemetry.aggregate.host_snapshot`): each host
    becomes a ``pid`` whose process row is named after it, threads
    within a host keep their own tracks, and flow arrows resolve ACROSS
    hosts (a fleet-merge child span on rank 3 draws its arrow from the
    parent's slice on rank 1).  Unknown event kinds in a snapshot's
    sample are skipped (forward compatibility, as
    :func:`read_jsonl`)."""
    merged: List[Dict[str, Any]] = []
    span_slices: Dict[str, Dict[str, Any]] = {}
    flow_links: List[Dict[str, Any]] = []
    for snapshot in snapshots:
        host = snapshot.get("host", {})
        pid = int(host.get("process_index", 0))
        name = f"host {pid} ({host.get('hostname', '?')})"
        events = [
            event_from_dict(payload)
            for payload in snapshot.get("events", [])
            if payload.get("kind") in _events.KIND_TO_CLASS
        ]
        _convert_events(
            events,
            pid=pid,
            process_name=name,
            trace=merged,
            span_slices=span_slices,
            flow_links=flow_links,
        )
    merged.extend(_flow_events(span_slices, flow_links))
    return {"traceEvents": merged, "displayTimeUnit": "ms"}


# ------------------------------------------------------------------ Prometheus
def _label_escape(value: str) -> str:
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _labels(**labels: Any) -> str:
    inner = ",".join(
        f'{k}="{_label_escape(v)}"' for k, v in labels.items()
    )
    return f"{{{inner}}}" if inner else ""


def _fmt(value: float) -> str:
    # Prometheus floats: integers render without the trailing .0 noise.
    # NaN/Inf (a 0/0 quality reading) render as Go-parseable literals.
    value = float(value)
    if not math.isfinite(value):
        return repr(value)
    if value == int(value):
        return str(int(value))
    return repr(value)


def _histogram_lines(
    out: List[str], family: str, labels: Dict[str, Any], entry: Dict[str, Any]
) -> None:
    cumulative = 0
    for le, count in zip(_events.DURATION_BUCKETS, entry["hist"]):
        cumulative += count
        out.append(
            f"{family}_bucket{_labels(**labels, le=_fmt(le))} {cumulative}"
        )
    cumulative += entry["hist"][-1]
    out.append(f'{family}_bucket{_labels(**labels, le="+Inf")} {cumulative}')
    out.append(f"{family}_sum{_labels(**labels)} {_fmt(entry['seconds'])}")
    out.append(f"{family}_count{_labels(**labels)} {entry['calls']}")


def prometheus_text() -> str:
    """Text-format (version 0.0.4) snapshot of the aggregate counters and
    duration histograms.  Labels carry only low-cardinality dimensions
    (event program/kind/op/bucket/phase) — callsites stay in the
    JSON-lines feed and :func:`torcheval_tpu_torch.telemetry.report`."""
    agg = _events.aggregates()
    out: List[str] = []

    out.append(
        f"# HELP {_PREFIX}_telemetry_events_total "
        "Events captured by the telemetry bus since the last clear."
    )
    out.append(f"# TYPE {_PREFIX}_telemetry_events_total counter")
    out.append(f"{_PREFIX}_telemetry_events_total {agg['emitted']}")
    out.append(
        f"# TYPE {_PREFIX}_telemetry_events_dropped_total counter"
    )
    out.append(
        f"{_PREFIX}_telemetry_events_dropped_total {_events.dropped()}"
    )
    out.append(
        f"# HELP {_PREFIX}_events_dropped_total Ring evictions by the "
        "kind of the evicted event (which signal the bounded buffer is "
        "losing)."
    )
    out.append(f"# TYPE {_PREFIX}_events_dropped_total counter")
    for kind, count in sorted(_events.dropped_by_kind().items()):
        out.append(
            f"{_PREFIX}_events_dropped_total{_labels(kind=kind)} {count}"
        )

    out.append(
        f"# HELP {_PREFIX}_retrace_total Update-program traces by program "
        "kind (each one is a compile)."
    )
    out.append(f"# TYPE {_PREFIX}_retrace_total counter")
    per_program: Dict[str, int] = {}
    for (program, _callsite), count in agg["retrace"].items():
        per_program[program] = per_program.get(program, 0) + count
    for program, count in sorted(per_program.items()):
        out.append(
            f"{_PREFIX}_retrace_total{_labels(program=program)} {count}"
        )

    out.append(
        f"# HELP {_PREFIX}_spmd_cache_total Sharded-program memoizer "
        "lookups by result."
    )
    out.append(f"# TYPE {_PREFIX}_spmd_cache_total counter")
    out.append(
        f"{_PREFIX}_spmd_cache_total{_labels(result='hit')} "
        f"{agg['cache']['hits']}"
    )
    out.append(
        f"{_PREFIX}_spmd_cache_total{_labels(result='miss')} "
        f"{agg['cache']['misses']}"
    )
    out.append(
        f"{_PREFIX}_spmd_cache_total{_labels(result='evict')} "
        f"{agg['cache']['evictions']}"
    )

    out.append(
        f"# HELP {_PREFIX}_route_downgrade_total Call-time fast-path "
        "downgrades by route kind."
    )
    out.append(f"# TYPE {_PREFIX}_route_downgrade_total counter")
    per_kind: Dict[str, int] = {}
    for (route_kind, _callsite), count in agg["route_downgrade"].items():
        per_kind[route_kind] = per_kind.get(route_kind, 0) + count
    for route_kind, count in sorted(per_kind.items()):
        out.append(
            f"{_PREFIX}_route_downgrade_total{_labels(kind=route_kind)} "
            f"{count}"
        )

    out.append(
        f"# HELP {_PREFIX}_bucket_pad_rows_total Rows through the ragged "
        "bucketing pad by bucket and validity."
    )
    out.append(f"# TYPE {_PREFIX}_bucket_pad_rows_total counter")
    for bucket in sorted(agg["bucket_pad"]):
        entry = agg["bucket_pad"][bucket]
        out.append(
            f"{_PREFIX}_bucket_pad_rows_total"
            f"{_labels(bucket=bucket, status='valid')} "
            f"{entry['rows_valid']}"
        )
        out.append(
            f"{_PREFIX}_bucket_pad_rows_total"
            f"{_labels(bucket=bucket, status='padded')} "
            f"{entry['rows_padded']}"
        )

    out.append(
        f"# HELP {_PREFIX}_donation_total Donated-buffer aborts and "
        "default restores on the fused update paths."
    )
    out.append(f"# TYPE {_PREFIX}_donation_total counter")
    for action in sorted(agg["donation"]):
        out.append(
            f"{_PREFIX}_donation_total{_labels(action=action)} "
            f"{agg['donation'][action]}"
        )

    out.append(
        f"# HELP {_PREFIX}_engine_blocks_total Scan-fused blocks "
        "dispatched by the streaming engine (one host dispatch each)."
    )
    out.append(f"# TYPE {_PREFIX}_engine_blocks_total counter")
    out.append(f"{_PREFIX}_engine_blocks_total {agg['engine']['blocks']}")
    out.append(
        f"# HELP {_PREFIX}_engine_batches_total Real batches folded into "
        "scan-fused engine blocks."
    )
    out.append(f"# TYPE {_PREFIX}_engine_batches_total counter")
    out.append(f"{_PREFIX}_engine_batches_total {agg['engine']['batches']}")
    out.append(f"# TYPE {_PREFIX}_engine_pad_steps_total counter")
    out.append(
        f"{_PREFIX}_engine_pad_steps_total {agg['engine']['pad_steps']}"
    )
    out.append(
        f"# HELP {_PREFIX}_engine_prefetch_stall_total Engine dispatch "
        "loop blocked on an empty prefetch queue (pipeline bubbles)."
    )
    out.append(f"# TYPE {_PREFIX}_engine_prefetch_stall_total counter")
    out.append(
        f"{_PREFIX}_engine_prefetch_stall_total "
        f"{agg['engine']['prefetch_stalls']}"
    )
    out.append(
        f"# TYPE {_PREFIX}_engine_prefetch_stall_seconds_total counter"
    )
    out.append(
        f"{_PREFIX}_engine_prefetch_stall_seconds_total "
        f"{_fmt(agg['engine']['stall_seconds'])}"
    )

    out.append(
        f"# HELP {_PREFIX}_data_health_total Offending elements/batches "
        "found by the data-health monitor, by check and attributed metric."
    )
    out.append(f"# TYPE {_PREFIX}_data_health_total counter")
    for check, metric in sorted(agg["data_health"]):
        entry = agg["data_health"][(check, metric)]
        out.append(
            f"{_PREFIX}_data_health_total"
            f"{_labels(check=check, metric=metric)} "
            f"{entry['count']}"
        )

    res = agg["resilience"]
    out.append(
        f"# HELP {_PREFIX}_retry_attempts_total Failed-and-retried "
        "attempts of resilient operations, by op."
    )
    out.append(f"# TYPE {_PREFIX}_retry_attempts_total counter")
    for op in sorted(res["retries"]):
        out.append(
            f"{_PREFIX}_retry_attempts_total{_labels(op=op)} "
            f"{res['retries'][op]['attempts']}"
        )

    out.append(
        f"# HELP {_PREFIX}_degraded_total Resilience fallbacks served "
        "(e.g. local view after exhausted collective retries), by op "
        "and fallback."
    )
    out.append(f"# TYPE {_PREFIX}_degraded_total counter")
    for op, fallback in sorted(res["degraded"]):
        out.append(
            f"{_PREFIX}_degraded_total"
            f"{_labels(op=op, fallback=fallback)} "
            f"{res['degraded'][(op, fallback)]}"
        )

    out.append(
        f"# HELP {_PREFIX}_checkpoint_total Durable-checkpoint lifecycle "
        "steps (save/restore/quarantine)."
    )
    out.append(f"# TYPE {_PREFIX}_checkpoint_total counter")
    for action in sorted(res["checkpoint"]):
        out.append(
            f"{_PREFIX}_checkpoint_total{_labels(action=action)} "
            f"{res['checkpoint'][action]['count']}"
        )
    out.append(f"# TYPE {_PREFIX}_checkpoint_seconds_total counter")
    for action in sorted(res["checkpoint"]):
        out.append(
            f"{_PREFIX}_checkpoint_seconds_total{_labels(action=action)} "
            f"{_fmt(res['checkpoint'][action]['seconds'])}"
        )

    out.append(
        f"# HELP {_PREFIX}_sync_seconds Collective merge wall time by op."
    )
    out.append(f"# TYPE {_PREFIX}_sync_seconds histogram")
    for op in sorted(agg["sync"]):
        _histogram_lines(
            out, f"{_PREFIX}_sync_seconds", {"op": op}, agg["sync"][op]
        )
    out.append(
        f"# TYPE {_PREFIX}_sync_payload_bytes_total counter"
    )
    for op in sorted(agg["sync"]):
        out.append(
            f"{_PREFIX}_sync_payload_bytes_total{_labels(op=op)} "
            f"{agg['sync'][op]['payload_bytes']}"
        )

    out.append(
        f"# HELP {_PREFIX}_merge_level_seconds Hierarchical fleet-merge "
        "hop wall time by op and tree/ring level (1 = leaf hop)."
    )
    out.append(f"# TYPE {_PREFIX}_merge_level_seconds histogram")
    for op, level in sorted(agg["merge_levels"]):
        _histogram_lines(
            out,
            f"{_PREFIX}_merge_level_seconds",
            {"op": op, "level": level},
            agg["merge_levels"][(op, level)],
        )
    out.append(
        f"# TYPE {_PREFIX}_merge_level_payload_bytes_total counter"
    )
    for op, level in sorted(agg["merge_levels"]):
        out.append(
            f"{_PREFIX}_merge_level_payload_bytes_total"
            f"{_labels(op=op, level=level)} "
            f"{agg['merge_levels'][(op, level)]['payload_bytes']}"
        )

    out.append(
        f"# HELP {_PREFIX}_span_seconds Metric phase wall time by metric "
        "and phase."
    )
    out.append(f"# TYPE {_PREFIX}_span_seconds histogram")
    for name, phase in sorted(agg["spans"]):
        _histogram_lines(
            out,
            f"{_PREFIX}_span_seconds",
            {"metric": name, "phase": phase},
            agg["spans"][(name, phase)],
        )
    out.append(
        f"# HELP {_PREFIX}_span_state_bytes Last observed state-memory "
        "footprint by metric and phase."
    )
    out.append(f"# TYPE {_PREFIX}_span_state_bytes gauge")
    for name, phase in sorted(agg["spans"]):
        out.append(
            f"{_PREFIX}_span_state_bytes"
            f"{_labels(metric=name, phase=phase)} "
            f"{agg['spans'][(name, phase)]['state_bytes']}"
        )

    if agg["perf"]:
        out.append(
            f"# HELP {_PREFIX}_program_flops_total XLA cost-analysis "
            "FLOPs summed over priced signatures, by program "
            "(perfscope)."
        )
        out.append(f"# TYPE {_PREFIX}_program_flops_total counter")
        for program in sorted(agg["perf"]):
            out.append(
                f"{_PREFIX}_program_flops_total"
                f"{_labels(program=program)} "
                f"{agg['perf'][program]['flops']}"
            )
        out.append(
            f"# HELP {_PREFIX}_program_bytes_accessed_total XLA "
            "cost-analysis bytes-accessed summed over priced "
            "signatures, by program (perfscope)."
        )
        out.append(
            f"# TYPE {_PREFIX}_program_bytes_accessed_total counter"
        )
        for program in sorted(agg["perf"]):
            out.append(
                f"{_PREFIX}_program_bytes_accessed_total"
                f"{_labels(program=program)} "
                f"{agg['perf'][program]['bytes_accessed']}"
            )
        out.append(
            f"# HELP {_PREFIX}_program_peak_bytes Largest "
            "memory-analysis peak over priced signatures, by program."
        )
        out.append(f"# TYPE {_PREFIX}_program_peak_bytes gauge")
        for program in sorted(agg["perf"]):
            out.append(
                f"{_PREFIX}_program_peak_bytes"
                f"{_labels(program=program)} "
                f"{agg['perf'][program]['peak_bytes']}"
            )

    if agg["quality"]:
        # Grafana-ready live model-quality gauges from the monitor
        # (torcheval_tpu/monitor): one series per (metric, slice,
        # window), slice="" for the global figure.  Sorted keys keep
        # family/label ordering stable across scrapes.
        out.append(
            f"# HELP {_PREFIX}_quality Last model-quality reading from "
            "the live monitor, by metric, slice, and window kind."
        )
        out.append(f"# TYPE {_PREFIX}_quality gauge")
        for metric, slice_label, window in sorted(agg["quality"]):
            entry = agg["quality"][(metric, slice_label, window)]
            out.append(
                f"{_PREFIX}_quality"
                f"{_labels(metric=metric, slice=slice_label, window=window)} "
                f"{_fmt(entry['value'])}"
            )
        out.append(
            f"# HELP {_PREFIX}_quality_readings_total Quality readings "
            "published since the last clear, by metric, slice, and "
            "window kind."
        )
        out.append(f"# TYPE {_PREFIX}_quality_readings_total counter")
        for metric, slice_label, window in sorted(agg["quality"]):
            entry = agg["quality"][(metric, slice_label, window)]
            out.append(
                f"{_PREFIX}_quality_readings_total"
                f"{_labels(metric=metric, slice=slice_label, window=window)} "
                f"{entry['count']}"
            )

    out.append(
        f"# HELP {_PREFIX}_alerts_total SLO rule violations recorded by "
        "the perfscope alert evaluator, by rule."
    )
    out.append(f"# TYPE {_PREFIX}_alerts_total counter")
    for rule in sorted(agg["alerts"]):
        out.append(
            f"{_PREFIX}_alerts_total{_labels(rule=rule)} "
            f"{agg['alerts'][rule]['count']}"
        )

    if agg["route_decisions"]:
        out.append(
            f"# HELP {_PREFIX}_route_decisions_total Routing decisions "
            "resolved by the measured-cost layer (routing_autotune), by "
            "picked route and verdict."
        )
        out.append(f"# TYPE {_PREFIX}_route_decisions_total counter")
        for decision, route, verdict in sorted(agg["route_decisions"]):
            entry = agg["route_decisions"][(decision, route, verdict)]
            out.append(
                f"{_PREFIX}_route_decisions_total"
                f"{_labels(route=f'{decision}:{route}', verdict=verdict)} "
                f"{entry['count']}"
            )

    srv = agg["serve"]
    if (
        srv["admitted"]
        or srv["shed"]
        or srv["rejected"]
        or srv["quarantined"]
        or srv["sessions"]
        or srv["dispatched"]["calls"]
    ):
        out.append(
            f"# HELP {_PREFIX}_serve_admission_total Multi-tenant "
            "admission decisions by outcome and shed/reject reason."
        )
        out.append(f"# TYPE {_PREFIX}_serve_admission_total counter")
        out.append(
            f"{_PREFIX}_serve_admission_total"
            f"{_labels(outcome='admitted', reason='')} "
            f"{srv['admitted']}"
        )
        for reason in sorted(srv["shed"]):
            out.append(
                f"{_PREFIX}_serve_admission_total"
                f"{_labels(outcome='shed', reason=reason)} "
                f"{srv['shed'][reason]}"
            )
        for reason in sorted(srv["rejected"]):
            out.append(
                f"{_PREFIX}_serve_admission_total"
                f"{_labels(outcome='rejected', reason=reason)} "
                f"{srv['rejected'][reason]}"
            )
        out.append(
            f"# HELP {_PREFIX}_serve_admit_wait_seconds Queue wait of "
            "dispatched batches (admit latency; the p99 SLO rule's "
            "source)."
        )
        out.append(f"# TYPE {_PREFIX}_serve_admit_wait_seconds histogram")
        dispatched = srv["dispatched"]
        _histogram_lines(
            out,
            f"{_PREFIX}_serve_admit_wait_seconds",
            {},
            {
                "hist": dispatched["hist"],
                "seconds": dispatched["wait_seconds"],
                "calls": dispatched["calls"],
            },
        )
        out.append(
            f"# HELP {_PREFIX}_serve_quarantine_total Poison tenants "
            "isolated by the serve layer."
        )
        out.append(f"# TYPE {_PREFIX}_serve_quarantine_total counter")
        out.append(
            f"{_PREFIX}_serve_quarantine_total {srv['quarantined']}"
        )
        out.append(
            f"# HELP {_PREFIX}_serve_sessions_total Tenant-session "
            "lifecycle steps (open/spill/resume/close/drain)."
        )
        out.append(f"# TYPE {_PREFIX}_serve_sessions_total counter")
        for action in sorted(srv["sessions"]):
            out.append(
                f"{_PREFIX}_serve_sessions_total{_labels(action=action)} "
                f"{srv['sessions'][action]}"
            )

    from torcheval_tpu_torch.telemetry import tenants as _tenants

    tenant_rows = _tenants.capped_rows(_tenants.collect_rows(agg))
    if tenant_rows:
        # Tenant-labeled families off the metering ledger.  Cardinality
        # is bounded by design: past TENANT_SERIES_CAP tenants the tail
        # folds into one __other__ series, and tenant ids pass through
        # tenant_label (printable) + _label_escape (quoting).
        rows = sorted(tenant_rows, key=lambda r: r["tenant"])
        out.append(
            f"# HELP {_PREFIX}_tenant_admission_total Per-tenant "
            "admission outcomes from the serve metering ledger."
        )
        out.append(f"# TYPE {_PREFIX}_tenant_admission_total counter")
        for row in rows:
            label = _tenants.tenant_label(row["tenant"])
            for outcome in ("admitted", "shed", "rejected"):
                out.append(
                    f"{_PREFIX}_tenant_admission_total"
                    f"{_labels(tenant=label, outcome=outcome)} "
                    f"{row.get(outcome, 0)}"
                )
        out.append(
            f"# HELP {_PREFIX}_tenant_dispatched_total Batches executed "
            "per tenant through the shared group programs."
        )
        out.append(f"# TYPE {_PREFIX}_tenant_dispatched_total counter")
        for row in rows:
            out.append(
                f"{_PREFIX}_tenant_dispatched_total"
                f"{_labels(tenant=_tenants.tenant_label(row['tenant']))} "
                f"{row.get('dispatched', 0)}"
            )
        out.append(
            f"# HELP {_PREFIX}_tenant_rows_total Valid batch rows "
            "dispatched per tenant (the attribution weight)."
        )
        out.append(f"# TYPE {_PREFIX}_tenant_rows_total counter")
        for row in rows:
            out.append(
                f"{_PREFIX}_tenant_rows_total"
                f"{_labels(tenant=_tenants.tenant_label(row['tenant']))} "
                f"{row.get('rows', 0)}"
            )
        out.append(
            f"# HELP {_PREFIX}_tenant_payload_bytes_total Admitted batch "
            "payload bytes per tenant."
        )
        out.append(f"# TYPE {_PREFIX}_tenant_payload_bytes_total counter")
        for row in rows:
            out.append(
                f"{_PREFIX}_tenant_payload_bytes_total"
                f"{_labels(tenant=_tenants.tenant_label(row['tenant']))} "
                f"{row.get('payload_bytes', 0)}"
            )
        out.append(
            f"# HELP {_PREFIX}_tenant_device_seconds_total Attributed "
            "device time per tenant: each shared program's priced "
            "seconds split by valid-row share."
        )
        out.append(
            f"# TYPE {_PREFIX}_tenant_device_seconds_total counter"
        )
        for row in rows:
            out.append(
                f"{_PREFIX}_tenant_device_seconds_total"
                f"{_labels(tenant=_tenants.tenant_label(row['tenant']))} "
                f"{_fmt(row.get('device_seconds', 0.0))}"
            )
        out.append(
            f"# HELP {_PREFIX}_tenant_queue_depth Queued batches per "
            "tenant at the last metering observation."
        )
        out.append(f"# TYPE {_PREFIX}_tenant_queue_depth gauge")
        for row in rows:
            out.append(
                f"{_PREFIX}_tenant_queue_depth"
                f"{_labels(tenant=_tenants.tenant_label(row['tenant']))} "
                f"{row.get('queue_depth', 0)}"
            )
        out.append(
            f"# HELP {_PREFIX}_tenant_wait_seconds Per-tenant queue-wait "
            "quantiles (StreamDigest ladder)."
        )
        out.append(f"# TYPE {_PREFIX}_tenant_wait_seconds gauge")
        for row in rows:
            label = _tenants.tenant_label(row["tenant"])
            for q, field in (("0.5", "wait_p50_s"), ("0.99", "wait_p99_s")):
                out.append(
                    f"{_PREFIX}_tenant_wait_seconds"
                    f"{_labels(tenant=label, quantile=q)} "
                    f"{_fmt(row.get(field, 0.0))}"
                )
        out.append(
            f"# HELP {_PREFIX}_tenant_e2e_seconds Per-tenant "
            "submit-to-result latency quantiles."
        )
        out.append(f"# TYPE {_PREFIX}_tenant_e2e_seconds gauge")
        for row in rows:
            label = _tenants.tenant_label(row["tenant"])
            for q, field in (("0.5", "e2e_p50_s"), ("0.99", "e2e_p99_s")):
                out.append(
                    f"{_PREFIX}_tenant_e2e_seconds"
                    f"{_labels(tenant=label, quantile=q)} "
                    f"{_fmt(row.get(field, 0.0))}"
                )
        out.append(
            f"# HELP {_PREFIX}_tenant_session_churn_total Spill/resume "
            "steps per tenant (placement churn)."
        )
        out.append(f"# TYPE {_PREFIX}_tenant_session_churn_total counter")
        for row in rows:
            label = _tenants.tenant_label(row["tenant"])
            for action in ("spills", "resumes"):
                out.append(
                    f"{_PREFIX}_tenant_session_churn_total"
                    f"{_labels(tenant=label, action=action)} "
                    f"{row.get(action, 0)}"
                )
        dominant = [r for r in rows if r.get("dominant_program")]
        if dominant:
            out.append(
                f"# HELP {_PREFIX}_tenant_dominant_share Device-time "
                "share of a shared program held by its dominant tenant "
                "(the noisy-neighbour verdict)."
            )
            out.append(f"# TYPE {_PREFIX}_tenant_dominant_share gauge")
            for row in dominant:
                out.append(
                    f"{_PREFIX}_tenant_dominant_share"
                    f"{_labels(tenant=_tenants.tenant_label(row['tenant']), program=row['dominant_program'])} "
                    f"{_fmt(row.get('dominant_share', 0.0))}"
                )
        folded = next(
            (
                r["folded_tenants"]
                for r in rows
                if r["tenant"] == _tenants.OTHER_LABEL
                and "folded_tenants" in r
            ),
            0,
        )
        if folded:
            out.append(
                f"# HELP {_PREFIX}_tenant_series_folded Tenants folded "
                "into the __other__ series by the cardinality cap."
            )
            out.append(f"# TYPE {_PREFIX}_tenant_series_folded gauge")
            out.append(f"{_PREFIX}_tenant_series_folded {folded}")

    return "\n".join(out) + "\n"


# ------------------------------------------------------------- pull endpoint
def serve_prometheus(port: int = 9464, *, host: str = "127.0.0.1"):
    """Serve :func:`prometheus_text` on ``http://host:port/metrics`` from
    a stdlib ``http.server`` daemon thread — the pull endpoint that makes
    a fleet of evaluators scrapeable live (point a Prometheus
    ``scrape_config`` at each host).

    Every scrape renders a fresh snapshot of the live aggregates; no
    state is retained per request.  Returns the started server (its
    ``server_port`` reports the bound port when ``port=0``); call
    ``.shutdown()`` to stop it.  ``/`` answers 200 for liveness probes;
    other paths 404.
    """
    import http.server
    import threading

    class _Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802  (http.server naming)
            if self.path.split("?")[0] not in ("/metrics", "/"):
                self.send_error(404)
                return
            body = prometheus_text().encode("utf-8")
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, format, *args):  # noqa: A002
            pass  # scrapes must not spam the evaluator's stderr

    server = http.server.ThreadingHTTPServer((host, port), _Handler)
    thread = threading.Thread(
        target=server.serve_forever,
        name="torcheval-tpu-prometheus",
        daemon=True,
    )
    thread.start()
    return server


# --------------------------------------------------------------------- report
def format_report(report: Dict[str, Any]) -> str:
    """Render :func:`torcheval_tpu_torch.telemetry.report`'s dict (or the
    JAX package's) as the human-readable health summary."""
    buf = io.StringIO()
    state = "ENABLED" if report.get("enabled") else "disabled"
    buf.write(f"torcheval_tpu telemetry ({state})\n")
    flags = report.get("flags", {})
    if flags:
        rendered = ", ".join(
            f"{name}={value!r}" for name, value in sorted(flags.items())
        )
        buf.write(f"  flags (non-default): {rendered}\n")
    # The port traces no program and caches none: its report has neither
    # section, a JAX report both.
    if "trace_counts" in report:
        tc = report["trace_counts"]
        buf.write(
            f"  traces built: {sum(tc.values())} "
            f"({', '.join(f'{k}={v}' for k, v in sorted(tc.items())) or 'none'})\n"
        )
    if "spmd_cache" in report:
        cache = report["spmd_cache"]
        buf.write(
            f"  spmd cache: {cache.get('hits', 0)} hits / "
            f"{cache.get('misses', 0)} misses "
            f"(hit rate {cache.get('hit_rate', 0.0):.2f}, "
            f"{cache.get('currsize', 0)} live programs, "
            f"{cache.get('evictions', 0)} evictions)\n"
        )
    offenders = report.get("retrace", {}).get("top_offenders", [])
    if offenders:
        buf.write("  top retrace offenders:\n")
        for item in offenders:
            buf.write(
                f"    {item['count']:>4}x {item['program']} @ "
                f"{item['callsite']}\n"
            )
    pad = report.get("bucket_pad", {})
    if pad.get("per_bucket"):
        buf.write(
            f"  bucket padding: {pad['rows_padded']} padded / "
            f"{pad['rows_valid']} valid rows "
            f"(waste {pad['waste_pct']:.1f}%)\n"
        )
        for bucket, entry in sorted(pad["per_bucket"].items()):
            buf.write(
                f"    bucket {bucket}: {entry['rows_padded']} padded / "
                f"{entry['rows_valid']} valid over {entry['calls']} calls "
                f"(waste {entry['waste_pct']:.1f}%)\n"
            )
    downs = report.get("route_downgrades", {})
    if downs.get("total"):
        by_kind = ", ".join(
            f"{k}={v}" for k, v in sorted(downs["by_kind"].items())
        )
        buf.write(f"  route downgrades: {downs['total']} ({by_kind})\n")
    donation = report.get("donation", {})
    if donation.get("abort") or donation.get("restore"):
        buf.write(
            f"  donation: {donation.get('abort', 0)} aborts, "
            f"{donation.get('restore', 0)} default restores\n"
        )
    eng = report.get("engine", {})
    if eng.get("blocks"):
        buf.write(
            f"  engine: {eng['blocks']} block dispatches over "
            f"{eng['batches']} batches "
            f"({eng['dispatches_per_batch']:.3f} dispatches/batch, "
            f"{eng['pad_steps']} pad steps); "
            f"{eng['prefetch_stalls']} prefetch stalls "
            f"({eng['stall_seconds'] * 1e3:.3f} ms)\n"
        )
    health = report.get("data_health", {})
    if health.get("findings"):
        buf.write(
            f"  DATA HEALTH: {health['findings']} offending "
            f"elements/batches over {health['events']} findings\n"
        )
        for key, entry in sorted(health.get("checks", {}).items()):
            buf.write(
                f"    {key}: {entry['count']} "
                f"(in {entry['events']} findings)\n"
            )
    res = report.get("resilience", {})
    if (
        res.get("retry_attempts")
        or res.get("degraded")
        or res.get("checkpoint")
    ):
        buf.write("  resilience:\n")
        for op, entry in sorted(res.get("retries", {}).items()):
            buf.write(
                f"    retried {op}: {entry['attempts']} failed attempt(s) "
                f"(last error: {entry['last_error']})\n"
            )
        for key, count in sorted(res.get("degraded", {}).items()):
            buf.write(f"    DEGRADED {key}: {count}x\n")
        for action, entry in sorted(res.get("checkpoint", {}).items()):
            buf.write(
                f"    checkpoint {action}: {entry['count']}x "
                f"({entry['seconds'] * 1e3:.3f} ms total, "
                f"last {entry['nbytes']} B)\n"
            )
    slowest = report.get("sync", {}).get("slowest", [])
    if slowest:
        buf.write("  slowest collectives:\n")
        for item in slowest:
            buf.write(
                f"    {item['seconds'] * 1e3:8.3f} ms  {item['op']} "
                f"({item['payload_bytes']} B) @ {item['callsite']}\n"
            )
    spans = report.get("spans", {})
    if spans:
        buf.write("  metric phases:\n")
        for key in sorted(spans):
            entry = spans[key]
            buf.write(
                f"    {key}: {entry['calls']} calls, "
                f"{entry['seconds'] * 1e3:.3f} ms total, "
                f"state {entry['state_bytes']} B\n"
            )
    perf = report.get("perf", {})
    if perf.get("routes"):
        buf.write(
            f"  perfscope (device {perf.get('device_kind', '?')}):\n"
        )
        for program, route in sorted(perf["routes"].items()):
            buf.write(f"    {_format_perf_route(program, route)}\n")
    quality = report.get("quality", {})
    if quality.get("entries"):
        buf.write("  quality:\n")
        for entry in quality["entries"]:
            where = f"[{entry['slice']}]" if entry["slice"] else "[global]"
            buf.write(
                f"    {entry['metric']}{where} ({entry['window']}): "
                f"{entry['value']:.6g} "
                f"(min {entry['min']:.6g}, max {entry['max']:.6g}, "
                f"{entry['count']} readings, step {entry['step']})\n"
            )
        worst = quality.get("worst_slice")
        if worst:
            buf.write(
                f"    worst slice: {worst['metric']}[{worst['slice']}] "
                f"({worst['window']}) = {worst['value']:.6g}\n"
            )
    alerts = report.get("alerts", {})
    if alerts:
        buf.write("  ALERTS:\n")
        for rule, entry in sorted(alerts.items()):
            buf.write(
                f"    {rule}: fired {entry['count']}x "
                f"(last value {entry['value']:.4g} vs threshold "
                f"{entry['threshold']:.4g})\n"
            )
    route_decisions = report.get("route_decisions", [])
    if route_decisions:
        buf.write("  route decisions (measured-cost layer):\n")
        for entry in route_decisions:
            numbers = ""
            if entry["verdict"] == "measured":
                numbers = (
                    f" ({entry['seconds'] * 1e3:.3f} ms vs "
                    f"{entry['alt_seconds'] * 1e3:.3f} ms, "
                    f"{entry['source']})"
                )
            buf.write(
                f"    {entry['decision']}→{entry['route']} "
                f"[{entry['verdict']}] sig {entry['signature'] or '-'} "
                f"x{entry['count']}{numbers}\n"
            )
    srv = report.get("serve", {})
    if srv:
        shed = ", ".join(
            f"{k}={v}" for k, v in sorted(srv.get("shed", {}).items())
        )
        buf.write(
            f"  serve: {srv.get('admitted', 0)} admitted, "
            f"{sum(srv.get('shed', {}).values())} shed"
            f"{f' ({shed})' if shed else ''} "
            f"(shed rate {srv.get('shed_rate', 0.0):.3f}); "
            f"{srv.get('dispatched', 0)} dispatched "
            f"(mean wait {srv.get('mean_admit_wait_s', 0.0) * 1e3:.3f} ms); "
            f"{srv.get('quarantined', 0)} quarantined\n"
        )
        sessions = srv.get("sessions", {})
        if sessions:
            rendered = ", ".join(
                f"{k}={v}" for k, v in sorted(sessions.items())
            )
            buf.write(f"    sessions: {rendered}\n")
        rejected = srv.get("rejected", {})
        if rejected:
            rendered = ", ".join(
                f"{k}={v}" for k, v in sorted(rejected.items())
            )
            buf.write(f"    rejected: {rendered}\n")
    tenants_section = report.get("tenants", {})
    if tenants_section:
        buf.write(
            f"  tenants: {tenants_section.get('tenants_total', 0)} metered, "
            f"{tenants_section.get('device_seconds_total', 0.0):.6f} "
            "device-seconds attributed\n"
        )
        for row in tenants_section.get("rows", []):
            noisy = (
                f" NOISY {row.get('dominant_program')}"
                f"@{row.get('dominant_share', 0.0):.0%}"
                if row.get("dominant_program")
                else ""
            )
            buf.write(
                f"    {row['tenant']}: "
                f"{row.get('device_seconds', 0.0):.6f} dev-s, "
                f"{row.get('rows', 0)} rows, "
                f"{row.get('dispatched', 0)} dispatched, "
                f"shed rate {row.get('shed_rate', 0.0):.3f}, "
                f"p99 wait {row.get('wait_p99_s', 0.0) * 1e3:.3f} ms"
                f"{noisy}\n"
            )
        worst = tenants_section.get("worst_shed")
        if worst:
            buf.write(
                f"    worst shed: {worst['tenant']} "
                f"({worst.get('shed_rate', 0.0):.3f})\n"
            )
        worst = tenants_section.get("worst_p99")
        if worst:
            buf.write(
                f"    worst p99 wait: {worst['tenant']} "
                f"({worst.get('wait_p99_s', 0.0) * 1e3:.3f} ms)\n"
            )
    buf.write(
        f"  events: {report.get('events_captured', 0)} captured, "
        f"{report.get('events_dropped', 0)} dropped "
        f"(ring capacity {report.get('ring_capacity', 0)})\n"
    )
    by_kind = report.get("events_dropped_by_kind") or {}
    if by_kind:
        rendered = ", ".join(
            f"{kind}={count}" for kind, count in sorted(by_kind.items())
        )
        buf.write(f"    dropped by kind: {rendered}\n")
    return buf.getvalue()


def _format_perf_route(program: str, route: Dict[str, Any]) -> str:
    """One report line for a profiled route (shared by the telemetry
    report and :func:`format_explain_perf`)."""
    parts = [
        f"{program}: {route['flops'] / 1e6:.3f} MFLOP, "
        f"{route['bytes_accessed'] / 1e6:.3f} MB accessed"
    ]
    if route.get("reread_multiplier"):
        parts.append(f"reread x{route['reread_multiplier']:.2f}")
    if route.get("legacy_reread_multiplier"):
        # Present only when the legacy route for the same collection
        # signature was priced in this process: the megakernel's delta.
        delta = f"legacy reread x{route['legacy_reread_multiplier']:.2f}"
        if route.get("reread_reduction_x"):
            delta += f" -> {route['reread_reduction_x']:.1f}x lower"
        parts.append(delta)
    if "achieved_gbps" in route:
        parts.append(
            f"{route['achieved_gbps']:.2f} GB/s "
            f"({route['hbm_pct']:.2f}% HBM roof), "
            f"{route['achieved_gflops']:.2f} GFLOP/s "
            f"({route['flops_pct']:.2f}% compute roof), "
            f"{route['bound']}-bound"
        )
        parts.append(
            f"dispatch overhead "
            f"{route['dispatch_overhead_seconds'] * 1e6:.1f} us/call "
            f"({route['dispatch_overhead_pct']:.1f}% of wall) over "
            f"{route['dispatches']} dispatches"
        )
    parts.append(f"peak {route['peak_bytes']} B (temp {route['temp_bytes']} B)")
    if route.get("donated"):
        verdict = "verified" if route.get("aliased") else "NOT ALIASED"
        parts.append(f"donation {verdict}")
    return "; ".join(parts)


def format_explain_perf(result: Dict[str, Any]) -> str:
    """Render :func:`torcheval_tpu_torch.telemetry.explain_perf`'s dict (or
    the JAX package's) as the per-route roofline table."""
    buf = io.StringIO()
    peaks = result.get("peaks", {})
    exact = "" if peaks.get("exact", True) else " (fallback peaks)"
    buf.write(
        f"torcheval_tpu perfscope — device {result.get('device_kind', '?')}"
        f"{exact}: {peaks.get('hbm_gbps', 0.0):.0f} GB/s HBM, "
        f"{peaks.get('flops', 0.0) / 1e12:.1f} TFLOP/s\n"
    )
    routes = result.get("routes", {})
    if not routes:
        buf.write(
            "  no profiled programs — enable perfscope before dispatching "
            "(TORCHEVAL_TPU_TORCH_PERFSCOPE=1 or perfscope.enable())\n"
        )
    for program, route in sorted(routes.items()):
        buf.write(f"  {_format_perf_route(program, route)}\n")
    sketch = result.get("rank_sketch")
    if sketch:
        bins = ", ".join(
            f"{b}x{n}" for b, n in sketch.get("bins", {}).items()
        )
        buf.write(
            f"  rank-sketch tier: {sketch.get('members_constructed', 0)} "
            f"member(s) on sort-free sketch states (bins {bins}, "
            f"predicted eps <= {sketch.get('predicted_eps_max', 0.0):.2e})"
            " — exact-buffer curve members would pay a sort per compute\n"
        )
    alerts = result.get("alerts", {})
    for rule, entry in sorted(alerts.items()):
        buf.write(
            f"  ALERT {rule}: fired {entry['count']}x — "
            f"{entry.get('message', '')}\n"
        )
    return buf.getvalue()


def format_fleet_report(fleet: Dict[str, Any]) -> str:
    """Render :func:`torcheval_tpu_torch.telemetry.fleet_report`'s merged dict
    as the human-readable fleet summary."""
    buf = io.StringIO()
    totals = fleet.get("totals", {})
    buf.write(
        f"torcheval_tpu fleet telemetry ({fleet.get('hosts', 0)} hosts)\n"
    )
    buf.write(
        f"  totals: {totals.get('events_captured', 0)} events, "
        f"{totals.get('sync_calls', 0)} collectives "
        f"({totals.get('sync_seconds', 0.0) * 1e3:.3f} ms), "
        f"{totals.get('engine_blocks', 0)} engine blocks / "
        f"{totals.get('engine_batches', 0)} batches, "
        f"{totals.get('retrace_total', 0)} retraces\n"
    )
    for r in fleet.get("per_host", []):
        host = r.get("host", {})
        buf.write(
            f"  host {host.get('process_index', '?')} "
            f"({host.get('hostname', '?')}): "
            f"{r.get('events_captured', 0)} events, "
            f"sync {r.get('sync_seconds', 0.0) * 1e3:.3f} ms / "
            f"{r.get('sync_calls', 0)} calls, "
            f"{r.get('prefetch_stalls', 0)} stalls, "
            f"{r.get('retrace_total', 0)} retraces, "
            f"pad waste {r.get('pad_waste_pct', 0.0):.1f}%\n"
        )
    skew = fleet.get("skew", {})
    slowest = skew.get("slowest_sync") or {}
    if slowest.get("op"):
        host = slowest.get("host", {})
        buf.write(
            f"  slowest collective: {slowest.get('seconds', 0.0) * 1e3:.3f}"
            f" ms {slowest['op']} on host "
            f"{host.get('process_index', '?')}\n"
        )
    for label, key in (
        ("sync seconds", "sync_seconds"),
        ("prefetch stalls", "prefetch_stalls"),
        ("retraces", "retrace"),
    ):
        spread = skew.get(key, {})
        if spread.get("max"):
            host = spread.get("max_host", {})
            buf.write(
                f"  {label} skew: max {spread['max']:.4g} on host "
                f"{host.get('process_index', '?')} "
                f"(mean {spread['mean']:.4g}, "
                f"imbalance {spread['imbalance']:.2f}x)\n"
            )
    pad = skew.get("pad_waste_pct", {})
    if pad:
        buf.write(
            f"  pad waste: mean {pad.get('mean', 0.0):.2f}% "
            f"(variance {pad.get('variance', 0.0):.3f})\n"
        )
    for entry in fleet.get("data_health_by_host", []):
        host = entry.get("host", {})
        buf.write(
            f"  DATA HEALTH: host {host.get('process_index', '?')} "
            f"({host.get('hostname', '?')}) reported "
            f"{entry.get('findings', 0)} offending elements/batches\n"
        )
    quality = fleet.get("quality", {})
    for entry in quality.get("per_metric", []):
        where = f"[{entry['slice']}]" if entry["slice"] else "[global]"
        buf.write(
            f"  quality {entry['metric']}{where} ({entry['window']}): "
            f"min {entry['min']:.6g} / mean {entry['mean']:.6g} / "
            f"max {entry['max']:.6g} over {entry['hosts']} host(s)\n"
        )
    worst = quality.get("worst_slice") or {}
    if worst.get("metric"):
        host = worst.get("host", {})
        buf.write(
            f"  WORST SLICE: {worst['metric']}[{worst['slice']}] "
            f"({worst['window']}) = {worst['value']:.6g} on host "
            f"{host.get('process_index', '?')} "
            f"({host.get('hostname', '?')})\n"
        )
    tenant_fleet = fleet.get("tenants", {})
    for entry in tenant_fleet.get("per_tenant", []):
        buf.write(
            f"  tenant {entry['tenant']}: "
            f"{entry.get('device_seconds', 0.0):.6f} dev-s, "
            f"{entry.get('rows', 0)} rows, "
            f"shed rate {entry.get('shed_rate', 0.0):.3f} over "
            f"{entry.get('hosts', 0)} host(s)\n"
        )
    worst_tenant = tenant_fleet.get("worst_shed") or {}
    if worst_tenant.get("tenant"):
        host = worst_tenant.get("host", {})
        buf.write(
            f"  WORST TENANT SHED: {worst_tenant['tenant']} "
            f"({worst_tenant.get('shed_rate', 0.0):.3f}) on host "
            f"{host.get('process_index', '?')}\n"
        )
    worst_tenant = tenant_fleet.get("worst_p99") or {}
    if worst_tenant.get("tenant"):
        host = worst_tenant.get("host", {})
        buf.write(
            f"  WORST TENANT P99 WAIT: {worst_tenant['tenant']} "
            f"({worst_tenant.get('wait_p99_s', 0.0) * 1e3:.3f} ms) on "
            f"host {host.get('process_index', '?')}\n"
        )
    for entry in fleet.get("traces", []):
        buf.write(
            f"  trace {entry.get('trace_id', '?')}: "
            f"{entry.get('spans', 0)} spans across "
            f"{entry.get('hosts', 0)} host(s)\n"
        )
        hops = entry.get("critical_path") or []
        if hops:
            chain = " -> ".join(
                f"{hop['name']}"
                + (
                    f"@host{hop['host']}"
                    if hop.get("host") is not None
                    else ""
                )
                + f" {hop['seconds'] * 1e3:.2f}ms"
                for hop in hops
            )
            buf.write(f"    critical path: {chain}\n")
    return buf.getvalue()
