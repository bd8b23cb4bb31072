"""Unified telemetry for the eval hot path (the port of
``torcheval_tpu/telemetry``): one structured feed answering "why did step
latency spike": collective stall? padding waste? a retry storm? a corrupt
feed?

Disabled by default and free when off (every hook is a single branch on a
module flag, see :mod:`torcheval_tpu_torch.telemetry.events`).  Enable
with :func:`enable` or ``TORCHEVAL_TPU_TORCH_TELEMETRY=1``, then:

* :func:`events_snapshot` / :func:`export_jsonl`: the raw typed event
  stream (the JAX package's JSON-lines format, both ways);
* :func:`prometheus_text` / :func:`serve_prometheus`: aggregate counters
  and histograms for scraping;
* :func:`report`: the health summary (pad waste per bucket, slowest
  collectives, spans, data health, retries, checkpoints);
* :mod:`~torcheval_tpu_torch.telemetry.health`: the data-health monitor
  (NaN/Inf, constant inputs, out-of-range labels, zero-weight batches)
  on ``MetricCollection.fused_update``, reported under ``data_health``;
* :mod:`~torcheval_tpu_torch.telemetry.trace`: causal trace ids on every
  event; :mod:`~torcheval_tpu_torch.telemetry.flightrec`: post-mortem
  bundles;
* :func:`to_perfetto`: the events as Chrome/Perfetto trace-event JSON;
* :mod:`~torcheval_tpu_torch.telemetry.perfscope`: live roofline
  accounting of the hot-path dispatches: :func:`explain_perf` (achieved
  GB/s against the card's peaks, reread multiplier, donation
  verification), :func:`profile` (one merged host + device Perfetto
  trace) and SLO alert rules (:class:`SloRule`, :func:`default_rules`);
* :mod:`~torcheval_tpu_torch.telemetry.tenants`: the serve plane's
  per-tenant rows, in :func:`report`'s ``tenants`` section and the
  ``torcheval_tpu_tenant_*`` Prometheus families;
* :func:`fleet_report`: the cross-host rollup: per-host snapshots
  (:func:`host_snapshot`) merged over any
  :class:`~torcheval_tpu_torch.distributed.CollectiveGroup`
  (:func:`merge_snapshots`) with skew diagnostics and the tenant × host
  rollup (:mod:`~torcheval_tpu_torch.telemetry.aggregate`), rendered by
  :func:`format_fleet_report` and :func:`fleet_to_perfetto` (one ``pid``
  a host).

Example::

    from torcheval_tpu_torch import telemetry
    telemetry.enable()
    telemetry.health.enable()
    ... run the eval loop ...
    print(telemetry.report(as_text=True))
    telemetry.export_jsonl("telemetry.jsonl")

A saved JSONL dump replays offline through the CLI::

    python -m torcheval_tpu_torch.telemetry telemetry.jsonl --perfetto trace.json
"""

from __future__ import annotations

from typing import Any, Dict, Union

from torcheval_tpu_torch.telemetry import (
    aggregate,
    events,
    export,
    flightrec,
    health,
    perfscope,
    tenants,
    trace,
)
from torcheval_tpu_torch.telemetry.aggregate import (
    fleet_report,
    host_snapshot,
    merge_snapshots,
)
from torcheval_tpu_torch.telemetry.events import (
    AdmissionEvent,
    AlertEvent,
    BucketPadEvent,
    CacheEvent,
    CheckpointEvent,
    DataHealthEvent,
    DegradedEvent,
    DonationEvent,
    EngineBlockEvent,
    Event,
    PrefetchStallEvent,
    ProgramProfileEvent,
    QualityEvent,
    QuarantineEvent,
    RetraceEvent,
    RetryEvent,
    RouteDowngradeEvent,
    SessionEvent,
    SpanEvent,
    SyncEvent,
    TenantSampleEvent,
    clear,
    disable,
    emit,
    enable,
    enabled,
)
from torcheval_tpu_torch.telemetry.events import events as _events_snapshot
from torcheval_tpu_torch.telemetry.export import (
    event_from_dict,
    event_to_dict,
    export_jsonl,
    fleet_to_perfetto,
    format_explain_perf,
    format_fleet_report,
    format_report,
    prometheus_text,
    read_jsonl,
    serve_prometheus,
    to_perfetto,
)
from torcheval_tpu_torch.telemetry.perfscope import (
    SloRule,
    default_rules,
    explain_perf,
    profile,
)

# Re-export the snapshot accessor under its natural name without shadowing
# the submodule for `telemetry.events.ENABLED` readers.
events_snapshot = _events_snapshot

_TOP_N = 5


def report(as_text: bool = False) -> Union[Dict[str, Any], str]:
    """Process health summary over everything the bus has captured: a
    JSON-able dict, or the rendered text with ``as_text=True``.

    The JAX package's sections, less two: ``trace_counts`` and
    ``spmd_cache`` (the port traces and caches no program).
    """
    agg = events.aggregates()

    retrace_total = sum(agg["retrace"].values())
    offenders = sorted(
        (
            {"program": program, "callsite": callsite, "count": count}
            for (program, callsite), count in agg["retrace"].items()
        ),
        key=lambda item: -item["count"],
    )[:_TOP_N]

    pad_valid = sum(e["rows_valid"] for e in agg["bucket_pad"].values())
    pad_padded = sum(e["rows_padded"] for e in agg["bucket_pad"].values())
    pad_rows = pad_valid + pad_padded
    per_bucket = {}
    for bucket, entry in agg["bucket_pad"].items():
        rows = entry["rows_valid"] + entry["rows_padded"]
        per_bucket[bucket] = {
            **entry,
            "waste_pct": 100.0 * entry["rows_padded"] / rows if rows else 0.0,
        }

    downgrade_total = sum(agg["route_downgrade"].values())
    by_kind: Dict[str, int] = {}
    for (route_kind, _callsite), count in agg["route_downgrade"].items():
        by_kind[route_kind] = by_kind.get(route_kind, 0) + count

    sync_events = events.events("sync")
    slowest = sorted(
        (
            {
                "op": e.op,
                "seconds": e.seconds,
                "payload_bytes": e.payload_bytes,
                "callsite": e.callsite,
            }
            for e in sync_events
        ),
        key=lambda item: -item["seconds"],
    )[:_TOP_N]
    sync_totals = {
        "calls": sum(e["calls"] for e in agg["sync"].values()),
        "seconds": sum(e["seconds"] for e in agg["sync"].values()),
        "payload_bytes": sum(
            e["payload_bytes"] for e in agg["sync"].values()
        ),
        "slowest": slowest,
    }

    eng = agg["engine"]
    engine_section = {
        **eng,
        # The O(N/block) claim, directly: host dispatches per real batch.
        "dispatches_per_batch": (
            eng["blocks"] / eng["batches"] if eng["batches"] else 0.0
        ),
    }

    health_checks = {
        (check if not metric else f"{check}:{metric}"): dict(entry)
        for (check, metric), entry in agg["data_health"].items()
    }
    health_section = {
        "enabled": health.ENABLED,
        "findings": sum(e["count"] for e in health_checks.values()),
        "events": sum(e["events"] for e in health_checks.values()),
        "checks": health_checks,
    }

    res = agg["resilience"]
    resilience_section = {
        "retries": {
            op: dict(entry) for op, entry in res["retries"].items()
        },
        "retry_attempts": sum(
            e["attempts"] for e in res["retries"].values()
        ),
        "degraded": {
            f"{op}->{fallback}": count
            for (op, fallback), count in res["degraded"].items()
        },
        "checkpoint": {
            action: dict(entry)
            for action, entry in res["checkpoint"].items()
        },
    }

    spans = {
        f"{name}.{phase}": {
            "calls": entry["calls"],
            "seconds": entry["seconds"],
            "state_bytes": entry["state_bytes"],
        }
        for (name, phase), entry in agg["spans"].items()
    }

    from torcheval_tpu_torch import _flags as _flag_registry

    result: Dict[str, Any] = {
        "enabled": events.ENABLED,
        # Every TORCHEVAL_TPU_TORCH_* flag currently set away from its
        # default: a report from a deployment records which knobs shaped
        # the numbers it carries.
        "flags": _flag_registry.snapshot_non_default(),
        "retrace": {"total": retrace_total, "top_offenders": offenders},
        "route_downgrades": {"total": downgrade_total, "by_kind": by_kind},
        "bucket_pad": {
            "rows_valid": pad_valid,
            "rows_padded": pad_padded,
            "waste_pct": 100.0 * pad_padded / pad_rows if pad_rows else 0.0,
            "per_bucket": per_bucket,
        },
        "donation": dict(agg["donation"]),
        "sync": sync_totals,
        "engine": engine_section,
        "data_health": health_section,
        "resilience": resilience_section,
        "spans": spans,
        "events_captured": agg["emitted"],
        "events_dropped": events.dropped(),
        "events_dropped_by_kind": events.dropped_by_kind(),
        "ring_capacity": events.capacity(),
    }
    if agg["perf"]:
        perf = explain_perf()
        result["perf"] = {
            "device_kind": perf["device_kind"],
            "routes": perf["routes"],
        }
        if "rank_sketch" in perf:
            result["perf"]["rank_sketch"] = perf["rank_sketch"]
    if agg["merge_levels"]:
        # Hierarchical-merge depth accounting, structured as a list of
        # dicts (like quality) so fleet snapshots keep it intact through
        # aggregate._plain's key stringification.
        result["merge"] = {
            "levels": sorted(
                (
                    {
                        "op": op,
                        "level": level,
                        "calls": entry["calls"],
                        "seconds": entry["seconds"],
                        "payload_bytes": entry["payload_bytes"],
                        "fanout": entry["fanout"],
                    }
                    for (op, level), entry in agg["merge_levels"].items()
                ),
                key=lambda item: (item["op"], item["level"]),
            )
        }
    if agg["alerts"]:
        result["alerts"] = {
            rule: dict(entry) for rule, entry in agg["alerts"].items()
        }
    if agg["route_decisions"]:
        # List of dicts (NOT tuple-keyed), like quality below, so the
        # section survives fleet-snapshot key stringification.
        result["route_decisions"] = sorted(
            (
                {
                    "decision": decision,
                    "route": route,
                    "verdict": verdict,
                    **entry,
                }
                for (decision, route, verdict), entry in agg[
                    "route_decisions"
                ].items()
            ),
            key=lambda e: (e["decision"], e["route"], e["verdict"]),
        )
    if agg["quality"]:
        entries = sorted(
            (
                {
                    "metric": metric,
                    "slice": slice_label,
                    "window": window,
                    **dict(entry),
                }
                for (metric, slice_label, window), entry in agg[
                    "quality"
                ].items()
            ),
            key=lambda item: (item["metric"], item["window"], item["slice"]),
        )
        sliced = [e for e in entries if e["slice"]]
        result["quality"] = {
            "entries": entries,
            # The single most suspect figure: the lowest-valued slice
            # reading (the fleet rollup pins its cross-host analog to a
            # host, mirroring the slowest-collective pin).
            "worst_slice": (
                min(sliced, key=lambda e: e["value"]) if sliced else None
            ),
        }
    srv = agg["serve"]
    if (
        srv["admitted"]
        or srv["shed"]
        or srv["rejected"]
        or srv["quarantined"]
        or srv["sessions"]
    ):
        admitted = srv["admitted"]
        shed_total = sum(srv["shed"].values())
        offered = admitted + shed_total
        dispatched = srv["dispatched"]
        result["serve"] = {
            "admitted": admitted,
            "shed": dict(srv["shed"]),
            "shed_rate": shed_total / offered if offered else 0.0,
            "rejected": dict(srv["rejected"]),
            "dispatched": dispatched["calls"],
            "mean_admit_wait_s": (
                dispatched["wait_seconds"] / dispatched["calls"]
                if dispatched["calls"]
                else 0.0
            ),
            "quarantined": srv["quarantined"],
            "sessions": dict(srv["sessions"]),
        }
    tenant_rows = tenants.collect_rows(agg)
    if tenant_rows:
        # Top-K by attributed device-seconds with the worst-shed and
        # worst-p99 tenants pinned in; rows are plain list-of-dicts.
        result["tenants"] = tenants.report_section(tenant_rows)
    if as_text:
        return format_report(result)
    return result


__all__ = [
    "AdmissionEvent",
    "AlertEvent",
    "BucketPadEvent",
    "CacheEvent",
    "CheckpointEvent",
    "DataHealthEvent",
    "DegradedEvent",
    "DonationEvent",
    "EngineBlockEvent",
    "Event",
    "PrefetchStallEvent",
    "ProgramProfileEvent",
    "QualityEvent",
    "QuarantineEvent",
    "RetraceEvent",
    "RetryEvent",
    "RouteDowngradeEvent",
    "SessionEvent",
    "SloRule",
    "SpanEvent",
    "SyncEvent",
    "TenantSampleEvent",
    "aggregate",
    "clear",
    "default_rules",
    "disable",
    "emit",
    "enable",
    "enabled",
    "event_from_dict",
    "event_to_dict",
    "events",
    "events_snapshot",
    "explain_perf",
    "export",
    "export_jsonl",
    "fleet_report",
    "fleet_to_perfetto",
    "flightrec",
    "format_explain_perf",
    "format_fleet_report",
    "format_report",
    "health",
    "host_snapshot",
    "merge_snapshots",
    "perfscope",
    "profile",
    "prometheus_text",
    "read_jsonl",
    "report",
    "serve_prometheus",
    "tenants",
    "to_perfetto",
    "trace",
]
