"""Cross-host telemetry aggregation (the port of
``torcheval_tpu/telemetry/aggregate.py``): serialize one host's snapshot,
merge snapshots across a
:class:`~torcheval_tpu_torch.distributed.CollectiveGroup`, and diagnose
fleet-level skew.

On a multi-host fleet, every ring buffer and counter from
:mod:`torcheval_tpu_torch.telemetry.events` is process-local: each operator
console sees 1/N of the picture, and the interesting failures are
exactly the asymmetric ones: one straggler host stretching every
collective, one feed pipeline stalling its prefetcher, one host
retracing in a loop, one host streaming NaNs into the merge.  This
module closes that gap in three steps:

1. :func:`host_snapshot`: a pickle/JSON-able dict of this host's
   aggregates (the full :func:`torcheval_tpu_torch.telemetry.report`) plus
   a bounded sample of recent raw events;
2. a group collective (``all_gather_object``, or ``gather_object`` for a
   coordinator-only view) ships the snapshots;
3. :func:`merge_snapshots`: per-host rollups, fleet totals, and the
   skew diagnostics: slowest-host sync latency, prefetch-stall and
   retrace asymmetry, padding-waste variance, and data-health findings
   pinned to the host that produced them.

The public entry point is :func:`fleet_report` (re-exported as
``telemetry.fleet_report``).  It degrades gracefully: under
:class:`~torcheval_tpu_torch.distributed.SingleProcessGroup` or
:class:`~torcheval_tpu_torch.distributed.NullGroup` no collective is
issued and the fleet view is this host's snapshot alone: the same code
path a fleet script runs unchanged on a laptop.  The snapshot and the
merged dict are the JAX package's layout, so the two packages' snapshots
merge together.
"""

from __future__ import annotations

import socket
from typing import Any, Dict, List, Optional, Union

SNAPSHOT_VERSION = 1

DEFAULT_SAMPLE_EVENTS = 256


# ------------------------------------------------------------------ snapshot
def _process_index() -> int:
    """This process's rank in the ``torch.distributed`` world, or 0 when
    no world is up (JAX's ``jax.process_index()`` with its fallback)."""
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:  # noqa: BLE001 - no world: a host of one
        pass
    return 0


def host_snapshot(sample_events: int = DEFAULT_SAMPLE_EVENTS) -> Dict[str, Any]:
    """This host's telemetry state as one plain dict: identity, the full
    :func:`torcheval_tpu_torch.telemetry.report`, and the newest
    ``sample_events`` raw events (the bounded wire sample: aggregates
    are exact regardless, the sample is for trace stitching and
    spot-checks).  Everything inside is JSON-able.  ``process_index`` is
    this process's ``torch.distributed`` rank when a world is up, else 0."""
    import torcheval_tpu_torch.telemetry as telemetry
    from torcheval_tpu_torch.telemetry.export import event_to_dict

    process_index = _process_index()

    sample: List[Dict[str, Any]] = []
    if sample_events > 0:
        snap = telemetry.events_snapshot()
        sample = [event_to_dict(e) for e in snap[-int(sample_events):]]

    return {
        "version": SNAPSHOT_VERSION,
        "host": {
            "process_index": process_index,
            "hostname": socket.gethostname(),
        },
        "report": _plain(telemetry.report()),
        "events": sample,
    }


def _plain(obj: Any) -> Any:
    """Recursively force JSON-able containers (report dicts keyed by
    tuples/ints become string-keyed)."""
    if isinstance(obj, dict):
        return {_plain_key(k): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def _plain_key(key: Any) -> str:
    if isinstance(key, tuple):
        return "/".join(str(part) for part in key)
    return str(key)


# --------------------------------------------------------------------- merge
def _host_rollup(snapshot: Dict[str, Any]) -> Dict[str, Any]:
    """The per-host row of the fleet report: the handful of scalars the
    skew diagnostics compare across hosts."""
    report = snapshot.get("report", {})
    sync = report.get("sync", {})
    engine = report.get("engine", {})
    health = report.get("data_health", {})
    quality = report.get("quality", {})
    # Degraded-event attribution: which hosts this one still considered
    # live when a fallback fired (the merge layer stamps survivors onto
    # every degraded/excised event; see events.DegradedEvent).
    degraded_survivors = [
        {
            "op": e.get("op", ""),
            "fallback": e.get("fallback", ""),
            "survivors": e.get("survivors", ""),
        }
        for e in snapshot.get("events", [])
        if e.get("kind") == "degraded" and e.get("survivors")
    ]
    return {
        # The live model-quality figures (list-of-dict entries survive
        # _plain untouched) and this host's worst slice reading.
        "quality_entries": list(quality.get("entries", [])),
        "quality_worst": quality.get("worst_slice"),
        # Per-tenant metering rows (list-of-dicts, same property) for
        # the tenant×host rollup below.
        "tenant_rows": list(report.get("tenants", {}).get("rows", [])),
        "merge_levels": list(
            report.get("merge", {}).get("levels", [])
        ),
        "degraded_survivors": degraded_survivors,
        "host": dict(snapshot.get("host", {})),
        "events_captured": report.get("events_captured", 0),
        "events_dropped": report.get("events_dropped", 0),
        "sync_calls": sync.get("calls", 0),
        "sync_seconds": sync.get("seconds", 0.0),
        "slowest_sync": (sync.get("slowest") or [{}])[0],
        "prefetch_stalls": engine.get("prefetch_stalls", 0),
        "stall_seconds": engine.get("stall_seconds", 0.0),
        "retrace_total": report.get("retrace", {}).get("total", 0),
        "pad_waste_pct": report.get("bucket_pad", {}).get("waste_pct", 0.0),
        "engine_blocks": engine.get("blocks", 0),
        "engine_batches": engine.get("batches", 0),
        "data_health_findings": sum(
            entry.get("count", 0) for entry in health.get("checks", {}).values()
        ),
    }


def _spread(
    rollups: List[Dict[str, Any]], key: str
) -> Dict[str, Any]:
    """Cross-host asymmetry of one rollup scalar: min/max/mean, the host
    holding the max, and ``imbalance`` = max/mean (1.0 means perfectly
    even; the straggler signal)."""
    values = [float(r[key]) for r in rollups]
    mean = sum(values) / len(values)
    hi = max(values)
    hi_host = rollups[values.index(hi)]["host"]
    return {
        "min": min(values),
        "max": hi,
        "mean": mean,
        "max_host": hi_host,
        "imbalance": (hi / mean) if mean else (1.0 if hi == 0 else float("inf")),
    }


def _variance(values: List[float]) -> float:
    mean = sum(values) / len(values)
    return sum((v - mean) ** 2 for v in values) / len(values)


def _count_spans(node: Dict[str, Any]) -> int:
    return 1 + sum(_count_spans(c) for c in node["children"])


def _span_hosts(node: Dict[str, Any], acc: set) -> None:
    if node.get("host") is not None:
        acc.add(node["host"])
    for c in node["children"]:
        _span_hosts(c, acc)


def fleet_traces(snapshots: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Cross-host span reconstruction: stitch every host's event sample
    into one forest (merge spans re-parent onto the upstream rank's span
    via the ack-carried link, so a fleet merge renders as ONE tree
    spanning hosts) and summarize each trace id — span count, hosts
    touched, and the slowest root-to-leaf critical path with each hop
    pinned to the host that ran it."""
    from torcheval_tpu_torch.telemetry import trace as _trace

    stamped: List[Dict[str, Any]] = []
    for snap in snapshots:
        host = snap.get("host", {}).get("process_index", 0)
        for d in snap.get("events", []):
            if d.get("span_id"):
                stamped.append({**d, "host": host})
    if not stamped:
        return []
    roots = _trace.build_forest(stamped)

    out: List[Dict[str, Any]] = []
    all_ids = sorted({d["trace_id"] for d in stamped if d.get("trace_id")})
    for tid in all_ids:
        selected = _trace.select_trace(roots, tid)
        if not selected:
            continue
        hosts: set = set()
        spans = 0
        best_path: List[Dict[str, Any]] = []
        best_cost = -1.0
        for root in selected:
            spans += _count_spans(root)
            _span_hosts(root, hosts)
            path = _trace.critical_path(root)
            cost = sum(float(n["seconds"]) for n in path)
            if cost > best_cost:
                best_cost = cost
                best_path = path
        out.append(
            {
                "trace_id": tid,
                "spans": spans,
                "hosts": len(hosts),
                "critical_path": [
                    {
                        "name": n["name"],
                        "host": n["host"],
                        "seconds": float(n["seconds"]),
                    }
                    for n in best_path
                ],
            }
        )
    return out


def merge_snapshots(snapshots: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Fold per-host snapshots (any order) into the fleet report dict:
    ``hosts`` count, ``per_host`` rollups sorted by process index, fleet
    ``totals``, and the ``skew`` diagnostics."""
    if not snapshots:
        raise ValueError("merge_snapshots needs at least one host snapshot")
    rollups = sorted(
        (_host_rollup(s) for s in snapshots),
        key=lambda r: r["host"].get("process_index", 0),
    )

    totals = {
        "events_captured": sum(r["events_captured"] for r in rollups),
        "events_dropped": sum(r["events_dropped"] for r in rollups),
        "sync_calls": sum(r["sync_calls"] for r in rollups),
        "sync_seconds": sum(r["sync_seconds"] for r in rollups),
        "prefetch_stalls": sum(r["prefetch_stalls"] for r in rollups),
        "stall_seconds": sum(r["stall_seconds"] for r in rollups),
        "retrace_total": sum(r["retrace_total"] for r in rollups),
        "engine_blocks": sum(r["engine_blocks"] for r in rollups),
        "engine_batches": sum(r["engine_batches"] for r in rollups),
        "data_health_findings": sum(
            r["data_health_findings"] for r in rollups
        ),
    }

    # The straggler diagnostics.  slowest_sync is the single worst
    # collective across the fleet (on a pod, one slow host stretches
    # everyone's collectives — its OWN sync spans are the fingerprint).
    slowest_sync: Dict[str, Any] = {}
    for r in rollups:
        cand = dict(r["slowest_sync"])
        if cand and cand.get("seconds", 0.0) >= slowest_sync.get(
            "seconds", -1.0
        ):
            cand["host"] = r["host"]
            slowest_sync = cand
    skew = {
        "slowest_sync": slowest_sync,
        "sync_seconds": _spread(rollups, "sync_seconds"),
        "prefetch_stalls": _spread(rollups, "prefetch_stalls"),
        "stall_seconds": _spread(rollups, "stall_seconds"),
        "retrace": _spread(rollups, "retrace_total"),
        "pad_waste_pct": {
            **_spread(rollups, "pad_waste_pct"),
            "variance": _variance(
                [float(r["pad_waste_pct"]) for r in rollups]
            ),
        },
    }

    # Merge-depth timing spread: per (op, level) across hosts, the
    # min/mean/max hop seconds — a straggler at one level of the tree is
    # the merge-critical-path fingerprint (its slow hop serializes every
    # ancestor above it).
    merge_depth: Dict[Any, Dict[str, Any]] = {}
    for r in rollups:
        for entry in r.get("merge_levels", []):
            key = (entry["op"], entry["level"])
            row = merge_depth.setdefault(
                key,
                {
                    "op": entry["op"],
                    "level": entry["level"],
                    "min_seconds": float("inf"),
                    "max_seconds": 0.0,
                    "_sum": 0.0,
                    "calls": 0,
                    "payload_bytes": 0,
                    "fanout": 0,
                    "hosts": 0,
                },
            )
            secs = float(entry["seconds"])
            row["min_seconds"] = min(row["min_seconds"], secs)
            row["max_seconds"] = max(row["max_seconds"], secs)
            row["_sum"] += secs
            row["calls"] += entry["calls"]
            row["payload_bytes"] += entry["payload_bytes"]
            row["fanout"] = max(row["fanout"], entry["fanout"])
            row["hosts"] += 1
    merge_rows = []
    for key in sorted(merge_depth):
        row = merge_depth[key]
        row["mean_seconds"] = row.pop("_sum") / row["hosts"]
        merge_rows.append(row)

    # Host-loss attribution: every degraded event that carried a
    # surviving-rank set, pinned to the emitting host — the "which hosts
    # did the fleet lose, as seen from where" answer.
    lost_reports = [
        {"host": r["host"], **entry}
        for r in rollups
        for entry in r.get("degraded_survivors", [])
    ]

    # Data-health findings pinned to the host that saw them — the "which
    # host is feeding NaNs" answer.
    health_by_host = [
        {"host": r["host"], "findings": r["data_health_findings"]}
        for r in rollups
        if r["data_health_findings"]
    ]

    # Per-slice quality rollup across hosts: one row per (metric, slice,
    # window) with min/mean/max of the hosts' last readings, plus the
    # single worst slice reading fleet-wide pinned to its host — the
    # "which host serves the degraded cohort" answer, mirroring the
    # slowest-collective pin above.
    by_key: Dict[Any, Dict[str, Any]] = {}
    worst_slice: Dict[str, Any] = {}
    for r in rollups:
        for entry in r.get("quality_entries", []):
            key = (entry["metric"], entry["slice"], entry["window"])
            row = by_key.setdefault(
                key,
                {
                    "metric": entry["metric"],
                    "slice": entry["slice"],
                    "window": entry["window"],
                    "min": float("inf"),
                    "max": float("-inf"),
                    "_sum": 0.0,
                    "hosts": 0,
                },
            )
            value = float(entry["value"])
            row["min"] = min(row["min"], value)
            row["max"] = max(row["max"], value)
            row["_sum"] += value
            row["hosts"] += 1
            if entry["slice"] and (
                not worst_slice or value < worst_slice.get("value", 0.0)
            ):
                worst_slice = {**entry, "host": r["host"]}
    per_metric = []
    for key in sorted(by_key):
        row = by_key[key]
        row["mean"] = row.pop("_sum") / row["hosts"]
        per_metric.append(row)

    # Tenant×host rollup: a tenant served from several hosts sums its
    # counters/device-seconds fleet-wide, and the worst shed-rate /
    # worst p99-wait readings are pinned to the host that produced them
    # (tenants.merge_rollups).
    from torcheval_tpu_torch.telemetry import tenants as _tenants

    tenant_rollup = _tenants.merge_rollups(
        [(r["host"], r.get("tenant_rows", [])) for r in rollups]
    )

    return {
        "hosts": len(rollups),
        "per_host": rollups,
        "totals": totals,
        "skew": skew,
        "data_health_by_host": health_by_host,
        "merge_depth": merge_rows,
        "membership": {"degraded_reports": lost_reports},
        "quality": {
            "per_metric": per_metric,
            "worst_slice": worst_slice or None,
        },
        "tenants": tenant_rollup,
        "traces": fleet_traces(snapshots),
    }


# ------------------------------------------------------------------- report
def fleet_report(
    group: Optional[Any] = None,
    *,
    dst: Optional[int] = None,
    sample_events: int = DEFAULT_SAMPLE_EVENTS,
    as_text: bool = False,
) -> Union[Dict[str, Any], str, None]:
    """The fleet-wide telemetry rollup.

    ``group`` is any :class:`~torcheval_tpu_torch.distributed.CollectiveGroup`
    (default :func:`~torcheval_tpu_torch.distributed.default_group`).  With
    ``dst=None`` every host gathers every snapshot (``all_gather_object``)
    and returns the merged report; with ``dst=R`` only rank R merges
    (``gather_object``) and the other ranks return ``None``: the
    coordinator-logs-once pattern.

    World size <= 1 (:class:`SingleProcessGroup`, or a
    :class:`NullGroup` process that is not part of the group) issues NO
    collective and reports this host alone, so the same call is safe
    everywhere.
    """
    from torcheval_tpu_torch.distributed import default_group
    from torcheval_tpu_torch.telemetry.export import format_fleet_report

    if group is None:
        group = default_group()

    local = host_snapshot(sample_events=sample_events)
    if group.world_size <= 1:
        snapshots: Optional[List[Dict[str, Any]]] = [local]
    elif dst is None:
        snapshots = group.all_gather_object(local)
    else:
        snapshots = group.gather_object(local, dst=dst)
    if snapshots is None:
        return None
    merged = merge_snapshots(snapshots)
    if as_text:
        return format_fleet_report(merged)
    return merged
