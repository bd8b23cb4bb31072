"""The port's fleet report (``torcheval_tpu_torch.telemetry.aggregate``,
``export.fleet_to_perfetto`` and ``export.format_fleet_report``) against
the JAX package's.

The same plain host snapshots (three synthetic hosts: syncs, merge levels,
data-health findings, quality slices, tenant rows, degraded events with
survivors, and a merge trace whose spans cross hosts) go through both
packages: the merged dict, the trace summaries, the rendered text and the
Perfetto JSON must be equal.  A snapshot the port takes of its own bus
merges the same under JAX's ``merge_snapshots``.  The collective side runs
over the port's groups: none is issued for a world of one, every rank
gathers with ``dst=None``, and only ``dst`` merges otherwise.
"""

import json

import pytest

import torcheval_tpu.telemetry as jax_telemetry
from torcheval_tpu.telemetry import aggregate as jax_aggregate
from torcheval_tpu.telemetry import export as jax_export

import torcheval_tpu_torch.telemetry as port_telemetry
from torcheval_tpu_torch.distributed import LocalWorld, NullGroup, SingleProcessGroup
from torcheval_tpu_torch.telemetry import aggregate, export
from torcheval_tpu_torch.telemetry import events as port_events
from torcheval_tpu_torch.telemetry import trace as port_trace
from torcheval_tpu_torch.telemetry.events import (
    DegradedEvent,
    PlacementEvent,
    SpanEvent,
    SyncEvent,
)

from tests.test_torch_telemetry import reset_all


@pytest.fixture(autouse=True)
def _clean():
    reset_all()
    yield
    reset_all()


def _json(obj):
    return json.dumps(obj, sort_keys=True)


def _events(host):
    """One host's event sample: a hop of one merge trace that crosses the
    three hosts (root on host 0, child on 1, grandchild on 2), a local
    trace, a degraded event with survivors, a sync, a placement, and an
    event kind neither package knows (skipped by the Perfetto export)."""
    parent = {0: "", 1: "s-root", 2: "s-mid"}[host]
    span = {0: "s-root", 1: "s-mid", 2: "s-leaf"}[host]
    out = [
        SpanEvent(time_s=10.0 + host, thread="merge", trace_id="trace-m", span_id=span,
                  parent_span_id=parent, phase="dispatch", name=f"fleet_merge.l{host}",
                  seconds=0.01 * (host + 1)),
        SyncEvent(time_s=10.5 + host, thread="merge", trace_id="trace-m", span_id=span,
                  op="fleet_merge", seconds=0.002 * (host + 1), payload_bytes=64 * (host + 1),
                  level=host + 1, fanout=2),
        SpanEvent(time_s=20.0 + host, thread="main", trace_id=f"trace-l{host}",
                  span_id=f"s-local{host}", phase="update", name="MulticlassAccuracy",
                  seconds=0.003, state_bytes=80),
        PlacementEvent(time_s=21.0 + host, thread="router", action="route",
                       tenant=f"t{host}", src=0, dst=host, epoch=1),
    ]
    if host == 2:
        out.append(DegradedEvent(time_s=22.0, thread="merge", op="fleet_merge",
                                 reason="rank 1 silent", fallback="partial",
                                 survivors="0,2"))
    dicts = [export.event_to_dict(e) for e in out]
    dicts.append({"kind": "from_the_future", "time_s": 30.0, "thread": "x"})
    return dicts


def _snapshot(host):
    report = {
        "events_captured": 40 + host,
        "events_dropped": host,
        "sync": {"calls": 3 + host, "seconds": 0.004 * (host + 1),
                 "slowest": [{"op": "all_gather_object", "seconds": 0.002 * (3 - host),
                              "payload_bytes": 128}]},
        "engine": {"prefetch_stalls": [0, 4, 1][host], "stall_seconds": 0.1 * host,
                   "blocks": 5 + host, "batches": 40 + 8 * host},
        "retrace": {"total": [1, 1, 7][host]},
        "bucket_pad": {"waste_pct": [0.0, 12.5, 3.0][host]},
        "data_health": {"checks": {"nan": {"count": [0, 0, 3][host]},
                                   "label_range": {"count": [0, 0, 1][host]}}},
        "quality": {
            "entries": [
                {"metric": "acc", "slice": "", "window": "all", "value": 0.8 + 0.01 * host},
                {"metric": "acc", "slice": "cohort-a", "window": "all",
                 "value": [0.7, 0.55, 0.65][host]},
            ],
            "worst_slice": {"metric": "acc", "slice": "cohort-a", "window": "all",
                            "value": [0.7, 0.55, 0.65][host]},
        },
        "tenants": {"rows": [
            {"tenant": "t0", "owner": "0", "admitted": 4 + host, "shed": host, "rows": 64,
             "device_seconds": 0.001 * (host + 1), "wait_p99_s": 0.002 * host,
             "shed_rate": host / (4 + 2 * host)},
            {"tenant": f"t{host + 1}", "owner": str(host), "admitted": 2, "shed": 0,
             "rows": 32, "device_seconds": 0.0005, "wait_p99_s": 0.0, "shed_rate": 0.0},
        ]},
        "merge": {"levels": [
            {"op": "fleet_merge", "level": 1, "seconds": 0.01 * (host + 1), "calls": 1,
             "payload_bytes": 64, "fanout": 2},
        ] + ([{"op": "fleet_merge", "level": 2, "seconds": 0.03, "calls": 1,
               "payload_bytes": 128, "fanout": 2}] if host == 0 else [])},
    }
    return {
        "version": 1,
        "host": {"process_index": host, "hostname": f"host-{host}"},
        "report": report,
        "events": _events(host),
    }


def _snapshots():
    # Any order: the merge sorts hosts by process index.
    return [_snapshot(2), _snapshot(0), _snapshot(1)]


def test_merge_snapshots_equals_jax():
    mine = aggregate.merge_snapshots(_snapshots())
    theirs = jax_aggregate.merge_snapshots(_snapshots())
    assert _json(mine) == _json(theirs)
    assert mine["hosts"] == 3
    assert [r["host"]["process_index"] for r in mine["per_host"]] == [0, 1, 2]
    assert mine["skew"]["slowest_sync"]["host"]["process_index"] == 0
    assert mine["skew"]["retrace"]["max_host"]["process_index"] == 2
    assert mine["data_health_by_host"] == [
        {"host": {"process_index": 2, "hostname": "host-2"}, "findings": 4}]
    assert mine["quality"]["worst_slice"]["host"]["process_index"] == 1
    assert mine["membership"]["degraded_reports"][0]["survivors"] == "0,2"
    assert [(r["op"], r["level"], r["hosts"]) for r in mine["merge_depth"]] == [
        ("fleet_merge", 1, 3), ("fleet_merge", 2, 1)]
    t0 = next(r for r in mine["tenants"]["per_tenant"] if r["tenant"] == "t0")
    assert t0["hosts"] == 3 and t0["owner"] == "0" and t0["admitted"] == 4 + 5 + 6


def test_fleet_traces_equal_jax_and_cross_hosts():
    mine = aggregate.fleet_traces(_snapshots())
    assert _json(mine) == _json(jax_aggregate.fleet_traces(_snapshots()))
    merge = next(t for t in mine if t["trace_id"] == "trace-m")
    assert merge["hosts"] == 3
    assert [hop["host"] for hop in merge["critical_path"]] == [0, 1, 2]
    assert {t["trace_id"] for t in mine} == {"trace-m", "trace-l0", "trace-l1", "trace-l2"}
    assert aggregate.fleet_traces([{"host": {}, "events": []}]) == []


def test_format_fleet_report_text_equals_jax():
    fleet = aggregate.merge_snapshots(_snapshots())
    text = export.format_fleet_report(fleet)
    assert text == jax_export.format_fleet_report(jax_aggregate.merge_snapshots(_snapshots()))
    for needle in ("fleet telemetry (3 hosts)", "host 2 (host-2)", "DATA HEALTH: host 2",
                   "WORST SLICE: acc[cohort-a]", "tenant t0:", "trace trace-m: ",
                   "critical path: fleet_merge.l0@host0"):
        assert needle in text, needle


def test_fleet_to_perfetto_json_equals_jax():
    mine = export.fleet_to_perfetto(_snapshots())
    assert _json(mine) == _json(jax_export.fleet_to_perfetto(_snapshots()))
    assert {e["pid"] for e in mine["traceEvents"]} == {0, 1, 2}
    names = {e["args"]["name"] for e in mine["traceEvents"]
             if e.get("ph") == "M" and e.get("name") == "process_name"}
    assert names == {"host 0 (host-0)", "host 1 (host-1)", "host 2 (host-2)"}
    # Flow arrows resolve across hosts: the child's span on host 1 draws
    # from the root's slice on host 0.
    flows = [e for e in mine["traceEvents"] if e.get("ph") in ("s", "f")]
    assert {e["pid"] for e in flows} >= {0, 1}


def test_port_snapshot_merges_the_same_under_jax():
    port_events.enable()
    port_trace.enable()
    with port_trace.span("serve.dispatch"):
        port_events.record_sync("local_all_gather_object", 0.003, 256)
    port_events.record_degraded("serve.migrate", "tenant 't' handoff aborted", "x")
    snap = aggregate.host_snapshot()
    assert snap["version"] == jax_aggregate.SNAPSHOT_VERSION == aggregate.SNAPSHOT_VERSION
    assert snap["host"]["process_index"] == 0
    json.dumps(snap)  # JSON-able as it stands
    snaps = [snap, {**snap, "host": {"process_index": 1, "hostname": "peer"}}]
    assert _json(aggregate.merge_snapshots(snaps)) == _json(jax_aggregate.merge_snapshots(snaps))
    assert _json(export.fleet_to_perfetto(snaps)) == _json(jax_export.fleet_to_perfetto(snaps))


@pytest.mark.parametrize("n", [0, 2])
def test_host_snapshot_bounds_the_sample(n):
    port_events.enable()
    for i in range(5):
        port_events.record_sync(f"op{i}", 0.001, i)
    snap = aggregate.host_snapshot(sample_events=n)
    want = [export.event_to_dict(e) for e in port_telemetry.events_snapshot()[-n:]] if n else []
    assert snap["events"] == want
    assert snap["report"]["events_captured"] == 5


class _Counting(SingleProcessGroup):
    calls = 0

    def all_gather_object(self, obj):
        type(self).calls += 1
        return super().all_gather_object(obj)

    def gather_object(self, obj, dst=0):
        type(self).calls += 1
        return super().gather_object(obj, dst)


@pytest.mark.parametrize("group", [_Counting(), NullGroup()], ids=["single", "null"])
def test_world_of_one_issues_no_collective(group):
    port_events.enable()
    port_events.record_sync("op", 0.002, 64)
    merged = port_telemetry.fleet_report(group)
    assert merged["hosts"] == 1 and _Counting.calls == 0
    text = port_telemetry.fleet_report(group, dst=0, as_text=True)
    assert text.startswith("torcheval_tpu fleet telemetry (1 hosts)") and _Counting.calls == 0
    # The default group of a process with no torch.distributed world.
    assert port_telemetry.fleet_report()["hosts"] == 1
    assert port_telemetry.fleet_report is aggregate.fleet_report
    assert jax_telemetry.fleet_report(as_text=True).startswith("torcheval_tpu fleet")


@pytest.mark.parametrize("dst", [None, 0, 2])
def test_local_world_gathers_where_asked(dst):
    port_events.enable()
    out = LocalWorld(3).run(lambda g, r: aggregate.fleet_report(g, dst=dst, sample_events=4))
    for rank, merged in enumerate(out):
        if dst is None or rank == dst:
            assert merged["hosts"] == 3 and len(merged["per_host"]) == 3
        else:
            assert merged is None
    ops = [e.op for e in port_events.events() if e.kind == "sync"]
    want = "local_all_gather_object" if dst is None else "local_gather_object"
    assert ops.count(want) == 3
