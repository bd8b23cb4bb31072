"""The port's telemetry bus against the JAX package's: the same event
stream from the same lifecycles, the JSON-lines format both ways, the same
Perfetto / Prometheus / report text for the same events, ring overflow,
causal trace trees, profiler annotations, the CLI on a JAX dump, and the
import-time switches.  Everything on the CPU, at small sizes."""

import dataclasses
import io
import json
import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as jm
import torcheval_tpu.telemetry as jax_telemetry
from torcheval_tpu.distributed import LocalWorld as JaxLocalWorld
from torcheval_tpu.resilience import faults as jax_faults
from torcheval_tpu.serve import metering as jax_metering
from torcheval_tpu.telemetry import events as jax_events
from torcheval_tpu.telemetry import export as jax_export
from torcheval_tpu.telemetry import flightrec as jax_flightrec
from torcheval_tpu.telemetry import health as jax_health
from torcheval_tpu.telemetry import perfscope as jax_perfscope
from torcheval_tpu.telemetry import trace as jax_trace

import torcheval_tpu_torch.metrics as tm
import torcheval_tpu_torch.telemetry as port_telemetry
from torcheval_tpu_torch import _flags
from torcheval_tpu_torch.distributed import LocalWorld
from torcheval_tpu_torch.resilience import faults as port_faults
from torcheval_tpu_torch.serve import metering as port_metering
from torcheval_tpu_torch.telemetry import __main__ as port_cli
from torcheval_tpu_torch.telemetry import events as port_events
from torcheval_tpu_torch.telemetry import export as port_export
from torcheval_tpu_torch.telemetry import flightrec as port_flightrec
from torcheval_tpu_torch.telemetry import health as port_health
from torcheval_tpu_torch.telemetry import perfscope as port_perfscope
from torcheval_tpu_torch.telemetry import trace as port_trace


ROOT = Path(__file__).resolve().parents[1]

# ------------------------------------------------ helpers (the other test_torch_*
# files of the bus and the resilience layer import them)

# Fields that differ between two runs of the same lifecycle: clocks, the
# caller's line, the thread's name and the random trace ids.
VOLATILE = frozenset(
    {"time_s", "callsite", "thread", "trace_id", "span_id", "parent_span_id", "seconds"}
)
# Kinds the port has no hook site for (no tracing, donation or program cache).
JAX_ONLY_KINDS = frozenset(
    {"retrace", "donation_restore", "donation_abort",
     "spmd_cache_hit", "spmd_cache_miss", "spmd_cache_evict"}
)


def reset_all():
    """Every switch of both packages off, every ring, journal and ledger
    empty."""
    for ev, tr, fr, he, fa in (
        (jax_events, jax_trace, jax_flightrec, jax_health, jax_faults),
        (port_events, port_trace, port_flightrec, port_health, port_faults),
    ):
        ev.enable(capacity=ev.DEFAULT_CAPACITY, annotate=False)
        ev.disable()
        ev.clear()
        tr.disable()
        fr.enable(dir=fr.DEFAULT_DIR, last_events=fr.DEFAULT_LAST_EVENTS)
        fr.disable()
        fr.reset()
        he.disable()
        he.RAISE_ON_CORRUPT = False
        plan = fa.active()
        if plan is not None:
            plan.uninstall()
    # The serve planes' tenant ledgers: a serve test that built an
    # EvalService earlier in this process turns metering on and fills it,
    # and the report and Prometheus text then carry its tenants.
    jax_metering.reset()
    port_metering.reset()
    for scope in (jax_perfscope, port_perfscope):
        scope.disable()
        scope.reset()


def stream(events, drop_kinds=JAX_ONLY_KINDS, volatile=VOLATILE):
    """Events as comparable ``(kind, fields)`` tuples."""
    return [
        tuple((k, v) for k, v in dataclasses.asdict(e).items() if k not in volatile)
        for e in events
        if e.kind not in drop_kinds
    ]


def metric_update(row):
    """Whether a :func:`stream` row is a metric's update span."""
    d = dict(row)
    return d.get("phase") == "update" and d.get("name") != "MetricCollection.fused"


def update_bytes_dropped(rows):
    """JAX :func:`stream` rows with a metric update span's state bytes read
    as 0: the port's update spans record none (a sample buffer grows with
    every update, and sizing it on each span would cost quadratic time over
    a pass); every other field matches the JAX bus's."""
    return [
        tuple((k, 0 if k == "state_bytes" and metric_update(r) else v) for k, v in r)
        for r in rows
    ]


def _value_for(default, i):
    if isinstance(default, bool):
        return i % 2 == 0
    if isinstance(default, int):
        return i + 1
    if isinstance(default, float):
        return 10.0 ** -(i % 6) * 1.5
    return f"v{i}"


_FIXED_FIELDS = {
    "spmd_cache_hit": {"hit": True, "evicted": False},
    "spmd_cache_miss": {"hit": False, "evicted": False},
    "spmd_cache_evict": {"evicted": True},
    "donation_restore": {"action": "restore"},
    "donation_abort": {"action": "abort"},
}


def every_kind_dicts(exclude=()):
    """One plain event dict of every kind the bus carries (and a merge-level
    sync, four admission outcomes, a traced pair), deterministic, with
    non-default time, callsite and thread so ``emit`` keeps them."""
    out = []
    i = 0
    for kind, cls in sorted(jax_events.KIND_TO_CLASS.items()):
        if kind in exclude:
            continue
        variants = [{}]
        if kind == "admission":
            variants = [{"outcome": o, "reason": r} for o, r in
                        (("admitted", ""), ("shed", "queue_full"), ("rejected", "unknown"),
                         ("dispatched", ""))]
        if kind == "sync":
            variants = [{}, {"level": 2, "fanout": 3}]
        for variant in variants:
            i += 1
            d = {"kind": kind, "time_s": 1000.0 + i, "callsite": f"user.py:{i}",
                 "thread": "MainThread" if i % 3 else f"rank-{i % 4}"}
            for f in dataclasses.fields(cls):
                if f.name in ("kind", "time_s", "callsite", "thread", "trace_id", "span_id",
                              "parent_span_id"):
                    continue
                d[f.name] = _value_for(f.default, i + len(f.name))
            if kind.startswith("session_"):
                d["action"] = kind[len("session_"):]
            d.update(_FIXED_FIELDS.get(kind, {}))
            d.update(variant)
            if i % 5 == 0:
                d.update(trace_id=f"t{i // 10}", span_id=f"s{i}", parent_span_id=f"s{i - 5}")
            out.append(d)
    return out



@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.setenv("TORCHEVAL_TPU_MEGAKERNEL", "1")
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "1")
    reset_all()
    yield
    reset_all()


# ------------------------------------------------------------ event stream
def _batches(seed, n=300, classes=5):
    rng = np.random.default_rng(seed)
    x = rng.random((n, classes)).astype(np.float32)
    y = rng.integers(0, classes, n).astype(np.int32)
    return x, y


def _metric_lifecycle(mod, arr, kw):
    x, y = _batches(0)
    m = mod.MulticlassAccuracy(num_classes=5, **kw)
    m.update(arr(x), arr(y)).update(arr(x[:100]), arr(y[:100]))
    m.compute()
    b = mod.BinaryAUROC(**kw)
    b.update(arr(x[:, 0]), arr((y > 2).astype(np.int32)))
    b.compute()


def _collection_lifecycle(mod, arr, kw, health=None):
    x, y = _batches(1)
    extra = {"donate": False} if mod is jm else {}
    col = mod.MetricCollection(
        {"acc": mod.MulticlassAccuracy(num_classes=5, **kw),
         "cm": mod.MulticlassConfusionMatrix(5, **kw),
         "f1": mod.MulticlassF1Score(num_classes=5, average="macro", **kw)},
        bucket=True, **extra)
    if health is not None:
        health.enable()
    y_bad = y.copy()
    y_bad[:3] = 7
    x_bad = x.copy()
    x_bad[5, 1] = np.nan
    for xs, ys in ((x, y), (x_bad[:77], y_bad[:77]), (x[:200], y[:200])):
        col.fused_update(arr(xs), arr(ys))
    col.compute()


@pytest.mark.parametrize("lifecycle", ["metrics", "collection", "collection_health"])
def test_event_stream_matches_jax(lifecycle):
    runs = {}
    for name, mod, ev, arr, kw, health in (
        ("jax", jm, jax_events, jnp.asarray, {}, jax_telemetry.health),
        ("port", tm, port_events, torch.from_numpy, {"device": "cpu"}, port_telemetry.health),
    ):
        ev.enable()
        if lifecycle == "metrics":
            _metric_lifecycle(mod, arr, kw)
        else:
            _collection_lifecycle(mod, arr, kw, health if lifecycle.endswith("health") else None)
        ev.disable()
        runs[name] = stream(ev.events())
    if lifecycle == "metrics":
        assert any(metric_update(r) for r in runs["port"])
    assert all(dict(r)["state_bytes"] == 0 for r in runs["port"] if metric_update(r))
    assert runs["port"] == update_bytes_dropped(runs["jax"])
    kinds = {fields[0][1] for fields in runs["port"]}
    assert "span" in kinds
    if lifecycle != "metrics":
        assert "bucket_pad" in kinds
    if lifecycle == "collection_health":
        assert "data_health" in kinds


def test_local_world_sync_events_match_jax():
    def fn(g, r):
        g.all_gather_object(r)
        g.gather_object(r * 10, dst=1)
        g.broadcast_object(r, src=0)
        return r

    seen = {}
    for name, world, ev in (("jax", JaxLocalWorld, jax_events), ("port", LocalWorld, port_events)):
        ev.enable()
        world(3).run(fn)
        ev.disable()
        seen[name] = sorted(stream(ev.events(), volatile={"time_s", "callsite", "thread",
                                                           "seconds"}))
    assert seen["port"] == seen["jax"]
    ops = [dict(e)["op"] for e in seen["port"]]
    assert ops.count("local_all_gather_object") == 3 and ops.count("local_gather_object") == 3


def test_every_event_class_matches_jax():
    assert set(port_events.KIND_TO_CLASS) == set(jax_events.KIND_TO_CLASS)
    for kind, jcls in jax_events.KIND_TO_CLASS.items():
        pcls = port_events.KIND_TO_CLASS[kind]
        assert pcls.__name__ == jcls.__name__
        assert [(f.name, f.default) for f in dataclasses.fields(pcls)] == [
            (f.name, f.default) for f in dataclasses.fields(jcls)
        ]
    assert port_events.DURATION_BUCKETS == jax_events.DURATION_BUCKETS


# ---------------------------------------------------------- format contracts
def _emit_both(dicts):
    for ev, export in ((jax_events, jax_export), (port_events, port_export)):
        ev.enable(capacity=max(len(dicts), 1))
        for d in dicts:
            ev.emit(export.event_from_dict(dict(d)))


def test_jsonl_reads_both_ways():
    dicts = every_kind_dicts()
    _emit_both(dicts)
    jax_buf, port_buf = io.StringIO(), io.StringIO()
    assert jax_telemetry.export_jsonl(jax_buf) == len(dicts)
    assert port_telemetry.export_jsonl(port_buf) == len(dicts)
    assert port_buf.getvalue() == jax_buf.getvalue()
    jax_buf.seek(0)
    port_buf.seek(0)
    from_jax = port_export.read_jsonl(jax_buf, strict=True)
    from_port = jax_export.read_jsonl(port_buf, strict=True)
    assert [port_export.event_to_dict(e) for e in from_jax] == [
        jax_export.event_to_dict(e) for e in from_port
    ]
    assert [type(e).__module__ for e in from_jax] == [port_events.__name__] * len(dicts)
    assert [port_export.event_to_dict(e) for e in from_jax] == [
        {k: v for k, v in d.items() if v != "" or k not in ("trace_id", "span_id",
                                                            "parent_span_id")}
        for d in dicts
    ]
    # A newer kind is skipped with one warning, or raises under strict.
    line = json.dumps({"kind": "from_the_future", "time_s": 1.0}) + "\n"
    with pytest.warns(UserWarning, match="from_the_future x1"):
        assert port_export.read_jsonl(io.StringIO(line)) == []
    with pytest.raises(ValueError, match="unknown telemetry event kind"):
        port_export.read_jsonl(io.StringIO(line), strict=True)


def test_perfetto_prometheus_and_report_match_jax(monkeypatch):
    # Every kind: tenant samples feed the tenants section and families,
    # program profiles the perf section.  The sketch census is process
    # global: another test's sketch members must not reach one package's
    # perf section and not the other's.
    from torcheval_tpu.metrics import _rank_state as jax_rank_state
    from torcheval_tpu_torch.metrics import _rank_state as port_rank_state

    for mod in (jax_rank_state, port_rank_state):
        monkeypatch.setattr(mod, "_CENSUS", {"constructed": 0, "bins": {}})
    dicts = every_kind_dicts()
    _emit_both(dicts)
    assert port_telemetry.to_perfetto() == jax_telemetry.to_perfetto()
    trace = port_telemetry.to_perfetto(pid=3, process_name="rank 3")
    assert sum(e["ph"] == "X" for e in trace["traceEvents"]) == sum(
        d["kind"] in ("span", "sync", "prefetch_stall", "checkpoint") for d in dicts)
    json.dumps(trace)
    text = port_telemetry.prometheus_text()
    assert text == jax_telemetry.prometheus_text()
    for line in text.splitlines():
        assert line.startswith("#") or len(line.rsplit(" ", 1)) == 2, line
        if not line.startswith("#"):
            float(line.rsplit(" ", 1)[1])
    jax_report = jax_telemetry.report()
    port_report = port_telemetry.report()
    left_out = {"trace_counts", "spmd_cache", "flags"}
    assert {k: v for k, v in port_report.items() if k != "flags"} == {
        k: v for k, v in jax_report.items() if k not in left_out}
    assert port_export.format_report(jax_report) == jax_export.format_report(jax_report)
    assert port_telemetry.report(as_text=True) == port_export.format_report(port_report)


def test_ring_overflow_matches_jax():
    dicts = every_kind_dicts(exclude={"tenant_sample", "program_profile"})[:9]
    for ev, export in ((jax_events, jax_export), (port_events, port_export)):
        ev.enable(capacity=4)
        for d in dicts:
            ev.emit(export.event_from_dict(dict(d)))
    assert port_events.capacity() == 4 and len(port_events.events()) == 4
    assert port_events.dropped() == jax_events.dropped() == 5
    assert port_events.dropped_by_kind() == jax_events.dropped_by_kind()
    assert sum(port_events.dropped_by_kind().values()) == 5
    assert port_events.aggregates() == jax_events.aggregates()
    with pytest.raises(ValueError, match="capacity must be >= 1"):
        port_events.enable(capacity=0)


# ------------------------------------------------------------- trace trees
def test_trace_ids_and_forest_match_jax():
    port_trace.enable()
    port_events.enable()
    with port_trace.activate(port_trace.root("eval")) as root:
        tm.MulticlassAccuracy(num_classes=3, device="cpu").update(
            torch.tensor([[0.1, 0.7, 0.2]]), torch.tensor([1]))
        with port_trace.span("sync") as inner:
            port_events.record_sync("op", 0.25, 8)
            with port_trace.span("retry"):
                port_events.record_retry("op", 1, 0.01, "boom")
    port_events.record_span("update", "Loose", 0.5, 0)  # no context: no ids
    evs = port_events.events()
    assert {e.trace_id for e in evs[:-1]} == {root.trace_id} and evs[-1].trace_id == ""
    sync = port_events.events("sync")[0]
    assert (sync.span_id, sync.parent_span_id) == (inner.span_id, root.span_id)
    dicts = [port_export.event_to_dict(e) for e in evs]
    forest = port_trace.build_forest(dicts)
    assert forest == jax_trace.build_forest(dicts)
    assert port_trace.format_forest(forest) == jax_trace.format_forest(forest)
    assert port_trace.select_trace(forest, root.trace_id) == jax_trace.select_trace(
        forest, root.trace_id)
    path = port_trace.critical_path(forest[0])
    assert [n["span_id"] for n in path] == [n["span_id"] for n in jax_trace.critical_path(forest[0])]
    assert path[0]["span_id"] == root.span_id and len(path) == 3
    # A missing parent renders as a placeholder.
    orphan = port_trace.build_forest([{"kind": "sync", "span_id": "a", "parent_span_id": "gone"}])
    assert orphan[0]["name"] == "(not in sample)" and orphan[0]["children"][0]["span_id"] == "a"


def test_annotate_names_the_spans_in_a_profiler_trace():
    from torch.profiler import ProfilerActivity, profile

    port_events.enable(annotate=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tm.MulticlassAccuracy(num_classes=3, device="cpu").update(
            torch.tensor([[0.1, 0.7, 0.2]]), torch.tensor([1])).compute()
    keys = {e.key for e in prof.key_averages()}
    assert {"torcheval_tpu_torch.MulticlassAccuracy.update",
            "torcheval_tpu_torch.MulticlassAccuracy.compute"} <= keys
    assert [e.phase for e in port_events.events("span")] == ["dispatch", "update", "compute"]


def test_callsite_is_the_callers_line():
    port_events.enable()
    tm.MulticlassAccuracy(num_classes=3, device="cpu").update(
        torch.tensor([[0.1, 0.7, 0.2]]), torch.tensor([1]))
    for e in port_events.events("span"):
        assert e.callsite.startswith(__file__ + ":"), e.callsite


# ---------------------------------------------------------------------- CLI
def test_cli_replays_a_jax_dump(tmp_path, capsys):
    dicts = every_kind_dicts(exclude={"tenant_sample", "program_profile"})
    _emit_both(dicts)
    dump = tmp_path / "jax.jsonl"
    jax_telemetry.export_jsonl(str(dump))
    # What the replay must rebuild: the same events in a default-sized,
    # disabled bus.
    reset_all()
    for d in dicts:
        port_events.emit(port_export.event_from_dict(dict(d)))
    want = port_telemetry.report(as_text=True)
    want_prom, want_trace = port_telemetry.prometheus_text(), port_telemetry.to_perfetto()
    reset_all()
    assert port_cli.main([str(dump)]) == 0
    assert capsys.readouterr().out == want
    assert port_cli.main([str(dump), "--prometheus"]) == 0
    assert capsys.readouterr().out == want_prom
    out = tmp_path / "trace.json"
    assert port_cli.main([str(dump), "--perfetto", str(out)]) == 0
    assert json.loads(out.read_text()) == json.loads(json.dumps(want_trace))
    capsys.readouterr()
    traced = next(d["trace_id"] for d in dicts if d.get("trace_id"))
    assert port_cli.main([str(dump), "--trace", traced]) == 0
    assert f"trace {traced}" in capsys.readouterr().out
    assert port_cli.main([str(dump), "--trace", "absent"]) == 1
    assert port_cli.main([str(dump), "--alerts"]) == 1
    assert port_cli.main([str(dump), "--routes"]) == 0
    capsys.readouterr()
    # The dump holds no program profile and no tenant sample: perfscope's
    # table says so, and so does the tenant table.
    assert port_cli.main([str(dump), "--perf"]) == 0
    assert "no profiled programs" in capsys.readouterr().out
    assert port_cli.main([str(dump), "--tenants"]) == 0
    assert capsys.readouterr().out.startswith("tenants: no tenant samples")
    assert port_cli.main([str(tmp_path / "missing.jsonl")]) == 2


def test_fleet_formatters_render_a_one_host_fleet():
    # A one-host fleet: this process's snapshot alone, no collective.
    from torcheval_tpu_torch.telemetry import aggregate

    port_events.enable()
    port_events.record_sync("op", 0.002, 64)
    snap = aggregate.host_snapshot()
    fleet = aggregate.merge_snapshots([snap])
    text = port_export.format_fleet_report(fleet)
    assert text.startswith("torcheval_tpu fleet telemetry (1 hosts)")
    assert "slowest collective: 2.000 ms op on host 0" in text
    trace = port_export.fleet_to_perfetto([snap])
    assert {e["pid"] for e in trace["traceEvents"]} == {0}
    assert port_export.format_explain_perf({}).startswith("torcheval_tpu perfscope")


def test_serve_prometheus_answers_a_scrape():
    port_events.enable()
    port_events.record_sync("op", 0.002, 64)
    server = port_telemetry.serve_prometheus(0)
    try:
        url = f"http://127.0.0.1:{server.server_port}/metrics"
        with urllib.request.urlopen(url, timeout=10) as resp:
            body = resp.read().decode()
    finally:
        server.shutdown()
        server.server_close()
    assert body == port_telemetry.prometheus_text()
    assert 'torcheval_tpu_sync_seconds_count{op="op"} 1' in body


# ------------------------------------------------------------------- flags
_IMPORT_FLAGS = r"""
from torcheval_tpu_torch import telemetry
from torcheval_tpu_torch.resilience import faults
from torcheval_tpu_torch.telemetry import events, flightrec, health, trace
plan = faults.active()
print(events.ENABLED, events.ANNOTATE, events.capacity(), trace.ENABLED, flightrec.ENABLED,
      flightrec._dir, flightrec._recent.maxlen, health.ENABLED, health.RAISE_ON_CORRUPT,
      faults.ENABLED, plan.seed, [r.site for r in plan.rules])
"""


def test_switches_are_read_at_import(tmp_path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("TORCHEVAL_TPU_TORCH_")}
    env.update({
        "TORCHEVAL_TPU_TORCH_TELEMETRY": "1", "TORCHEVAL_TPU_TORCH_TELEMETRY_ANNOTATE": "yes",
        "TORCHEVAL_TPU_TORCH_TELEMETRY_CAPACITY": "77", "TORCHEVAL_TPU_TORCH_TRACE": "on",
        "TORCHEVAL_TPU_TORCH_FLIGHTREC": "true",
        "TORCHEVAL_TPU_TORCH_FLIGHTREC_DIR": str(tmp_path),
        "TORCHEVAL_TPU_TORCH_FLIGHTREC_LAST": "9", "TORCHEVAL_TPU_TORCH_DATA_HEALTH": "1",
        "TORCHEVAL_TPU_TORCH_DATA_HEALTH_RAISE": "1",
        "TORCHEVAL_TPU_TORCH_FAULT_PLAN":
            '{"seed": 5, "rules": [{"site": "collective", "on_attempt": 1}]}',
    })
    proc = subprocess.run([sys.executable, "-c", _IMPORT_FLAGS], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == [
        "True", "True", "77", "True", "True", str(tmp_path), "9", "True", "True", "True",
        "5", "['collective']"]
    env["TORCHEVAL_TPU_TORCH_FAULT_PLAN"] = "{not json"
    proc = subprocess.run([sys.executable, "-c", _IMPORT_FLAGS], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "FAULT_PLAN is not valid JSON" in proc.stderr


def test_flag_parsing_and_snapshot(monkeypatch):
    for name in ("TELEMETRY_CAPACITY", "FLIGHTREC_LAST"):
        default = _flags.INT_FLAGS[name][0]
        assert _flags.get_int(name) == default
        monkeypatch.setenv("TORCHEVAL_TPU_TORCH_" + name, "300")  # not a power of two: fine
        assert _flags.get_int(name) == 300
        for invalid in ("0", "-3", "x"):
            monkeypatch.setenv("TORCHEVAL_TPU_TORCH_" + name, invalid)
            assert _flags.get_int(name) == default
        monkeypatch.delenv("TORCHEVAL_TPU_TORCH_" + name)
    assert _flags.get_str("FLIGHTREC_DIR") is None
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_FLIGHTREC_DIR", "/bundles")
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_FAULT_PLAN", '[{"site": "collective"}]')
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_TRACE", "1")
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_DATA_HEALTH", "0")  # the default: not listed
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_TELEMETRY_CAPACITY", "junk")  # reads as default
    assert _flags.get_json("FAULT_PLAN") == [{"site": "collective"}]
    snap = _flags.snapshot_non_default()
    assert snap == {
        "TORCHEVAL_TPU_TORCH_FLIGHTREC_DIR": "/bundles",
        "TORCHEVAL_TPU_TORCH_FAULT_PLAN": [{"site": "collective"}],
        "TORCHEVAL_TPU_TORCH_TRACE": True,
        "TORCHEVAL_TPU_TORCH_MEGAKERNEL": True,
    }
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_FAULT_PLAN", "{bad")
    with pytest.raises(ValueError, match="not valid JSON"):
        _flags.get_json("FAULT_PLAN")
    assert _flags.snapshot_non_default()["TORCHEVAL_TPU_TORCH_FAULT_PLAN"] == {
        "raw": "{bad", "invalid": True}
    for getter in (_flags.get_str, _flags.get_json):
        with pytest.raises(KeyError):
            getter("TELEMETRY")
