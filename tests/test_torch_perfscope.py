"""The port's perfscope (``torcheval_tpu_torch.telemetry.perfscope``)
against the JAX package's, on the CPU: the SLO metrics and alerts over one
event stream written by JAX's ``export_jsonl``, ``explain_perf`` and its
text (and the CLI's ``--perf``) over that dump, and the port's own pricing
at each hook site: once per ``(program, signature)``, bytes at least the
batch's, ``aliased`` from ``data_ptr`` identity, the ``"donation-verify"``
warning, and nothing at all while perfscope is off.  Pricing values are
not compared with JAX's: XLA's cost model is not a contract."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torcheval_tpu.telemetry as jax_telemetry
from torcheval_tpu.metrics import _rank_state as jax_rank_state
from torcheval_tpu.telemetry import events as jax_events
from torcheval_tpu.telemetry import export as jax_export
from torcheval_tpu.telemetry import perfscope as jax_perfscope

import torcheval_tpu_torch.metrics as tm
import torcheval_tpu_torch.telemetry as telemetry
from torcheval_tpu_torch import _flags, routing
from torcheval_tpu_torch.distributed import LocalWorld
from torcheval_tpu_torch.engine import Evaluator
from torcheval_tpu_torch.engine import scan as engine_scan
from torcheval_tpu_torch.metrics import _rank_state as port_rank_state
from torcheval_tpu_torch.metrics import collection as port_collection
from torcheval_tpu_torch.parallel import make_mesh, shard_batch, sync
from torcheval_tpu_torch.serve import EvalService
from torcheval_tpu_torch.serve import registry as serve_registry
from torcheval_tpu_torch.telemetry import __main__ as port_cli
from torcheval_tpu_torch.telemetry import events as ev
from torcheval_tpu_torch.telemetry import export, perfscope

from tests.test_torch_serve import _batches, _port_suite
from tests.test_torch_telemetry import reset_all

ROOT = Path(__file__).resolve().parents[1]
C = 5


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.delenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", raising=False)
    # The sketch census is process-global: another test's sketch members
    # must not add a line to one package's explain_perf and not the other's.
    monkeypatch.setattr(jax_rank_state, "_CENSUS", {"constructed": 0, "bins": {}})
    monkeypatch.setattr(port_rank_state, "_CENSUS", {"constructed": 0, "bins": {}})
    routing.reset_route_warnings()
    reset_all()
    yield
    reset_all()


def _collection(donate=None):
    return tm.MetricCollection(
        {"acc": tm.MulticlassAccuracy(num_classes=C, average="macro", device="cpu"),
         "f1": tm.MulticlassF1Score(num_classes=C, average="macro", device="cpu")},
        bucket=True, donate=donate,
    )


def _stream(sizes, seed=3):
    rng = np.random.default_rng(seed)
    return [(torch.from_numpy(rng.random((b, C), dtype=np.float32)),
             torch.from_numpy(rng.integers(0, C, b).astype(np.int32))) for b in sizes]


# ------------------------------------------------- one stream, both packages
def _jax_stream():
    """A JAX event stream that moves every SLO metric: retraces, two sync
    op families, engine blocks with stalls, corrupt data, quality readings,
    serve admissions, tenant samples and priced programs with spans."""
    jax_events.enable()
    for _ in range(40):
        jax_events.record_retrace("engine_scan")
    jax_events.record_sync("all_gather_object", 0.010, 128)
    jax_events.record_sync("binary_hist_counts", 0.060, 256)
    for i in range(6):
        jax_events.record_engine_block(8, 8 - i % 2, i % 2)
        jax_events.record_span("engine_block", "Evaluator", 0.004 + 1e-4 * i, 4096)
    for _ in range(5):
        jax_events.record_prefetch_stall(0.002)
    jax_events.record_data_health("nan", "fused_update", "acc", 0, 3)
    jax_events.record_data_health("constant", "fused_update", "", 1, 1)
    jax_events.record_quality("acc", slice_label="s0", window="lifetime", value=0.9, step=3)
    jax_events.record_quality("acc", slice_label="s0", window="decayed", value=0.7, step=3)
    for outcome, reason, wait in (("admitted", "", 0.0), ("admitted", "", 0.0),
                                  ("shed", "tenant-queue-full", 0.0),
                                  ("dispatched", "", 0.004), ("dispatched", "", 0.3)):
        jax_events.record_admission("t0", outcome, reason=reason, policy="reject-newest",
                                    queue_depth=2, wait_s=wait)
    jax_events.record_tenant_sample(
        tenant="t0", submits=3, admitted=2, shed=1, dispatched=2, rows=34,
        wait_p99_s=0.3, shed_rate=1 / 3, device_seconds=2e-4)
    jax_events.record_tenant_sample(
        tenant="t1", submits=1, admitted=1, dispatched=1, rows=17, wait_p99_s=0.01,
        device_seconds=1e-4)
    for program, span in (("fused_collection", ("update", "MetricCollection.fused")),
                          ("mega_collection", None), ("engine_scan", None),
                          ("serve_group", ("update", "EvalService.dispatch")),
                          ("spmd:binary_hist_counts", None)):
        jax_events.record_program_profile(
            program=program, flops=0, bytes_accessed=4096 * (3 if "mega" not in program else 1),
            peak_bytes=8192, temp_bytes=512, argument_bytes=4096, output_bytes=1024,
            batch_bytes=4096, donated=program == "engine_scan", aliased=False)
        if span is not None:
            jax_events.record_span(span[0], span[1], 0.002, 64)


_ALL_RULES = dict(
    retrace_max=32, prefetch_stall_ratio_max=0.5, sync_imbalance_max=4.0,
    data_health_corrupt_max=0, throughput_floor=1e9, roofline_floor_pct=50.0,
    quality_floor=0.8, quality_drop_max=0.1, serve_shed_rate_max=0.2,
    serve_admit_p99_max_s=0.1, tenant_p99_max_s=0.1, tenant_shed_rate_max=0.2,
)


def _replay_into_port(tmp_path):
    dump = tmp_path / "jax.jsonl"
    jax_telemetry.export_jsonl(str(dump))
    ev.enable()
    for event in export.read_jsonl(str(dump)):
        ev.emit(event)
    return dump


def test_slo_metrics_and_alerts_match_jax_on_one_stream(tmp_path):
    _jax_stream()
    _replay_into_port(tmp_path)
    jax_agg, port_agg = jax_events.aggregates(), ev.aggregates()
    assert set(perfscope.SLO_METRICS) == set(jax_perfscope.SLO_METRICS)
    for name, fn in perfscope.SLO_METRICS.items():
        assert fn(port_agg) == jax_perfscope.SLO_METRICS[name](jax_agg), name
    rules = perfscope.default_rules(**_ALL_RULES)
    assert [dataclasses.astuple(r) for r in rules] == [
        dataclasses.astuple(r) for r in jax_perfscope.default_rules(**_ALL_RULES)]
    fired = perfscope.evaluate_slo(rules)
    assert fired == jax_perfscope.evaluate_slo(jax_perfscope.default_rules(**_ALL_RULES))
    assert {f["rule"] for f in fired} >= {"retrace_storm", "data_corrupt", "quality_drop",
                                          "serve_shed_storm", "tenant_p99_max"}
    assert "(tenant 't0')" in next(f["message"] for f in fired if f["rule"] == "tenant_p99_max")
    assert ev.aggregates()["alerts"] == jax_events.aggregates()["alerts"]
    assert telemetry.prometheus_text() == jax_telemetry.prometheus_text()


def test_explain_perf_text_and_cli_match_jax(tmp_path, capsys):
    _jax_stream()
    dump = _replay_into_port(tmp_path)
    got = telemetry.explain_perf(device_kind="cpu")
    want = jax_telemetry.explain_perf(device_kind="cpu")
    assert got == want
    assert set(got["routes"]) == {"fused_collection", "mega_collection", "engine_scan",
                                  "serve_group", "spmd:binary_hist_counts"}
    assert got["routes"]["mega_collection"]["reread_reduction_x"] == 3.0
    text = telemetry.explain_perf(device_kind="cpu", as_text=True)
    assert text == jax_telemetry.explain_perf(device_kind="cpu", as_text=True)
    assert export.format_explain_perf(want) == jax_export.format_explain_perf(want)
    assert telemetry.report()["perf"] == jax_telemetry.report()["perf"]
    reset_all()
    assert port_cli.main([str(dump), "--perf"]) == 0
    assert capsys.readouterr().out == text


def test_rules_validation_and_interval():
    with pytest.raises(ValueError, match="op must be"):
        perfscope.SloRule("r", "retrace_total", ">=", 1.0)
    with pytest.raises(ValueError, match="unknown SLO metric"):
        perfscope.SloRule("r", "no_such_metric", ">", 1.0)
    assert {r.name for r in perfscope.default_rules()} == {
        "retrace_storm", "prefetch_starved", "sync_imbalance", "data_corrupt"}
    with pytest.raises(ValueError, match="slo_every_blocks"):
        perfscope.enable(slo_every_blocks=0)
    ev.enable()
    floor = perfscope.SloRule("floor", "throughput_batches_per_sec", "<", 1e9)
    assert perfscope.evaluate_slo((floor,)) == []  # no block ran: no signal
    assert perfscope.evaluate_slo(()) == [] and perfscope.rules() == ()


# ----------------------------------------------------------------- pricing
def test_event_schema_is_jax_program_profile():
    mine = [f.name for f in dataclasses.fields(ev.ProgramProfileEvent)]
    theirs = [f.name for f in dataclasses.fields(jax_events.ProgramProfileEvent)]
    assert mine == theirs


def test_gate_prices_once_per_program_and_signature():
    ev.enable()
    a = perfscope.begin("p", ("sig", 1))
    assert a is not None and perfscope.begin("p", ("sig", 1)) is None
    assert perfscope.begin("p", ("sig", 2)) is not None
    assert perfscope.begin("q", ("sig", 1)) is not None
    x = torch.zeros(10)
    profile = perfscope.profile_program(
        a, {"m": {"s": x}}, {"m": {"s": x + 1}}, batch_args=(torch.zeros(4, 3),))
    assert profile == {
        "program": "p", "flops": 0, "bytes_accessed": 48 + 40 + 40,
        "peak_bytes": 128, "temp_bytes": 0, "argument_bytes": 88, "output_bytes": 40,
        "batch_bytes": 48, "donated": False, "aliased": False,
    }
    (event,) = ev.events("program_profile")
    assert dataclasses.asdict(event)["bytes_accessed"] == 128
    perfscope.reset()
    assert perfscope.begin("p", ("sig", 1)) is not None


@pytest.mark.parametrize("mode", ["unset", "forced"])
def test_fused_update_is_priced_once_a_signature(monkeypatch, mode):
    if mode == "forced":
        monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "1")
    batches = _stream((40, 100, 200, 130))
    want = _collection()
    for args in batches:
        want.fused_update(*args)
    telemetry.enable()
    perfscope.enable()
    col = _collection()
    for args in batches:
        col.fused_update(*args)
    for name, value in want.state_dict().items():
        assert torch.equal(col.state_dict()[name], value), name
    profiles = ev.events("program_profile")
    program = "mega_collection" if mode == "forced" else "fused_collection"
    # Bucketing pads the four sizes onto two shapes: two priced signatures.
    assert [p.program for p in profiles] == [program] * 2
    for p in profiles:
        assert p.bytes_accessed >= p.batch_bytes > 0 and p.flops == 0
        assert not p.donated and not p.aliased
    route = telemetry.explain_perf()["routes"][program]
    assert route["reread_multiplier"] > 1.0 and route["dispatches"] == len(batches)
    assert route["bound"] in ("bandwidth", "compute", "dispatch")
    assert program in telemetry.explain_perf(as_text=True)
    assert "torcheval_tpu_program_bytes_accessed" in telemetry.prometheus_text()
    assert program in telemetry.report()["perf"]["routes"]


def test_aliased_follows_data_ptr_and_donation_verify_warns(monkeypatch):
    ev.enable()
    perfscope.enable()
    # Forced on, the collection kernel's folds add into the states in
    # place under donation: every state keeps its storage.
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "1")
    col = _collection(donate=True)
    col.fused_update(*_stream((40,))[0])
    (profile,) = ev.events("program_profile")
    assert profile.program == "mega_collection" and profile.donated and profile.aliased
    # Off, each member rebinds its states: donation asked for, nothing
    # aliased, and the verdict is a route-downgrade warning.
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "0")
    col = _collection(donate=True)
    with pytest.warns(routing.RouteDowngradeWarning, match="donation is on"):
        col.fused_update(*_stream((40,))[0])
    profile = ev.events("program_profile")[-1]
    assert profile.program == "fused_collection" and profile.donated and not profile.aliased
    assert telemetry.report()["route_downgrades"]["by_kind"] == {"donation-verify": 1}


def test_engine_is_priced_and_runs_the_slo_rules(monkeypatch):
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "1")
    telemetry.enable()
    always = perfscope.SloRule("always", "prefetch_stall_ratio", ">", -1.0, "fires")
    perfscope.enable(rules=(always,), slo_every_blocks=1)
    ev_ = Evaluator(_collection(), block_size=4, prefetch=False, donate=True)
    ev_.run(_stream((16,) * 8)).result()
    (profile,) = ev.events("program_profile")
    assert profile.program == "mega_scan" and profile.donated and profile.aliased
    assert profile.bytes_accessed >= profile.batch_bytes
    assert ev.aggregates()["alerts"]["always"]["count"] == 2  # two blocks
    route = telemetry.explain_perf()["routes"]["mega_scan"]
    assert route["dispatches"] == 2


def test_sharded_call_is_priced_once_across_ranks():
    telemetry.enable()
    perfscope.enable()
    rng = np.random.default_rng(4)
    s = torch.from_numpy(rng.random((64, C), dtype=np.float32))
    t = torch.from_numpy(rng.integers(0, C, 64).astype(np.int32))

    def rank(group, r):
        mesh = make_mesh(group=group)
        return sync.sharded_multiclass_auroc_histogram(*shard_batch(mesh, s, t), mesh,
                                                       num_bins=64)

    outs = LocalWorld(4).run(rank)
    assert all(torch.equal(o, outs[0]) for o in outs)
    (profile,) = ev.events("program_profile")
    assert profile.program == "spmd:multiclass_hist_counts"
    assert profile.batch_bytes == 16 * C * 4 + 16 * 4
    assert profile.output_bytes == C * 2 * 64 * 4
    syncs = [e for e in ev.events("sync") if e.op == "multiclass_hist_counts"]
    assert len(syncs) == 4 and {e.payload_bytes for e in syncs} == {C * 2 * 64 * 4}
    assert telemetry.explain_perf()["routes"]["spmd:multiclass_hist_counts"]["dispatches"] == 4


def test_serve_group_is_priced_once():
    telemetry.enable()
    perfscope.enable()
    svc = EvalService(group_width=2)
    for tenant in "abc":
        svc.open(tenant, _port_suite())
    for b in _batches(2, seed=8):
        for tenant in "abc":
            svc.submit(tenant, *b)
    svc.pump()
    (profile,) = ev.events("program_profile")
    assert profile.program == "serve_group" and not profile.donated and not profile.aliased
    route = telemetry.explain_perf()["routes"]["serve_group"]
    assert route["dispatches"] == 6 and route["bytes_accessed"] >= route["batch_bytes"]


def test_hook_sites_call_nothing_while_off(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("perfscope was called while off")

    monkeypatch.setattr(perfscope, "begin", boom)
    monkeypatch.setattr(perfscope, "profile_program", boom)
    monkeypatch.setattr(perfscope, "maybe_evaluate_slo", boom)
    for module in (port_collection, engine_scan, sync, serve_registry):
        assert module._perfscope is perfscope
    telemetry.enable()
    col = _collection()
    for args in _stream((40, 100)):
        col.fused_update(*args)
    Evaluator(_collection(), block_size=2, prefetch=False).run(_stream((16,) * 4)).result()
    s, t = _stream((32,))[0]
    LocalWorld(2).run(lambda g, r: sync.sharded_multiclass_auroc_histogram(
        *shard_batch(make_mesh(group=g), s, t), make_mesh(group=g), num_bins=16))
    svc = EvalService()
    svc.open("a", _port_suite())
    svc.submit("a", s, t)
    svc.pump()
    assert ev.events("program_profile") == []
    assert "perf" not in telemetry.report()


# ------------------------------------------------------------ merged trace
def test_profile_merges_host_spans_on_the_profiler_clock(tmp_path):
    telemetry.enable()
    col = _collection()
    with perfscope.profile(str(tmp_path)) as capture:
        col.fused_update(*_stream((40,))[0])
        ev.record_sync("all_gather_object", 0.001, 128)
    assert capture["merged"] == str(tmp_path / "merged_trace.json")
    assert capture["device_trace"] and capture["events"] >= 2
    rows = json.loads(Path(capture["merged"]).read_text())["traceEvents"]
    host_pid = next(r["pid"] for r in rows if r.get("ph") == "M"
                    and r.get("name") == "process_name"
                    and r["args"]["name"] == "torcheval_tpu_torch telemetry")
    host = [r for r in rows if r.get("pid") == host_pid]
    device = [r for r in rows if r.get("pid") != host_pid and r.get("ph") == "X"]
    assert device and host_pid > max(r["pid"] for r in rows
                                      if isinstance(r.get("pid"), int) and r["pid"] != host_pid)
    fused = next(r for r in host if r.get("name") == "MetricCollection.fused.update")
    # One clock: the host span lies inside the profiler's own window, after
    # the clock marker.
    marker = next(r for r in device if r["name"] == perfscope._CLOCK_MARKER)
    last = max(r["ts"] + r.get("dur", 0) for r in device)
    assert marker["ts"] <= fused["ts"] <= fused["ts"] + fused["dur"] <= last + 1e3
    for row in host:
        assert row["ph"] in {"M", "X", "i"} and isinstance(row["tid"], int)


# ---------------------------------------------------------------- switches
_IMPORT = """
from torcheval_tpu_torch.telemetry import perfscope
from torcheval_tpu_torch import _flags
print(perfscope.ENABLED, perfscope.SLO_EVERY_BLOCKS, sorted(_flags.snapshot_non_default()))
"""


def test_switches_are_read_at_import():
    env = {k: v for k, v in os.environ.items() if not k.startswith("TORCHEVAL_TPU_TORCH_")}
    env.update({"TORCHEVAL_TPU_TORCH_PERFSCOPE": "1",
                "TORCHEVAL_TPU_TORCH_PERFSCOPE_SLO_EVERY": "3"})
    proc = subprocess.run([sys.executable, "-c", _IMPORT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[0] == (
        "True 3 ['TORCHEVAL_TPU_TORCH_PERFSCOPE', 'TORCHEVAL_TPU_TORCH_PERFSCOPE_SLO_EVERY']")


def test_new_flags_are_registered(monkeypatch):
    assert _flags.INT_FLAGS["PERFSCOPE_SLO_EVERY"][0] == perfscope.DEFAULT_SLO_EVERY_BLOCKS == 8
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_PERFSCOPE_SLO_EVERY", "-2")
    assert _flags.get_int("PERFSCOPE_SLO_EVERY") == 8
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_TENANT_METERING", "off")
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_SERVE_SPILL_DIR", "/spill")
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_PERFSCOPE", "yes")
    snap = _flags.snapshot_non_default()
    assert snap["TORCHEVAL_TPU_TORCH_TENANT_METERING"] is False
    assert snap["TORCHEVAL_TPU_TORCH_SERVE_SPILL_DIR"] == "/spill"
    assert snap["TORCHEVAL_TPU_TORCH_PERFSCOPE"] is True
    assert "TORCHEVAL_TPU_TORCH_PERFSCOPE_SLO_EVERY" not in snap  # invalid reads as default
