"""The port's data-health monitor against the JAX package's: the same
figures and findings on batches with NaN, +-inf, constant columns,
out-of-range and negative labels, masked pad rows and zero weights; the
same ``data_health`` events from a collection; states bit-equal with the
monitor on and off; one read back an update; and raise-on-corrupt after
the batch is applied.  Everything on the CPU, at small sizes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as jm
from torcheval_tpu.telemetry import health as jax_health

import torcheval_tpu_torch.metrics as tm
from torcheval_tpu_torch.resilience import faults
from torcheval_tpu_torch.telemetry import events as port_events
from torcheval_tpu_torch.telemetry import flightrec
from torcheval_tpu_torch.telemetry import health

from tests.test_torch_telemetry import jax_events, reset_all, stream

C = 6
BOUNDS = (("acc", C), ("wide", 10), ("cm", C))


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.setenv("TORCHEVAL_TPU_MEGAKERNEL", "1")
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "1")
    reset_all()
    yield
    reset_all()


def _case(name, seed=0, n=40):
    rng = np.random.default_rng(seed)
    x = rng.random((n, C)).astype(np.float32)
    y = rng.integers(0, C, n).astype(np.int32)
    w = rng.random(n).astype(np.float32) + 0.5
    mask = None
    if name == "nan_inf":
        x[3, 1], x[7, 2], x[9, 0] = np.nan, np.inf, -np.inf
    elif name == "constant":
        x[:] = 0.25
    elif name == "labels":
        y[[1, 4, 5]] = [C, 9, 12]
        y[[2, 8]] = -1
    elif name == "masked":
        mask = np.ones(n, np.int32)
        mask[-10:] = 0
        x[-10:] = np.nan  # pad rows: never counted
        y[-10:] = 50
        y[0] = C + 1
    elif name == "masked_constant":  # the screen's path: live rows clean and equal
        mask = np.ones(n, np.int32)
        mask[::2] = 0
        x[1::2] = 0.25
        x[::2] = np.nan
        y[::2] = -7
    elif name == "all_masked":
        mask = np.zeros(n, np.int32)
    elif name == "zero_weight":
        w[:] = 0
    elif name == "one_element":
        x, y, w = x[:1, :1], y[:1], w[:1]
    elif name == "empty":
        x, y, w = x[:0], y[:0], w[:0]
    return x, y, w, mask


def _flatten(stats):
    out = {}
    for i, entry in enumerate(stats["args"]):
        if entry is None:
            out[i] = None
            continue
        for k, v in entry.items():
            if k == "ge":
                out[(i, k)] = [int(np.asarray(g)) for g in v]
            else:
                out[(i, k)] = int(np.asarray(v))
    for key in ("live_rows",):
        if key in stats:
            out[key] = int(np.asarray(stats[key]))
    if "weight_total" in stats:
        out["weight_total"] = float(np.asarray(stats["weight_total"]))
    return out


CASES = ["clean", "nan_inf", "constant", "labels", "masked", "masked_constant", "all_masked",
         "zero_weight", "one_element", "empty"]


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("weighted", [False, True])
def test_stats_and_findings_match_jax(name, weighted):
    x, y, w, mask = _case(name)
    if name == "empty":  # the JAX reductions have no identity for min/max of nothing
        port = health.stats_for_update((torch.from_numpy(x), torch.from_numpy(y)), {}, BOUNDS)
        assert health.inspect(port, source="fused_update", bounds=BOUNDS) == []
        return
    kw_j, kw_t = {}, {}
    if mask is not None:
        kw_j["mask"], kw_t["mask"] = jnp.asarray(mask), torch.from_numpy(mask)
    if weighted:
        kw_j["weight"], kw_t["weight"] = jnp.asarray(w), torch.from_numpy(w)
    args_j = (jnp.asarray(x), jnp.asarray(y), "a string")
    args_t = (torch.from_numpy(x), torch.from_numpy(y), "a string")
    want = jax_health.stats_for_update(args_j, kw_j, BOUNDS)
    # The exact figures, JAX's structure.
    figures = health.batch_stats(args_t, kw_t.get("mask"), BOUNDS)
    fw, fg = _flatten(want), _flatten(figures)
    if "weight_total" in fw:
        got_w = float(health._weight_total(kw_t["weight"], kw_t.get("mask")))
        np.testing.assert_allclose(got_w, fw.pop("weight_total"), rtol=1e-6)
    assert fg == fw
    port_events.enable()
    jax_events.enable()
    findings = jax_health.inspect(want, source="fused_update", bounds=BOUNDS)
    # The screen (the hook's path) and the figures fold to JAX's findings.
    screen = health.stats_for_update(args_t, kw_t, BOUNDS)
    assert health.inspect(screen, source="fused_update", bounds=BOUNDS) == findings
    assert stream(port_events.events()) == stream(jax_events.events())
    assert len(port_events.events("data_health")) == len(findings)
    if "weight" not in kw_t:
        assert health.inspect(figures, source="fused_update", bounds=BOUNDS) == findings
    clean = name in ("clean", "one_element") or (name == "zero_weight" and not weighted)
    assert bool(findings) != clean


def _collections(kind_mod, kw, extra):
    return kind_mod.MetricCollection(
        {"acc": kind_mod.MulticlassAccuracy(num_classes=C, **kw),
         "cm": kind_mod.MulticlassConfusionMatrix(C, **kw),
         "f1": kind_mod.MulticlassF1Score(num_classes=C, average="macro", **kw)},
        bucket=True, **extra)


def _bad_stream(seed=3):
    rng = np.random.default_rng(seed)
    out = []
    for n in (50, 77, 128, 33):
        x = rng.random((n, C)).astype(np.float32)
        y = rng.integers(0, C, n).astype(np.int32)
        out.append((x, y))
    out[1][0][4, 2] = np.nan
    out[1][1][[3, 9, 10]] = [C, C + 2, -1]
    out[2][0][:] = 0.5
    return out


def test_collection_findings_match_jax():
    stream_ = _bad_stream()
    for mod, ev, arr, kw, extra, mon in (
        (jm, jax_events, jnp.asarray, {}, {"donate": False}, jax_health),
        (tm, port_events, torch.from_numpy, {"device": "cpu"}, {}, health),
    ):
        mon.enable()
        col = _collections(mod, kw, extra)
        for x, y in stream_:
            col.fused_update(arr(x), arr(y))
        mon.disable()
    got = stream(port_events.events("data_health"))
    assert got == stream(jax_events.events("data_health"))
    assert [dict(e)["check"] for e in got] == ["nan", "label_range", "label_range",
                                               "label_range", "label_range", "constant"]


@pytest.mark.parametrize("megakernel", ["1", "0"])
def test_states_with_the_monitor_on_equal_off(monkeypatch, megakernel):
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", megakernel)
    stream_ = _bad_stream(seed=4)
    cols = []
    for on in (False, True):
        if on:
            health.enable()
        col = _collections(tm, {"device": "cpu"}, {})
        for x, y in stream_:
            col.fused_update(torch.from_numpy(x), torch.from_numpy(y))
        cols.append(col)
        health.disable()
    a, b = (c.state_dict() for c in cols)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def test_one_read_back_and_bounds_once_per_member_set(monkeypatch):
    bounds_calls, cpu_calls = [], []
    real_bounds, real_cpu = health.label_bounds, torch.Tensor.cpu
    monkeypatch.setattr(health, "label_bounds",
                        lambda m: bounds_calls.append(1) or real_bounds(m))

    def counting_cpu(self, *a, **k):
        cpu_calls.append(tuple(self.shape))
        return real_cpu(self, *a, **k)

    health.enable()
    col = _collections(tm, {"device": "cpu"}, {})
    monkeypatch.setattr(torch.Tensor, "cpu", counting_cpu)
    for name in ("clean", "clean", "labels"):
        x, y = _case(name)[:2]
        col.fused_update(torch.from_numpy(x), torch.from_numpy(y))
    monkeypatch.setattr(torch.Tensor, "cpu", real_cpu)
    assert len(bounds_calls) == 1
    # A clean batch: the screen alone, one float64 vector (the scores' and
    # the labels' min and max over the bucketed rows, the live rows).  A
    # flagged batch: the screen, then the exact figures as one int64
    # vector (nan, inf, constant, neg, 3 bounds, live rows).
    assert cpu_calls == [(5,), (5,), (5,), (8,)]
    assert [e.count for e in port_events.events("data_health")] == [2, 3, 3, 3]


def test_the_monitor_off_computes_nothing(monkeypatch):
    monkeypatch.setattr(health, "stats_for_update", lambda *a: pytest.fail("ran while off"))
    col = _collections(tm, {"device": "cpu"}, {})
    x, y = _case("nan_inf")[:2]
    col.fused_update(torch.from_numpy(x), torch.from_numpy(y))
    assert port_events.events() == []


def test_raise_on_corrupt_after_the_batch_is_applied(tmp_path):
    batches = _bad_stream(seed=5)
    plain = _collections(tm, {"device": "cpu"}, {})
    for x, y in batches:
        plain.fused_update(torch.from_numpy(x), torch.from_numpy(y))
    flightrec.enable(dir=str(tmp_path), cooldown_s=0)
    health.enable(raise_on_corrupt=True)
    col = _collections(tm, {"device": "cpu"}, {})
    raised = []
    for x, y in batches:
        try:
            col.fused_update(torch.from_numpy(x), torch.from_numpy(y))
        except health.DataCorruptionError as exc:
            raised.append(exc)
    assert len(raised) == 1
    assert {f["check"] for f in raised[0].findings} == {"nan", "label_range"}
    assert "nan x1 in arg 0" in str(raised[0])
    a, b = plain.state_dict(), col.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    bundles = flightrec.bundles()
    assert len(bundles) == 1 and "data_corruption" in bundles[0]
    assert flightrec.validate_bundle(bundles[0]) == []


def test_corrupt_batch_reaches_the_monitor():
    x, y = _case("clean")[:2]
    bad = faults.corrupt_batch((torch.from_numpy(x), torch.from_numpy(y)))
    health.enable()
    col = _collections(tm, {"device": "cpu"}, {})
    col.fused_update(*bad)
    assert [(e.check, e.count, e.source) for e in port_events.events("data_health")] == [
        ("nan", 1, "fused_update")]


def test_label_bounds_matches_jax():
    port = _collections(tm, {"device": "cpu"}, {})
    jax = _collections(jm, {}, {"donate": False})
    assert health.label_bounds(port._metrics) == jax_health.label_bounds(jax._metrics)
    assert health.label_bounds({"m": tm.Mean(device="cpu")}) == ()
