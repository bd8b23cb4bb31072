"""The port's mergeable sketches (``metrics/_sketch.py``,
``Metric.sketch_state`` / ``merge_sketch``) and the flat sketch sync
(``metrics/toolkit.py``'s ``sync_and_compute(sketch=...)``) against the
JAX package's on the same numpy data: every payload array-equal, merges in
every order array-equal, computed values within 1e-6 of JAX's and within
the documented bounds of the exact value.

Mirrors the flat cases of ``tests/resilience/test_fleet_merge.py``
(``SketchMerge``, ``test_sync_and_compute_flat_sketch_path``)."""

import itertools
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
from torcheval_tpu.distributed import LocalWorld as JaxLocalWorld
from torcheval_tpu.metrics import _sketch as jsk
from torcheval_tpu.metrics.toolkit import sync_and_compute as jax_sync_and_compute

import torcheval_tpu_torch.metrics as P
from torcheval_tpu_torch.distributed import LocalWorld
from torcheval_tpu_torch.metrics import _sketch as tsk
from torcheval_tpu_torch.metrics.toolkit import sync_and_compute

CPU = "cpu"
TOL = 1e-6
WORLD = 4


def _data(rank, n=200):
    rng = np.random.default_rng(100 + rank)
    scores = rng.random(n).astype(np.float32)
    targets = (rng.random(n) < scores).astype(np.float32)
    return scores, targets


def _metric(rank, cls=P.BinaryAUROC):
    return cls(device=CPU).update(*_data(rank))


def _jax_metric(rank, cls=J.BinaryAUROC):
    m = cls()
    m.update(*(jnp.asarray(a) for a in _data(rank)))
    return m


def _flat_value(ranks, cls=P.BinaryAUROC):
    metrics = [_metric(r, cls) for r in ranks]
    for m in metrics:
        m._prepare_for_merge_state()
    metrics[0].merge_state(metrics[1:])
    return float(metrics[0].compute())


_ARRAYS = {
    "reservoir": ("keys", "scores", "targets"),
    "histogram": ("pos", "neg"),
    "count": ("pos", "neg"),
    "rank": ("edges", "num_tp", "num_fp", "num_pos", "num_total"),
}


def _same_payload(port, jax_sketch):
    assert type(port).__name__ == type(jax_sketch).__name__
    assert port.metric_kind == jax_sketch.metric_kind and port.nbytes() == jax_sketch.nbytes()
    for name in _ARRAYS[port.kind]:
        got, want = getattr(port, name), getattr(jax_sketch, name)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


_OPTIONS = {
    "reservoir": {"capacity": 128, "seed": 3, "salt": 2},
    "histogram": {"bins": 64},
    "count": {"width": 64, "depth": 5, "seed": 7},
    "rank": {"bins": 32},
}


@pytest.mark.parametrize("cls", ["BinaryAUROC", "BinaryAUPRC"])
@pytest.mark.parametrize("kind", sorted(_OPTIONS))
def test_payloads_array_equal_to_jax(kind, cls):
    port = _metric(0, getattr(P, cls)).sketch_state(kind, **_OPTIONS[kind])
    jax_sketch = _jax_metric(0, getattr(J, cls)).sketch_state(kind, **_OPTIONS[kind])
    _same_payload(port, jax_sketch)
    np.testing.assert_allclose(float(port.compute()), float(jax_sketch.compute()), rtol=0, atol=TOL)
    # A pickled payload is numpy only: it unpickles to the same arrays.
    _same_payload(pickle.loads(pickle.dumps(port)), jax_sketch)


@pytest.mark.parametrize("kind", sorted(_OPTIONS))
def test_merges_in_every_order_array_equal_to_jax(kind):
    opts = _OPTIONS[kind]

    def sketches(lib_metric):
        out = []
        for rank in range(3):
            o = dict(opts, salt=rank) if kind == "reservoir" else opts
            out.append(lib_metric(rank).sketch_state(kind, **o))
        return out

    jax_merged = tsk.merge_sketches(*(lambda s: (s[0], s[1:]))(sketches(_jax_metric)))
    for order in itertools.permutations(range(3)):
        port = sketches(_metric)
        merged = tsk.merge_sketches(port[order[0]], [port[i] for i in order[1:]] + [None])
        _same_payload(merged, jax_merged)


def test_from_samples_equal_to_jax_from_the_same_numpy_data():
    scores, targets = _data(5, n=500)
    for port, jax_sketch in (
        (tsk.ReservoirSketch.from_samples("binary_auroc", scores, targets, capacity=64, seed=1,
                                          salt=4),
         jsk.ReservoirSketch.from_samples("binary_auroc", scores, targets, capacity=64, seed=1,
                                          salt=4)),
        (tsk.HistogramSketch.from_samples("binary_auprc", scores, targets, bins=50),
         jsk.HistogramSketch.from_samples("binary_auprc", scores, targets, bins=50)),
        (tsk.CountSketchState.from_samples("binary_auroc", scores, targets, width=32, depth=3,
                                           bins=256, seed=9),
         jsk.CountSketchState.from_samples("binary_auroc", scores, targets, width=32, depth=3,
                                           bins=256, seed=9)),
        (tsk.RankSketch.from_samples("binary_auprc", scores, targets, bins=16),
         jsk.RankSketch.from_samples("binary_auprc", scores, targets, bins=16)),
    ):
        _same_payload(port, jax_sketch)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tsk.HistogramSketch.from_samples("binary_auroc", scores, targets).compute()


def test_geometry_and_kind_checks():
    a = _metric(0).sketch_state("histogram", bins=64)
    with pytest.raises(ValueError, match="bin-count"):
        a.merge(_metric(1).sketch_state("histogram", bins=32))
    with pytest.raises(TypeError, match="cannot merge"):
        a.merge(_metric(1).sketch_state("rank", bins=64))
    with pytest.raises(ValueError, match="cannot merge a 'binary_auprc'"):
        a.merge(_metric(1, P.BinaryAUPRC).sketch_state("histogram", bins=64))
    with pytest.raises(ValueError, match="geometry"):
        _metric(0).sketch_state("count", seed=1).merge(_metric(1).sketch_state("count", seed=2))
    with pytest.raises(ValueError, match="geometry"):
        _metric(0).sketch_state("rank", bins=16).merge(_metric(1).sketch_state("rank", bins=32))
    with pytest.raises(ValueError, match="sketch kind"):
        _metric(0).sketch_state("bloom")
    with pytest.raises(ValueError, match="num_tasks=1"):
        P.BinaryAUROC(num_tasks=2, device=CPU).sketch_state("histogram")
    with pytest.raises(ValueError, match="only kind='exact'"):
        P.MulticlassAccuracy(device=CPU).sketch_state("histogram")
    with pytest.raises(ValueError, match="only kind='exact'"):
        P.MulticlassAUROC(num_classes=3, device=CPU).sketch_state("rank")


def test_exact_and_reservoir_restore_into_a_metric():
    exact = _metric(0).sketch_state("exact")
    exact.merge(_metric(1).sketch_state("exact"))
    assert float(exact.compute()) == _flat_value(range(2))
    fresh = P.BinaryAUROC(device=CPU).merge_sketch(exact)
    assert float(fresh.compute()) == _flat_value(range(2))
    res = _metric(0).sketch_state("reservoir", capacity=64)
    restored = P.BinaryAUROC(device=CPU).merge_sketch(res)
    assert len(restored.inputs) == 1 and restored.inputs[0].shape == (64,)
    assert float(restored.compute()) == float(res.compute())
    with pytest.raises(NotImplementedError, match="bin-domain"):
        P.BinaryAUROC(device=CPU).merge_sketch(_metric(0).sketch_state("histogram"))
    empty = P.BinaryAUROC(device=CPU).sketch_state("rank", bins=16)
    assert int(empty.num_total[0]) == 0


def _sketch_value(kind, cls=P.BinaryAUROC, **options):
    sketches = []
    for rank in range(WORLD):
        opts = dict(options)
        if kind == "reservoir":
            opts["salt"] = rank
        sketches.append(_metric(rank, cls).sketch_state(kind, **opts))
    return float(tsk.merge_sketches(sketches[0], sketches[1:]).compute())


def test_reservoir_error_bound():
    assert abs(_sketch_value("reservoir", capacity=2048) - _flat_value(range(WORLD))) <= 1e-6
    assert abs(_sketch_value("reservoir", capacity=256) - _flat_value(range(WORLD))) < 0.08


def test_histogram_error_bound():
    assert abs(_sketch_value("histogram", bins=2048) - _flat_value(range(WORLD))) < 0.02
    assert abs(_sketch_value("histogram", P.BinaryAUPRC, bins=2048)
               - _flat_value(range(WORLD), P.BinaryAUPRC)) < 0.02


def test_count_sketch_error_bound():
    assert abs(_sketch_value("count", width=8192, depth=5) - _flat_value(range(WORLD))) < 0.05


def test_sketch_bytes_beat_exact_state_bytes():
    m = P.BinaryAUROC(device=CPU).update(*_data(0, n=4096))
    m._prepare_for_merge_state()
    exact_bytes = tsk.state_nbytes(m)
    jm = _jax_metric(0)
    assert exact_bytes == 4096 * 8
    assert exact_bytes / m.sketch_state("histogram", bins=128).nbytes() > 10.0
    jm._prepare_for_merge_state()
    assert tsk.state_nbytes(P.BinaryAUROC(device=CPU).update(*_data(0))) == jsk.state_nbytes(jm)


@pytest.mark.parametrize("recipient", [0, "all"])
@pytest.mark.parametrize("kind,options", [
    ("histogram", {"bins": 2048}),
    ("reservoir", {"capacity": 2048}),
    ("count", {"width": 8192}),
    ("rank", {"bins": 1024}),
])
def test_sync_and_compute_flat_sketch_path(kind, options, recipient):
    outs = LocalWorld(2).run(lambda g, r: sync_and_compute(
        _metric(r), g, recipient, topology="flat", sketch=kind, sketch_options=options))
    jax_outs = JaxLocalWorld(2).run(lambda g, r: jax_sync_and_compute(
        _jax_metric(r), g, recipient, topology="flat", sketch=kind, sketch_options=options))
    if recipient == 0:
        assert outs[1] is None and jax_outs[1] is None
    else:
        assert float(outs[1]) == float(outs[0])
    assert abs(float(outs[0]) - float(jax_outs[0])) <= TOL
    bound = {"histogram": 0.02, "reservoir": 1e-6, "count": 0.05, "rank": 1 / 1023}[kind]
    assert abs(float(outs[0]) - _flat_value(range(2))) <= bound


def test_flat_rank_sync_of_sketch_mode_metrics_is_the_whole_stream():
    def rank_metric(rank):
        scores, targets = _data(rank, n=500)
        return P.BinaryAUROC(sketch=True, sketch_bins=64, device=CPU).update(scores, targets)

    outs = LocalWorld(WORLD).run(lambda g, r: sync_and_compute(rank_metric(r), g, "all",
                                                               sketch="rank"))
    whole = P.BinaryAUROC(sketch=True, sketch_bins=64, device=CPU)
    for r in range(WORLD):
        whole.update(*_data(r, n=500))
    assert all(torch.equal(o, whole.compute()) for o in outs)
    single = sync_and_compute(rank_metric(0), sketch="rank")  # a world of one
    assert torch.equal(single, rank_metric(0).compute())
