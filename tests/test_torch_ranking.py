"""The port's ranking metrics (functional ``frequency_at_k``,
``num_collisions``, ``hit_rate``, ``reciprocal_rank``,
``retrieval_precision`` / ``retrieval_recall``, ``weighted_calibration``;
classes ``HitRate``, ``ReciprocalRank``, ``RetrievalPrecision`` /
``RetrievalRecall``, ``WeightedCalibration``) against the JAX package on
the same numpy-seeded inputs.

Tolerances: indicators, ranks, collision counts, top-k hit counts and the
score buffers built from them are exact (the scores carry ties on a coarse
grid, so the ranking and tie rules are exercised); weighted calibration's
float32 sums agree within 1e-6 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu import metrics as jm
from torcheval_tpu.metrics import functional as jF
from torcheval_tpu_torch import metrics as tm
from torcheval_tpu_torch.convert import state_from_jax
from torcheval_tpu_torch.metrics import functional as tF
from torcheval_tpu_torch.utils.test_utils import MetricClassTester


def _eq(got, want):
    want = np.asarray(want)
    assert got.dtype == torch.from_numpy(np.array(want)).dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


def _scores(seed, n, c):
    rng = np.random.default_rng(seed)
    s = (np.floor(rng.random((n, c)) * 8) / 8).astype(np.float32)  # ties
    t = rng.integers(0, c, n).astype(np.int32)
    return s, t


@pytest.mark.parametrize("k", [None, 1, 3, 10])
def test_hit_rate_and_reciprocal_rank_functionals(k):
    s, t = _scores(k or 0, 50, 7)
    _eq(tF.hit_rate(torch.from_numpy(s), torch.from_numpy(t), k=k),
        jF.hit_rate(jnp.asarray(s), jnp.asarray(t), k=k))
    _eq(tF.reciprocal_rank(torch.from_numpy(s), torch.from_numpy(t), k=k),
        jF.reciprocal_rank(jnp.asarray(s), jnp.asarray(t), k=k))


def test_frequency_and_num_collisions_functionals():
    rng = np.random.default_rng(1)
    freq = rng.random(30).astype(np.float32) * 5
    for k in (0.0, 1.5, 5.0):
        _eq(tF.frequency_at_k(torch.from_numpy(freq), k), jF.frequency_at_k(jnp.asarray(freq), k))
    ids = rng.integers(0, 6, 40).astype(np.int32)
    _eq(tF.num_collisions(torch.from_numpy(ids)), jF.num_collisions(jnp.asarray(ids)))


@pytest.mark.parametrize("num_tasks", [1, 3])
@pytest.mark.parametrize("k,limit", [(None, False), (4, False), (4, True), (40, False), (40, True)])
def test_retrieval_functionals(num_tasks, k, limit):
    rng = np.random.default_rng(num_tasks * 100 + (k or 0) + limit)
    shape = (20,) if num_tasks == 1 else (num_tasks, 20)
    s = (np.floor(rng.random(shape) * 5) / 5).astype(np.float32)  # ties at the cut
    t = (rng.random(shape) < 0.4).astype(np.int32)
    kw = {"limit_k_to_size": limit, "num_tasks": num_tasks}
    for name in ("retrieval_precision", "retrieval_recall"):
        got = getattr(tF, name)(torch.from_numpy(s), torch.from_numpy(t), k, **kw)
        want = getattr(jF, name)(jnp.asarray(s), jnp.asarray(t), k, **kw)
        _eq(got, want)


@pytest.mark.parametrize("num_tasks", [1, 2])
@pytest.mark.parametrize("weight", ["scalar", "array"])
def test_weighted_calibration_functional(num_tasks, weight):
    rng = np.random.default_rng(num_tasks)
    shape = (25,) if num_tasks == 1 else (num_tasks, 25)
    x = rng.random(shape).astype(np.float32)
    y = (rng.random(shape) < 0.5).astype(np.float32)
    w = 0.7 if weight == "scalar" else rng.uniform(0.1, 2, shape).astype(np.float32)
    got = tF.weighted_calibration(torch.from_numpy(x), torch.from_numpy(y),
                                  w if weight == "scalar" else torch.from_numpy(w),
                                  num_tasks=num_tasks)
    want = jF.weighted_calibration(jnp.asarray(x), jnp.asarray(y),
                                   w if weight == "scalar" else jnp.asarray(w),
                                   num_tasks=num_tasks)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize(
    "fn,args,kw",
    [
        ("hit_rate", [(4, 3), (4, 2)], {}),
        ("hit_rate", [(4,), (4,)], {}),
        ("hit_rate", [(4, 3), (5,)], {}),
        ("hit_rate", [(4, 3), (4,)], {"k": 0}),
        ("reciprocal_rank", [(4, 3), (3,)], {}),
        ("frequency_at_k", [(4, 2)], {"k": 1.0}),
        ("frequency_at_k", [(4,)], {"k": -1.0}),
        ("num_collisions", [(4, 2)], {}),
        ("retrieval_precision", [(4,), (5,)], {}),
        ("retrieval_precision", [(4,), (4,)], {"k": 0}),
        ("retrieval_recall", [(4,), (4,)], {"limit_k_to_size": True}),
        ("retrieval_recall", [(2, 4), (2, 4)], {}),
        ("retrieval_recall", [(2, 4), (2, 4)], {"num_tasks": 3}),
        ("weighted_calibration", [(4,), (5,)], {}),
        ("weighted_calibration", [(2, 4), (2, 4)], {}),
        ("weighted_calibration", [(4,), (4,)], {"num_tasks": 2}),
    ],
)
def test_errors_match_jax(fn, args, kw):
    arrays = [np.zeros(s, np.int32) for s in args]
    with pytest.raises(ValueError) as want:
        getattr(jF, fn)(*(jnp.asarray(a) for a in arrays), **kw)
    with pytest.raises(ValueError) as got:
        getattr(tF, fn)(*(torch.from_numpy(a) for a in arrays), **kw)
    assert str(got.value) == str(want.value)


def test_value_errors_match_jax():
    for bad in (
        lambda F, a: F.num_collisions(a(np.zeros(3, np.float32))),
        lambda F, a: F.retrieval_precision(a(np.zeros(3, np.float32)), a(np.array([0, 2, 1]))),
        lambda F, a: F.weighted_calibration(a(np.zeros(3, np.float32)), a(np.zeros(3, np.float32)),
                                            a(np.ones(4, np.float32))),
    ):
        with pytest.raises(ValueError) as want:
            bad(jF, jnp.asarray)
        with pytest.raises(ValueError) as got:
            bad(tF, torch.from_numpy)
        # The texts name the dtype and print the weight, each in its
        # framework's own repr; the rest is the same.
        got_text = str(got.value).replace("torch.float32", "float32").split(" Got ")[0]
        assert got_text == str(want.value).split(" Got ")[0]


def _np_state(metric):
    return {k: [np.asarray(a) for a in v] if isinstance(v, list) else np.asarray(v)
            for k, v in metric.state_dict().items()}


@pytest.mark.parametrize(
    "name,kw",
    [("HitRate", {"k": 2}), ("ReciprocalRank", {"k": 3}), ("ReciprocalRank", {}),
     ("RetrievalPrecision", {"k": 4}), ("RetrievalRecall", {"k": 4, "num_tasks": 2})],
)
def test_buffer_classes_merge_and_load_as_jax(name, kw):
    pairs = [(getattr(tm, name)(device="cpu", **kw), getattr(jm, name)(**kw)) for _ in range(2)]
    assert pairs[0][0].compute().shape == (0,)
    for i in range(4):
        if name.startswith("Retrieval"):
            rng = np.random.default_rng(i)
            shape = (12,) if kw.get("num_tasks", 1) == 1 else (kw["num_tasks"], 12)
            s = (np.floor(rng.random(shape) * 4) / 4).astype(np.float32)
            t = (rng.random(shape) < 0.5).astype(np.int32)
            t[..., 0] = 1  # at least one relevant candidate a query
        else:
            s, t = _scores(30 + i, 10, 5)
        port, ref = pairs[i % 2]
        port.update(torch.from_numpy(s), torch.from_numpy(t))
        ref.update(jnp.asarray(s), jnp.asarray(t))
    port, ref = pairs[0]
    port.merge_state([pairs[1][0]])
    ref.merge_state([pairs[1][1]])
    _eq(port.compute(), ref.compute())
    loaded = getattr(tm, name)(device="cpu", **kw)
    loaded.load_state_dict(state_from_jax(_np_state(ref)))
    _eq(loaded.compute(), ref.compute())


@pytest.mark.parametrize("num_tasks", [1, 2])
def test_weighted_calibration_class(num_tasks):
    pairs = [(tm.WeightedCalibration(num_tasks=num_tasks, device="cpu"),
              jm.WeightedCalibration(num_tasks=num_tasks)) for _ in range(2)]
    assert np.isnan(pairs[0][0].compute().numpy()).all()
    rng = np.random.default_rng(num_tasks)
    shape = (15,) if num_tasks == 1 else (num_tasks, 15)
    for i in range(4):
        x = rng.random(shape).astype(np.float32)
        y = (rng.random(shape) < 0.5).astype(np.float32)
        w = [0.5, 2, rng.uniform(0.1, 2, shape).astype(np.float32), 1.0][i]
        port, ref = pairs[i % 2]
        port.update(torch.from_numpy(x), torch.from_numpy(y),
                    torch.from_numpy(w) if isinstance(w, np.ndarray) else w)
        ref.update(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w) if isinstance(w, np.ndarray) else w)
    port, ref = pairs[0]
    port.merge_state([pairs[1][0]])
    ref.merge_state([pairs[1][1]])
    for k, v in port.state_dict().items():
        assert v.dtype == torch.float32 and v.shape == (num_tasks,)
        np.testing.assert_allclose(v.numpy(), np.asarray(getattr(ref, k)), rtol=1e-6)
    np.testing.assert_allclose(port.compute().numpy(), np.asarray(ref.compute()), rtol=1e-6)
    loaded = tm.WeightedCalibration(num_tasks=num_tasks, device="cpu")
    loaded.load_state_dict(state_from_jax(_np_state(ref)))
    np.testing.assert_array_equal(loaded.compute().numpy(), np.asarray(ref.compute()))
    f64 = tm.WeightedCalibration(device="cpu").update(torch.rand(5, dtype=torch.float64),
                                                      torch.rand(5, dtype=torch.float64))
    assert all(v.dtype == torch.float32 for v in f64.state_dict().values())


class TestRankingClasses(MetricClassTester):
    def test_hit_rate_harness(self):
        batches = [_scores(60 + i, 16, 6) for i in range(8)]
        want = np.concatenate([np.asarray(jF.hit_rate(jnp.asarray(s), jnp.asarray(t), k=2))
                               for s, t in batches])
        self.run_class_implementation_tests(
            tm.HitRate(k=2, device="cpu"),
            {"scores"},
            {"input": [torch.from_numpy(s) for s, _ in batches],
             "target": [torch.from_numpy(t) for _, t in batches]},
            torch.from_numpy(want),
        )

    def test_weighted_calibration_harness(self):
        rng = np.random.default_rng(70)
        xs = [rng.random(16).astype(np.float32) for _ in range(8)]
        ys = [(rng.random(16) < 0.5).astype(np.float32) for _ in range(8)]
        want = jm.WeightedCalibration()
        for x, y in zip(xs, ys):
            want.update(jnp.asarray(x), jnp.asarray(y))
        self.run_class_implementation_tests(
            tm.WeightedCalibration(device="cpu"),
            {"weighted_input_sum", "weighted_target_sum"},
            {"input": [torch.from_numpy(x) for x in xs],
             "target": [torch.from_numpy(y) for y in ys]},
            torch.tensor(np.asarray(want.compute())),
            rtol=1e-5,
        )
