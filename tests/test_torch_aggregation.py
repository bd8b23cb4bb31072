"""The port's aggregation metrics (functional ``auc``, ``click_through_rate``,
``mean``, ``sum``, ``throughput``; classes ``AUC``, ``Cat``,
``ClickThroughRate``, ``Max``, ``Min``, ``Mean``, ``Sum``, ``Throughput``)
against the JAX package on the same numpy-seeded float32 inputs.

Tolerances: ``Cat``, ``Max``, ``Min``, click counts and every sum of
integers are exact; float32 sums are taken in another order in the two
frameworks and agree within 1e-6 relative."""

import logging

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

RTOL = 1e-6


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _np_state(metric):
    return {
        k: [np.asarray(a) for a in v] if isinstance(v, list) else np.asarray(v)
        for k, v in metric.state_dict().items()
    }


# ----------------------------------------------------------------- functional


@pytest.mark.parametrize("weight", [1.0, 2, 0.3, "array"])
def test_mean_and_sum_functionals(weight):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((5, 7)).astype(np.float32)
    w = rng.uniform(0.1, 2, (5, 7)).astype(np.float32)
    pw, jw = (_t(w), jnp.asarray(w)) if weight == "array" else (weight, weight)
    for name in ("mean", "sum"):
        got = getattr(tF, name)(_t(x), pw)
        assert got.dtype == torch.float32
        _close(got, getattr(jF, name)(jnp.asarray(x), jw))
    # A numpy weight beside a tensor input is taken too.
    if weight == "array":
        _close(tF.mean(_t(x), w), jF.mean(jnp.asarray(x), jw))
        _close(tF.sum(_t(x), w), jF.sum(jnp.asarray(x), jw))


def test_sum_of_integers_is_exact():
    x = np.arange(-50, 1000, dtype=np.int32)
    got, want = tF.sum(_t(x)), jF.sum(jnp.asarray(x))
    assert float(got) == float(want) == float(x.sum())
    assert float(tF.sum(_t(x), 3)) == float(jF.sum(jnp.asarray(x), 3))


@pytest.mark.parametrize("name", ["mean", "sum"])
def test_weight_errors_match_jax(name):
    x = np.zeros((2, 3), np.float32)
    for bad in (np.zeros(3, np.float32), "w", [1.0] * 6):
        jbad = jnp.asarray(bad) if isinstance(bad, np.ndarray) else bad
        pbad = _t(bad) if isinstance(bad, np.ndarray) else bad
        with pytest.raises(ValueError) as jax_err:
            getattr(jF, name)(jnp.asarray(x), jbad)
        with pytest.raises(ValueError) as port_err:
            getattr(tF, name)(_t(x), pbad)
        if not isinstance(bad, np.ndarray):  # an array prints by its framework
            assert str(port_err.value) == str(jax_err.value)
        assert "Weight must be either a float value" in str(port_err.value)


@pytest.mark.parametrize("reorder", [True, False])
@pytest.mark.parametrize("num_tasks", [1, 3])
def test_auc_functional(reorder, num_tasks):
    rng = np.random.default_rng(2)
    shape = (40,) if num_tasks == 1 else (num_tasks, 40)
    x = np.round(rng.random(shape), 1).astype(np.float32)  # ties in x
    if not reorder:
        x = np.sort(x, axis=-1)
    y = rng.random(shape).astype(np.float32)
    got = tF.auc(_t(x), _t(y), reorder=reorder, num_tasks=num_tasks)
    want = jF.auc(jnp.asarray(x), jnp.asarray(y), reorder=reorder, num_tasks=num_tasks)
    assert got.dtype == torch.float32
    _close(got, want, 1e-5)  # differences of neighbours cancel: a wider bound
    for shapes in (((4,), (5,)), ((2, 4), (2, 4))):
        a, b = np.zeros(shapes[0], np.float32), np.zeros(shapes[1], np.float32)
        with pytest.raises(ValueError) as jax_err:
            jF.auc(jnp.asarray(a), jnp.asarray(b))
        with pytest.raises(ValueError) as port_err:
            tF.auc(_t(a), _t(b))
        assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError) as jax_err:
        jF.auc(jnp.zeros(4), jnp.zeros(4), num_tasks=2)
    with pytest.raises(ValueError) as port_err:
        tF.auc(torch.zeros(4), torch.zeros(4), num_tasks=2)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("weights", [1.0, 3, 0.25, "vector", "matrix", "scalar tensor"])
@pytest.mark.parametrize("num_tasks", [1, 2])
def test_click_through_rate_functional(weights, num_tasks):
    rng = np.random.default_rng(3)
    shape = (50,) if num_tasks == 1 else (num_tasks, 50)
    clicks = (rng.random(shape) < 0.3).astype(np.float32)
    if weights == "vector":
        w = rng.uniform(0.5, 2, (50,)).astype(np.float32)
    elif weights == "matrix":
        w = rng.uniform(0.5, 2, shape).astype(np.float32)
    elif weights == "scalar tensor":
        w = np.asarray(1.5, np.float32)
    else:
        w = weights
    pw, jw = (_t(w), jnp.asarray(w)) if isinstance(w, np.ndarray) else (w, w)
    got = tF.click_through_rate(_t(clicks), pw, num_tasks=num_tasks)
    want = jF.click_through_rate(jnp.asarray(clicks), jw, num_tasks=num_tasks)
    assert got.dtype == torch.float32
    _close(got, want)
    if not isinstance(w, np.ndarray):  # integer counts times one scalar: exact
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_click_through_rate_errors_match_jax():
    cases = [
        (np.zeros((2, 3), np.float32), 1.0, 1),
        (np.zeros(3, np.float32), 1.0, 2),
        (np.zeros(3, np.float32), np.ones(4, np.float32), 1),
        (np.asarray([0.0, 2.0], np.float32), 1.0, 1),
    ]
    for clicks, w, tasks in cases:
        pw, jw = (_t(w), jnp.asarray(w)) if isinstance(w, np.ndarray) else (w, w)
        with pytest.raises(ValueError) as jax_err:
            jF.click_through_rate(jnp.asarray(clicks), jw, num_tasks=tasks)
        with pytest.raises(ValueError) as port_err:
            tF.click_through_rate(_t(clicks), pw, num_tasks=tasks)
        assert str(port_err.value) == str(jax_err.value)


def test_throughput_functional():
    got, want = tF.throughput(640, 2.5), jF.throughput(640, 2.5)
    assert float(got) == float(want) == 256.0
    for args in ((-1, 1.0), (1, 0.0)):
        with pytest.raises(ValueError) as jax_err:
            jF.throughput(*args)
        with pytest.raises(ValueError) as port_err:
            tF.throughput(*args)
        assert str(port_err.value) == str(jax_err.value)


def test_numpy_input_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: numpy input runs there")
    x = np.zeros(4, np.float32)
    for fn, args in [(tF.mean, (x,)), (tF.sum, (x,)), (tF.auc, (x, x)),
                     (tF.click_through_rate, (x,))]:
        with pytest.raises(RuntimeError, match="pass CPU tensors"):
            fn(*args)
    for cls in (tm.Mean, tm.Sum, tm.Max, tm.Min, tm.Cat, tm.AUC, tm.Throughput,
                tm.ClickThroughRate):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            cls()


# -------------------------------------------------------------------- classes


def _pair(name, **kw):
    return getattr(tm, name)(device="cpu", **kw), getattr(jm, name)(**kw)


def _feed(pairs, batches):
    """Deal ``batches`` (tuples of numpy arrays or numbers) to the
    (port, jax) pairs in turn."""
    for i, args in enumerate(batches):
        port, ref = pairs[i % len(pairs)]
        port.update(*(_t(a) if isinstance(a, np.ndarray) else a for a in args))
        ref.update(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))


def _merge(pairs):
    pairs[0][0].merge_state([p for p, _ in pairs[1:]])
    pairs[0][1].merge_state([j for _, j in pairs[1:]])
    return pairs[0]


@pytest.mark.parametrize("name", ["Max", "Min"])
def test_max_min_exact(name):
    rng = np.random.default_rng(4)
    pairs = [_pair(name) for _ in range(3)]
    assert float(pairs[0][0].compute()) == float(pairs[0][1].compute())  # -inf / +inf
    _feed(pairs, [(rng.standard_normal((3, 5)).astype(np.float32),) for _ in range(6)])
    port, ref = _merge(pairs)
    assert port.compute().dtype == torch.float32
    np.testing.assert_array_equal(port.compute().numpy(), np.asarray(ref.compute()))
    loaded = getattr(tm, name)(device="cpu")
    loaded.load_state_dict(state_from_jax(_np_state(ref)))
    assert torch.equal(loaded.compute(), port.compute())


@pytest.mark.parametrize("name", ["Mean", "Sum"])
def test_mean_sum_classes(name, caplog):
    rng = np.random.default_rng(5)
    pairs = [_pair(name) for _ in range(2)]
    with caplog.at_level(logging.WARNING):
        assert float(pairs[0][0].compute()) == float(pairs[0][1].compute()) == 0.0
    if name == "Mean":
        assert any("No calls to update()" in r.message and "torcheval_tpu_torch" in r.name
                   for r in caplog.records)
    batches = []
    for i in range(6):
        x = rng.standard_normal(33).astype(np.float32)
        w = [1.0, 0.3, 2, rng.uniform(0.1, 2, 33).astype(np.float32)][i % 4]
        batches.append((x, w))
    _feed(pairs, batches)
    port, ref = _merge(pairs)
    for k, v in port.state_dict().items():
        assert v.dtype == torch.float32
        _close(v, np.asarray(getattr(ref, k)))
    _close(port.compute(), ref.compute())
    loaded = getattr(tm, name)(device="cpu")
    loaded.load_state_dict(state_from_jax(_np_state(ref)))
    _close(loaded.compute(), ref.compute(), 0)
    with pytest.raises(ValueError, match="Weight must be either a float value"):
        port.update(torch.zeros(3), torch.zeros(4))


def test_mean_weights_state_is_exact_for_scalar_weights():
    port, ref = _pair("Mean")
    for w, n in [(0.3, 7), (1.0, 5), (2, 11)]:
        port.update(torch.ones(n), w)
        ref.update(jnp.ones(n), w)
    np.testing.assert_array_equal(port.weights.numpy(), np.asarray(ref.weights))
    np.testing.assert_array_equal(port.weighted_sum.numpy(), np.asarray(ref.weighted_sum))


@pytest.mark.parametrize("dim", [0, 1])
def test_cat_exact(dim):
    rng = np.random.default_rng(6)
    pairs = [_pair("Cat", dim=dim) for _ in range(2)]
    assert pairs[0][0].compute().shape == (0,)
    shapes = [(2, 3), (4, 3), (1, 3)] if dim == 0 else [(2, 3), (2, 1), (2, 5)]
    _feed(pairs, [(rng.standard_normal(s).astype(np.float32),) for s in shapes])
    for port, _ in pairs:
        port._prepare_for_merge_state()
        assert len(port.inputs) == 1
    port, ref = _merge(pairs)
    np.testing.assert_array_equal(port.compute().numpy(), np.asarray(ref.compute()))
    loaded = tm.Cat(dim=dim, device="cpu")
    loaded.load_state_dict(state_from_jax(_np_state(ref)))
    np.testing.assert_array_equal(loaded.compute().numpy(), np.asarray(ref.compute()))


@pytest.mark.parametrize("num_tasks", [1, 2])
@pytest.mark.parametrize("reorder", [True, False])
def test_auc_class(num_tasks, reorder):
    rng = np.random.default_rng(7)
    kw = {"num_tasks": num_tasks, "reorder": reorder}
    pairs = [_pair("AUC", **kw) for _ in range(2)]
    empty = pairs[0][0].compute()
    assert tuple(empty.shape) == np.asarray(pairs[0][1].compute()).shape
    assert not empty.any()
    shape = (9,) if num_tasks == 1 else (num_tasks, 9)
    _feed(pairs, [(rng.random(shape).astype(np.float32), rng.random(shape).astype(np.float32))
                  for _ in range(4)])
    port, ref = _merge(pairs)
    for g, w in zip(port.x + port.y, ref.x + ref.y):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))  # buffers exact
    _close(port.compute(), ref.compute(), 1e-5)
    loaded = tm.AUC(device="cpu", **kw)
    loaded.load_state_dict(state_from_jax(_np_state(ref)))
    _close(loaded.compute(), ref.compute(), 1e-5)
    with pytest.raises(ValueError, match="num_tasks"):
        tm.AUC(num_tasks=0, device="cpu")


@pytest.mark.parametrize("num_tasks", [1, 3])
def test_click_through_rate_class(num_tasks):
    rng = np.random.default_rng(8)
    pairs = [_pair("ClickThroughRate", num_tasks=num_tasks) for _ in range(2)]
    assert np.isnan(pairs[0][0].compute().numpy()).all()
    shape = (20,) if num_tasks == 1 else (num_tasks, 20)
    batches = []
    for i in range(6):
        clicks = (rng.random(shape) < 0.4).astype(np.float32)
        w = [1.0, 2, rng.uniform(0.5, 2, shape).astype(np.float32)][i % 3]
        batches.append((clicks, w))
    _feed(pairs, batches)
    port, ref = _merge(pairs)
    for k, v in port.state_dict().items():
        assert v.dtype == torch.float32 and v.shape == (num_tasks,)
        _close(v, np.asarray(getattr(ref, k)))
    _close(port.compute(), ref.compute())
    loaded = tm.ClickThroughRate(num_tasks=num_tasks, device="cpu")
    loaded.load_state_dict(state_from_jax(_np_state(ref)))
    _close(loaded.compute(), ref.compute(), 0)
    ints = tm.ClickThroughRate(device="cpu").update(torch.tensor([1, 0, 1, 1]))
    assert float(ints.compute()) == 0.75 and ints.click_total.dtype == torch.float32


def test_throughput_class(caplog):
    pairs = [_pair("Throughput") for _ in range(3)]
    with caplog.at_level(logging.WARNING):
        assert float(pairs[0][0].compute()) == 0.0
    _feed(pairs, [(64, 0.5), (128, 2.0), (32, 0.25), (64, 1.0)])
    port, ref = _merge(pairs)
    # counts add, the slowest rank's elapsed time gates
    np.testing.assert_array_equal(port.num_total.numpy(), np.asarray(ref.num_total))
    np.testing.assert_array_equal(port.elapsed_time_sec.numpy(), np.asarray(ref.elapsed_time_sec))
    assert float(port.compute()) == float(ref.compute()) == 288 / 2.0
    for args in ((-1, 1.0), (1, -0.5)):
        with pytest.raises(ValueError) as jax_err:
            ref.update(*args)
        with pytest.raises(ValueError) as port_err:
            port.update(*args)
        assert str(port_err.value) == str(jax_err.value)


class TestAggregationClasses(MetricClassTester):
    def test_mean_harness_on_a_local_world(self):
        rng = np.random.default_rng(9)
        xs = [rng.standard_normal(16).astype(np.float32) for _ in range(8)]
        ws = [rng.uniform(0.1, 2, 16).astype(np.float32) for _ in range(8)]
        want = jm.Mean()
        for x, w in zip(xs, ws):
            want.update(jnp.asarray(x), jnp.asarray(w))
        self.run_class_implementation_tests(
            tm.Mean(device="cpu"),
            {"weighted_sum", "weights"},
            {"input": [_t(x) for x in xs], "weight": [_t(w) for w in ws]},
            torch.tensor(np.asarray(want.compute())),
            rtol=1e-5,
            device="cpu",
        )

    def test_cat_harness_on_a_local_world(self):
        xs = [np.arange(4, dtype=np.float32) + 10 * i for i in range(8)]
        self.run_class_implementation_tests(
            tm.Cat(device="cpu"),
            {"inputs"},
            {"input": [_t(x) for x in xs]},
            torch.from_numpy(np.concatenate(xs)),
            device="cpu",
        )
