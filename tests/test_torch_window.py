"""The port's windowed metrics (``WindowedBinaryAUROC``,
``WindowedClickThroughRate``, ``WindowedWeightedCalibration``,
``WindowedMeanSquaredError``, ``WindowedBinaryNormalizedEntropy``) against
the JAX package on the same numpy-seeded batches.

Tolerances: the ring bookkeeping (capacity, cursor, fill level, counters)
is exactly equal after every step.  Rings that hold copies of the inputs
(the AUROC window) and rings whose sums are integer-valued (click counts,
unweighted example and sample counts: exact in float32 in any order) are
bit-equal, as is every state loaded from a JAX ``state_dict`` or reset.
Rings of other float32 sums (entropy, squared error, weighted sums) are
sums taken in another order in the two frameworks and agree within 1e-6
relative (1e-7 absolute), as does every computed figure."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from torcheval_tpu import metrics as jm
from torcheval_tpu_torch import metrics as tm
from torcheval_tpu_torch.convert import state_from_jax
from torcheval_tpu_torch.metrics import MetricCollection
from torcheval_tpu_torch.ops import _build
from torcheval_tpu_torch.utils.test_utils import MetricClassTester

RTOL = 1e-6

# Rings whose columns are copies of the inputs: bit-equal.
_COPY_RINGS = {"inputs", "targets"}


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-7, equal_nan=True)


def _np_state(metric):
    return {k: np.asarray(v) for k, v in metric.state_dict().items()}


def _assert_states(port, ref, exact_all=False):
    got, want = port.state_dict(), _np_state(ref)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["window_bookkeeping"].numpy(), want["window_bookkeeping"])
    for name, value in got.items():
        assert value.dtype in (torch.float32, torch.int64), name
        # A sum of integer values (click counts, unweighted example and
        # sample counts) is exact in float32 in any order: bit-equal too.
        integral = np.array_equal(want[name], np.round(want[name]))
        if exact_all or name in _COPY_RINGS or integral:
            np.testing.assert_array_equal(value.numpy(), want[name], err_msg=name)
        else:
            _close(value, want[name])


def _assert_results(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    else:
        _close(got, want)


def _call(metric, args, kwargs, to):
    return metric.update(*(to(a) for a in args), **{k: to(v) for k, v in kwargs.items()})


def _port(x):
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


def _jax(x):
    return jnp.asarray(x) if isinstance(x, np.ndarray) else x


def _step(port, ref, args, kwargs):
    _call(port, args, kwargs, _port)
    _call(ref, args, kwargs, _jax)


# ---------------------------------------------------------------- batches
def _tasks_shape(num_tasks, n):
    return (n,) if num_tasks == 1 else (num_tasks, n)


def _auroc_batch(rng, num_tasks, n):
    shape = _tasks_shape(num_tasks, n)
    return (rng.random(shape, dtype=np.float32), (rng.random(shape) > 0.5).astype(np.float32)), {}


def _ctr_batch(rng, num_tasks, n, weighted):
    shape = _tasks_shape(num_tasks, n)
    clicks = (rng.random(shape) < 0.3).astype(np.float32)
    if weighted:
        return (clicks, rng.integers(1, 4, shape).astype(np.float32)), {}
    return (clicks,), {}


def _wc_batch(rng, num_tasks, n, weighted):
    shape = _tasks_shape(num_tasks, n)
    x = rng.random(shape, dtype=np.float32)
    y = (rng.random(shape) < 0.4).astype(np.float32)
    if weighted:
        return (x, y, rng.uniform(0.5, 2.0, shape).astype(np.float32)), {}
    return (x, y), {}


def _ne_batch(rng, num_tasks, n, weighted, from_logits=False):
    shape = _tasks_shape(num_tasks, n)
    x = (rng.standard_normal(shape) * 2 if from_logits else rng.uniform(0.01, 0.99, shape))
    y = (rng.random(shape) < 0.4).astype(np.float32)
    kw = {"weight": rng.uniform(0.2, 3.0, shape).astype(np.float32)} if weighted else {}
    return (x.astype(np.float32), y), kw


def _mse_batch(rng, outputs, n, weighted):
    shape = (n,) if outputs == 1 else (n, outputs)
    x = rng.standard_normal(shape).astype(np.float32)
    y = (x + 0.5 * rng.standard_normal(shape)).astype(np.float32)
    kw = {"sample_weight": rng.uniform(0.1, 2.0, n).astype(np.float32)} if weighted else {}
    return (x, y), kw


# Each case: (class name, constructor kwargs, batch(rng, i) -> (args, kwargs)).
_CASES = {
    "ctr": ("WindowedClickThroughRate", {"num_tasks": 3, "max_num_updates": 4},
            lambda rng, i: _ctr_batch(rng, 3, 17 + i, weighted=i % 2 == 1)),
    "ctr_1task": ("WindowedClickThroughRate", {"max_num_updates": 3, "enable_lifetime": False},
                  lambda rng, i: _ctr_batch(rng, 1, 9, weighted=False)),
    "wc": ("WindowedWeightedCalibration", {"num_tasks": 2, "max_num_updates": 4},
           lambda rng, i: _wc_batch(rng, 2, 23, weighted=i % 2 == 0)),
    "wc_1task": ("WindowedWeightedCalibration", {"max_num_updates": 5, "enable_lifetime": False},
                 lambda rng, i: _wc_batch(rng, 1, 11, weighted=True)),
    "ne": ("WindowedBinaryNormalizedEntropy", {"num_tasks": 3, "max_num_updates": 4},
           lambda rng, i: _ne_batch(rng, 3, 31, weighted=i % 2 == 0)),
    "ne_logits": ("WindowedBinaryNormalizedEntropy",
                  {"from_logits": True, "max_num_updates": 3, "enable_lifetime": False},
                  lambda rng, i: _ne_batch(rng, 1, 29, weighted=i % 3 == 0, from_logits=True)),
    "mse_2d_raw": ("WindowedMeanSquaredError",
                   {"multioutput": "raw_values", "max_num_updates": 4},
                   lambda rng, i: _mse_batch(rng, 3, 19, weighted=False)),
    "mse_2d_weighted": ("WindowedMeanSquaredError", {"max_num_updates": 3},
                        lambda rng, i: _mse_batch(rng, 4, 13, weighted=True)),
    "mse_1d": ("WindowedMeanSquaredError",
               {"multioutput": "raw_values", "max_num_updates": 4, "enable_lifetime": False},
               lambda rng, i: _mse_batch(rng, 1, 21, weighted=i % 2 == 1)),
    "auroc": ("WindowedBinaryAUROC", {"num_tasks": 3, "max_num_samples": 50},
              lambda rng, i: _auroc_batch(rng, 3, (20, 20, 7, 33, 64, 13, 49)[i % 7])),
    "auroc_1task": ("WindowedBinaryAUROC", {"max_num_samples": 40},
                    lambda rng, i: _auroc_batch(rng, 1, (15, 15, 15, 40, 3, 90)[i % 6])),
}


def _pair(case):
    name, kw, _ = _CASES[case]
    return getattr(tm, name)(device="cpu", **kw), getattr(jm, name)(**kw)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_updates_that_wrap_match_jax(case):
    """Ten updates: the window wraps at least twice (the AUROC cases also
    take batches of exactly and more than the window)."""
    port, ref = _pair(case)
    batch = _CASES[case][2]
    rng = np.random.default_rng(len(case))
    for i in range(10):
        args, kwargs = batch(rng, i)
        _step(port, ref, args, kwargs)
        _assert_states(port, ref)
        _assert_results(port.compute(), ref.compute())


@pytest.mark.parametrize("case", sorted(_CASES))
def test_merge_with_an_empty_member_reset_and_state_dict(case):
    rng = np.random.default_rng(100 + len(case))
    batch = _CASES[case][2]
    pairs = [_pair(case) for _ in range(4)]  # the last is never updated
    for i in range(9):
        args, kwargs = batch(rng, i)
        _step(*pairs[i % 3], args, kwargs)
    (port, ref), rest = pairs[0], pairs[1:]
    port.merge_state([p for p, _ in rest])
    ref.merge_state([j for _, j in rest])
    _assert_states(port, ref)
    _assert_results(port.compute(), ref.compute())
    # The merged window grew to the sum of the capacities and still updates.
    args, kwargs = batch(rng, 9)
    _step(port, ref, args, kwargs)
    _assert_states(port, ref)
    _assert_results(port.compute(), ref.compute())
    # A state_dict round trip keeps the grown window and its bookkeeping.
    loaded = _pair(case)[0]
    loaded.load_state_dict(port.state_dict())
    _assert_states(loaded, ref)
    _assert_results(loaded.compute(), ref.compute())
    # Reset restores the capacity of construction and empties the window.
    port.reset()
    ref.reset()
    _assert_states(port, ref, exact_all=True)
    _assert_results(port.compute(), ref.compute())


@pytest.mark.parametrize("case", sorted(_CASES))
def test_a_jax_state_dict_continues_mid_wrap(case):
    rng = np.random.default_rng(200 + len(case))
    batch = _CASES[case][2]
    port, ref = _pair(case)
    for i in range(6):
        _call(ref, *batch(rng, i), _jax)
    port.load_state_dict(state_from_jax(_np_state(ref)))
    _assert_states(port, ref, exact_all=True)
    for i in range(6, 10):
        args, kwargs = batch(rng, i)
        _step(port, ref, args, kwargs)
        _assert_states(port, ref)
        _assert_results(port.compute(), ref.compute())


def test_never_updated_computes_empty_as_jax():
    for case in _CASES:
        port, ref = _pair(case)
        got, want = port.compute(), ref.compute()
        got, want = (got, want) if isinstance(want, tuple) else ((got,), (want,))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert tuple(g.shape) == tuple(w.shape) == (0,)
            assert g.dtype == torch.float32 and g.device.type == "cpu"


def test_mse_rows_grow_on_the_first_2d_update_and_merge_into_an_empty_recipient():
    rng = np.random.default_rng(5)
    kw = {"multioutput": "raw_values", "max_num_updates": 3}
    src_p, src_j = tm.WindowedMeanSquaredError(device="cpu", **kw), jm.WindowedMeanSquaredError(**kw)
    assert tuple(src_p.windowed_sum_squared_error.shape) == (1, 3)
    for i in range(2):
        _step(src_p, src_j, *_mse_batch(rng, 5, 8, weighted=bool(i)))
    assert tuple(src_p.windowed_sum_squared_error.shape) == (5, 3)
    assert tuple(src_p.sum_squared_error.shape) == (5,)
    dst_p, dst_j = tm.WindowedMeanSquaredError(device="cpu", **kw), jm.WindowedMeanSquaredError(**kw)
    dst_p.merge_state([src_p])
    dst_j.merge_state([src_j])
    _assert_states(dst_p, dst_j)
    _assert_results(dst_p.compute(), dst_j.compute())
    with pytest.raises(ValueError, match="number of outputs"):
        src_p.update(*(torch.from_numpy(a) for a in _mse_batch(rng, 2, 8, False)[0]))


def test_auroc_window_holds_the_last_samples_and_grows_on_merge():
    rng = np.random.default_rng(6)
    port = tm.WindowedBinaryAUROC(max_num_samples=32, device="cpu")
    seen_s, seen_t = [], []
    for n in (10, 10, 10, 10, 31, 5):
        (s, t), _ = _auroc_batch(rng, 1, n)
        port.update(torch.from_numpy(s), torch.from_numpy(t))
        seen_s.append(s)
        seen_t.append(t)
    ring = port.inputs[0].numpy()
    last = np.concatenate(seen_s)[-32:]
    # The ring holds exactly the last 32 samples, rotated to the cursor.
    np.testing.assert_array_equal(np.roll(ring, -port.next_inserted), last)
    other = tm.WindowedBinaryAUROC(max_num_samples=16, device="cpu")
    other.update(torch.rand(7), torch.randint(0, 2, (7,)).float())
    port.merge_state([other])
    assert port.max_num_samples == 48 and port._num_valid == 39 and port.next_inserted == 39
    assert port.total_samples == 83


def test_rare_positive_window_takes_the_rank_route_like_jax():
    """A 2^15 window with 64 positives a row: the rank-sum route (its plain
    version on the CPU), the same figure as the JAX package within 1e-6."""
    rng = np.random.default_rng(7)
    n = 2**15
    kw = {"num_tasks": 2, "max_num_samples": n}
    port, ref = tm.WindowedBinaryAUROC(device="cpu", **kw), jm.WindowedBinaryAUROC(**kw)
    for _ in range(3):
        s = rng.random((2, n // 2), dtype=np.float32)
        t = np.zeros((2, n // 2), np.float32)
        t[:, rng.choice(n // 2, 32, replace=False)] = 1.0
        _step(port, ref, (s, t), {})
    _build.reset_counts()
    got = port.compute()
    assert _build.PLAIN_CALLS["rank_sum_counts"] == 1
    assert _build.PLAIN_CALLS["auc_from_sorted"] == 0
    _close(got, ref.compute())


def test_input_checks_match_jax():
    with pytest.raises(ValueError, match="num_tasks"):
        tm.WindowedBinaryAUROC(num_tasks=0, device="cpu")
    with pytest.raises(ValueError, match="max_num_samples"):
        tm.WindowedBinaryAUROC(max_num_samples=0, device="cpu")
    with pytest.raises(ValueError, match="max_num_updates"):
        tm.WindowedClickThroughRate(max_num_updates=0, device="cpu")
    with pytest.raises(ValueError, match="max_num_updates"):
        tm.WindowedMeanSquaredError(max_num_updates=0, device="cpu")
    with pytest.raises(ValueError, match="multioutput"):
        tm.WindowedMeanSquaredError(multioutput="bad", device="cpu")
    with pytest.raises(ValueError, match="num_tasks = 2"):
        tm.WindowedBinaryAUROC(num_tasks=2, device="cpu").update(torch.rand(4), torch.ones(4))
    with pytest.raises(ValueError, match="binary"):
        tm.WindowedClickThroughRate(device="cpu").update(torch.tensor([0.5, 1.0]))
    a = tm.WindowedClickThroughRate(device="cpu")
    with pytest.raises(ValueError, match="enable_lifetime"):
        a.merge_state([tm.WindowedClickThroughRate(enable_lifetime=False, device="cpu")])


def test_windowed_classes_default_to_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("WindowedBinaryAUROC", "WindowedClickThroughRate", "WindowedMeanSquaredError",
                 "WindowedBinaryNormalizedEntropy", "WindowedWeightedCalibration"):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            getattr(tm, name)()


class TestFusedUpdateRefusesRingWindows:
    """The port's twin of ``tests/metrics/test_fusable_window.py``'s
    ``TestRingWindowRaises``."""

    def test_fused_update_names_the_windowed_member(self):
        col = MetricCollection({"wctr": tm.WindowedClickThroughRate(device="cpu")})
        with pytest.raises(ValueError, match="windowed member 'wctr'"):
            col.fused_update(torch.tensor([1.0, 0.0, 1.0]))
        # The refusal writes nothing; update() takes the member's own path.
        assert col["wctr"].total_updates == 0
        col.update(torch.tensor([1.0, 0.0, 1.0]))
        assert col["wctr"].total_updates == 1

    def test_check_fusable_names_the_windowed_member(self):
        col = MetricCollection({"wctr": tm.WindowedClickThroughRate(device="cpu")})
        with pytest.raises(ValueError, match="cursor"):
            col._check_fusable()

    def test_buffer_state_member_names_member_and_state(self):
        col = MetricCollection({"auroc": tm.BinaryAUROC(device="cpu")})
        with pytest.raises(ValueError, match="member 'auroc' state"):
            col._check_fusable()


class TestWindowedClasses(MetricClassTester):
    """The class harness (pickle, state_dict, merge, LocalWorld sync) with
    windows larger than everything the harness feeds, so a merge of the
    ranks' windows computes what one sequential window does."""

    def _run(self, name, kw, states, batches):
        want = getattr(jm, name)(**kw)
        for args in batches:
            want.update(*(jnp.asarray(a) for a in args))
        keys = ("input", "target") if len(batches[0]) == 2 else ("input",)
        self.run_class_implementation_tests(
            getattr(tm, name)(device="cpu", **kw),
            states,
            {k: [torch.from_numpy(args[i]) for args in batches] for i, k in enumerate(keys)},
            _expected(want.compute()),
            rtol=1e-6,
        )

    def test_windowed_auroc_harness(self):
        rng = np.random.default_rng(8)
        batches = [_auroc_batch(rng, 2, 16)[0] for _ in range(8)]
        self._run("WindowedBinaryAUROC", {"num_tasks": 2, "max_num_samples": 1000},
                  {"inputs", "targets"}, batches)

    def test_windowed_ctr_harness(self):
        rng = np.random.default_rng(9)
        batches = [_ctr_batch(rng, 2, 16, weighted=False)[0] for _ in range(8)]
        self._run("WindowedClickThroughRate", {"num_tasks": 2, "max_num_updates": 50},
                  {"click_total", "weight_total", "windowed_click_total",
                   "windowed_weight_total"}, batches)


def _expected(result):
    if isinstance(result, tuple):
        return tuple(torch.tensor(np.asarray(r)) for r in result)
    return torch.tensor(np.asarray(result))
