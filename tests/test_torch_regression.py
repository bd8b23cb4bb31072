"""The port's regression metrics (functional ``mean_squared_error`` /
``r2_score``; classes ``MeanSquaredError`` / ``R2Score``) against the JAX
package on the same numpy-seeded float32 inputs.

Tolerances: float32 sums taken in another order in the two frameworks
agree within 1e-6 relative; R² within 1e-5 absolute, since ``tss = Σy² −
(Σy)²/n`` cancels digits that ``1 − rss/tss`` then carries (the two
frameworks already differ there on the same states); sample counts and
error texts exactly."""

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


def _close(got, want, rtol=1e-6, atol=1e-7):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True)


R2_TOL = {"rtol": 0, "atol": 1e-5}


def _data(seed, shape):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    y = (x + 0.5 * rng.standard_normal(shape)).astype(np.float32)
    w = rng.uniform(0.1, 2.0, shape[0]).astype(np.float32)
    return x, y, w


@pytest.mark.parametrize("shape", [(40,), (40, 3)])
@pytest.mark.parametrize("multioutput", ["uniform_average", "raw_values"])
@pytest.mark.parametrize("weighted", [False, True])
def test_mean_squared_error_functional(shape, multioutput, weighted):
    x, y, w = _data(len(shape) + weighted, shape)
    kw = {"multioutput": multioutput}
    want = jF.mean_squared_error(jnp.asarray(x), jnp.asarray(y),
                                 sample_weight=jnp.asarray(w) if weighted else None, **kw)
    got = tF.mean_squared_error(torch.from_numpy(x), torch.from_numpy(y),
                                sample_weight=torch.from_numpy(w) if weighted else None, **kw)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("shape", [(50,), (50, 4)])
@pytest.mark.parametrize("multioutput", ["uniform_average", "raw_values", "variance_weighted"])
@pytest.mark.parametrize("num_regressors", [0, 3])
def test_r2_score_functional(shape, multioutput, num_regressors):
    x, y, _ = _data(7 + len(shape), shape)
    kw = {"multioutput": multioutput, "num_regressors": num_regressors}
    want = jF.r2_score(jnp.asarray(x), jnp.asarray(y), **kw)
    got = tF.r2_score(torch.from_numpy(x), torch.from_numpy(y), **kw)
    assert got.dtype == torch.float32
    _close(got, want, **R2_TOL)


@pytest.mark.parametrize(
    "fn,args,kw",
    [
        ("mean_squared_error", [(3, 2, 2), (3, 2, 2)], {}),
        ("mean_squared_error", [(3,), (4,)], {}),
        ("mean_squared_error", [(3,), (3,)], {"multioutput": "bad"}),
        ("r2_score", [(3,), (3,)], {"multioutput": "bad"}),
        ("r2_score", [(3,), (3,)], {"num_regressors": -1}),
        ("r2_score", [(1,), (1,)], {}),
        ("r2_score", [(5,), (5,)], {"num_regressors": 4}),
        ("r2_score", [(3, 2), (3,)], {}),
    ],
)
def test_errors_match_jax(fn, args, kw):
    arrays = [np.ones(s, np.float32) for s in args]
    with pytest.raises(ValueError) as want:
        getattr(jF, fn)(*(jnp.asarray(a) for a in arrays), **kw)
    with pytest.raises(ValueError) as got:
        getattr(tF, fn)(*(torch.from_numpy(a) for a in arrays), **kw)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError) as got_w:
        tF.mean_squared_error(torch.ones(3), torch.ones(3), sample_weight=torch.ones(4))
    with pytest.raises(ValueError) as want_w:
        jF.mean_squared_error(jnp.ones(3), jnp.ones(3), sample_weight=jnp.ones(4))
    assert str(got_w.value) == str(want_w.value)


def _np_state(metric):
    return {k: np.asarray(v) for k, v in metric.state_dict().items()}


@pytest.mark.parametrize("name", ["MeanSquaredError", "R2Score"])
@pytest.mark.parametrize("shape", [(24,), (24, 3)])
def test_classes_grow_merge_and_load_as_jax(name, shape):
    kw = {"multioutput": "raw_values"}
    pairs = [(getattr(tm, name)(device="cpu", **kw), getattr(jm, name)(**kw)) for _ in range(3)]
    for i in range(6):
        x, y, w = _data(20 + i, shape)
        port, ref = pairs[i % 3]
        extra = {}
        if name == "MeanSquaredError" and i % 2:
            extra = {"sample_weight": w}
        port.update(torch.from_numpy(x), torch.from_numpy(y),
                    **{k: torch.from_numpy(v) for k, v in extra.items()})
        ref.update(jnp.asarray(x), jnp.asarray(y), **{k: jnp.asarray(v) for k, v in extra.items()})
    port, ref = pairs[0]
    port.merge_state([p for p, _ in pairs[1:]])
    ref.merge_state([j for _, j in pairs[1:]])
    tol = R2_TOL if name == "R2Score" else {}
    for k, v in port.state_dict().items():
        assert v.dtype == torch.float32, k
        # R2Score's Σy has mixed signs: within 1e-6 of Σ|y| (~24 here).
        _close(v, np.asarray(getattr(ref, k)), atol=1e-5 if tol else 1e-7)
    _close(port.compute(), ref.compute(), **tol)
    loaded = getattr(tm, name)(device="cpu", **kw)
    loaded.load_state_dict(state_from_jax(_np_state(ref)))
    _close(loaded.compute(), ref.compute(), **tol)
    # A float64 batch leaves float32 states, as with x64 off.
    f64 = getattr(tm, name)(device="cpu").update(torch.rand(shape, dtype=torch.float64),
                                                torch.rand(shape, dtype=torch.float64))
    assert all(v.dtype == torch.float32 for v in f64.state_dict().values())


def test_empty_compute_matches_jax():
    assert np.isnan(float(tm.MeanSquaredError(device="cpu").compute()))
    assert np.isnan(float(jm.MeanSquaredError().compute()))
    with pytest.raises(ValueError, match="at least two samples"):
        tm.R2Score(device="cpu").compute()


class TestRegressionClasses(MetricClassTester):
    def test_mean_squared_error_harness(self):
        batches = [_data(40 + i, (16, 2)) for i in range(8)]
        want = jm.MeanSquaredError()
        for x, y, w in batches:
            want.update(jnp.asarray(x), jnp.asarray(y), sample_weight=jnp.asarray(w))
        self.run_class_implementation_tests(
            tm.MeanSquaredError(device="cpu"),
            {"sum_squared_error", "sum_weight"},
            {"input": [torch.from_numpy(x) for x, _, _ in batches],
             "target": [torch.from_numpy(y) for _, y, _ in batches],
             "sample_weight": [torch.from_numpy(w) for _, _, w in batches]},
            torch.tensor(np.asarray(want.compute())),
            rtol=1e-5,
        )

    def test_r2_score_harness(self):
        batches = [_data(50 + i, (16,)) for i in range(8)]
        want = jm.R2Score()
        for x, y, _ in batches:
            want.update(jnp.asarray(x), jnp.asarray(y))
        self.run_class_implementation_tests(
            tm.R2Score(device="cpu"),
            {"sum_squared_obs", "sum_obs", "sum_squared_residual", "num_obs"},
            {"input": [torch.from_numpy(x) for x, _, _ in batches],
             "target": [torch.from_numpy(y) for _, y, _ in batches]},
            torch.tensor(np.asarray(want.compute())),
            rtol=1e-5,
        )
