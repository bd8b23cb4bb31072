"""The port's binary normalized entropy (functional and class) against the
JAX package on the same numpy-seeded float32 inputs.  The three per-task
sums are float32 sums of float32 terms taken in another order, so states
and values agree within 1e-6 relative; ``num_examples`` without weights is
an integer count and exactly equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu import metrics as jm
from torcheval_tpu.metrics import functional as jF
from torcheval_tpu_torch import metrics as tm
from torcheval_tpu_torch.convert import state_from_jax
from torcheval_tpu_torch.metrics import functional as tF
from torcheval_tpu_torch.metrics.functional import skip_value_checks
from torcheval_tpu_torch.metrics.functional.classification.binary_normalized_entropy import (
    _accum_dtype,
)
from torcheval_tpu_torch.utils.test_utils import MetricClassTester

RTOL = 1e-6


def _batch(rng, shape, from_logits):
    x = rng.standard_normal(shape) * 2 if from_logits else rng.uniform(0.01, 0.99, shape)
    y = (rng.random(shape) < 0.4).astype(np.float32)
    w = rng.uniform(0.2, 3.0, shape).astype(np.float32)
    return x.astype(np.float32), y, w


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(
        np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=rtol, atol=0
    )


@pytest.mark.parametrize("from_logits", [False, True])
@pytest.mark.parametrize("num_tasks", [1, 3])
@pytest.mark.parametrize("weighted", [False, True])
def test_functional_matches_jax(from_logits, num_tasks, weighted):
    rng = np.random.default_rng(10 * num_tasks + from_logits)
    shape = (257,) if num_tasks == 1 else (num_tasks, 257)
    x, y, w = _batch(rng, shape, from_logits)
    kw = {"num_tasks": num_tasks, "from_logits": from_logits}
    got = tF.binary_normalized_entropy(
        torch.from_numpy(x), torch.from_numpy(y),
        weight=torch.from_numpy(w) if weighted else None, **kw)
    want = jF.binary_normalized_entropy(
        jnp.asarray(x), jnp.asarray(y), weight=jnp.asarray(w) if weighted else None, **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    _close(got, want)


@pytest.mark.parametrize("from_logits", [False, True])
@pytest.mark.parametrize("num_tasks", [1, 2])
def test_class_states_merge_and_state_dict(from_logits, num_tasks):
    rng = np.random.default_rng(20 + num_tasks)
    shape = (64,) if num_tasks == 1 else (num_tasks, 64)
    kw = {"num_tasks": num_tasks, "from_logits": from_logits}
    ports = [tm.BinaryNormalizedEntropy(device="cpu", **kw) for _ in range(2)]
    refs = [jm.BinaryNormalizedEntropy(**kw) for _ in range(2)]
    assert ports[0].compute().numel() == 0 and np.asarray(refs[0].compute()).size == 0
    for i in range(4):
        x, y, w = _batch(rng, shape, from_logits)
        weight = w if i % 2 else None
        ports[i % 2].update(torch.from_numpy(x), torch.from_numpy(y),
                            weight=None if weight is None else torch.from_numpy(w))
        refs[i % 2].update(jnp.asarray(x), jnp.asarray(y),
                           weight=None if weight is None else jnp.asarray(w))
    # Member 0 saw unweighted batches only: its example count is an integer.
    np.testing.assert_array_equal(
        ports[0].state_dict()["num_examples"].numpy(), np.asarray(refs[0].num_examples))
    ports[0].merge_state(ports[1:])
    refs[0].merge_state(refs[1:])
    for name, value in ports[0].state_dict().items():
        assert value.dtype == torch.float32 and value.shape == (num_tasks,)
        _close(value, np.asarray(getattr(refs[0], name)))
    _close(ports[0].compute(), refs[0].compute())
    loaded = tm.BinaryNormalizedEntropy(device="cpu", **kw)
    loaded.load_state_dict(state_from_jax(
        {k: np.asarray(v) for k, v in refs[0].state_dict().items()}))
    _close(loaded.compute(), refs[0].compute())
    for name, value in loaded.state_dict().items():
        np.testing.assert_array_equal(value.numpy(), np.asarray(getattr(refs[0], name)))


def test_accum_dtype_is_float32():
    assert _accum_dtype() is torch.float32


@pytest.mark.parametrize(
    "x_shape,y_shape,w_shape,kw",
    [
        ((4,), (5,), None, {}),
        ((4,), (4,), (3,), {}),
        ((2, 4), (2, 4), None, {}),
        ((4,), (4,), None, {"num_tasks": 2}),
        ((3, 4), (3, 4), None, {"num_tasks": 2}),
    ],
)
def test_shape_errors_match_jax(x_shape, y_shape, w_shape, kw):
    x, y = np.full(x_shape, 0.5, np.float32), np.zeros(y_shape, np.float32)
    w = None if w_shape is None else np.ones(w_shape, np.float32)
    with pytest.raises(ValueError) as jax_err:
        jF.binary_normalized_entropy(
            jnp.asarray(x), jnp.asarray(y), weight=None if w is None else jnp.asarray(w), **kw)
    with pytest.raises(ValueError) as port_err:
        tF.binary_normalized_entropy(
            torch.from_numpy(x), torch.from_numpy(y),
            weight=None if w is None else torch.from_numpy(w), **kw)
    assert str(port_err.value) == str(jax_err.value)


def test_probability_range_check_and_its_skip():
    x, y = np.asarray([0.2, 1.5], np.float32), np.asarray([0.0, 1.0], np.float32)
    with pytest.raises(ValueError) as jax_err:
        jF.binary_normalized_entropy(jnp.asarray(x), jnp.asarray(y))
    with pytest.raises(ValueError) as port_err:
        tF.binary_normalized_entropy(torch.from_numpy(x), torch.from_numpy(y))
    assert str(port_err.value) == str(jax_err.value)
    with skip_value_checks():
        tF.binary_normalized_entropy(torch.from_numpy(x), torch.from_numpy(y))
    tF.binary_normalized_entropy(torch.from_numpy(x), torch.from_numpy(y), from_logits=True)
    with pytest.raises(ValueError, match="num_tasks"):
        tm.BinaryNormalizedEntropy(num_tasks=0, device="cpu")


def test_numpy_input_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: numpy input runs there")
    x = np.full(4, 0.5, np.float32)
    with pytest.raises(RuntimeError, match="pass CPU tensors"):
        tF.binary_normalized_entropy(x, x)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tm.BinaryNormalizedEntropy()


class TestBinaryNormalizedEntropyClass(MetricClassTester):
    def test_class_harness_on_a_local_world(self):
        rng = np.random.default_rng(30)
        batches = [_batch(rng, (2, 16), False) for _ in range(8)]
        want = jm.BinaryNormalizedEntropy(num_tasks=2)
        for x, y, w in batches:
            want.update(jnp.asarray(x), jnp.asarray(y), weight=jnp.asarray(w))
        self.run_class_implementation_tests(
            tm.BinaryNormalizedEntropy(num_tasks=2, device="cpu"),
            {"total_entropy", "num_examples", "num_positive"},
            {
                "input": [torch.from_numpy(b[0]) for b in batches],
                "target": [torch.from_numpy(b[1]) for b in batches],
                "weight": [torch.from_numpy(b[2]) for b in batches],
            },
            torch.tensor(np.asarray(want.compute())),
            rtol=1e-5,
            device="cpu",
        )
