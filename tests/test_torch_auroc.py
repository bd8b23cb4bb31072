"""The port's functional AUROC against the JAX package's on the same
inputs: 1e-6 (both routes are exact integer-count formulations; only the
final f32 division and the macro mean round), the same errors, and the
route the data calls for (the JAX package on CPU always sorts)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.metrics.functional import (
    binary_auroc as jax_binary_auroc,
    multiclass_auroc as jax_multiclass_auroc,
)
from torcheval_tpu_torch.metrics.functional import (
    binary_auroc,
    multiclass_auroc,
    skip_value_checks,
)
from torcheval_tpu_torch.ops import _build

ATOL = 1e-6


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=ATOL)


def _multiclass_data(seed, n, c, levels=None):
    rng = np.random.default_rng(seed)
    s = rng.random((n, c)).astype(np.float32)
    if levels:
        s = (np.floor(s * levels) / levels).astype(np.float32)
    return s, rng.integers(0, c, n).astype(np.int32)


@pytest.mark.parametrize(
    "shape,num_tasks,p",
    [((300,), 1, 0.4), ((3, 200), 3, 0.4), ((2**15,), 1, 0.004), ((2, 2**15), 2, 0.996)],
    ids=["1d-sort", "tasks-sort", "1d-rare-pos", "tasks-rare-neg"],
)
def test_binary_auroc_matches_jax(shape, num_tasks, p):
    rng = np.random.default_rng(len(shape) + shape[-1])
    s = (np.floor(rng.random(shape) * 512) / 512).astype(np.float32)
    y = (rng.random(shape) < p).astype(np.int32)
    _build.reset_counts()
    got = binary_auroc(torch.from_numpy(s), torch.from_numpy(y), num_tasks=num_tasks)
    route = "rank_sum_counts" if p < 0.01 or p > 0.99 else "auc_from_sorted"
    assert dict(_build.PLAIN_CALLS) == {route: 1}
    _close(got, jax_binary_auroc(jnp.asarray(s), jnp.asarray(y), num_tasks=num_tasks))


def test_binary_auroc_fused_matches_jax():
    rng = np.random.default_rng(4)
    s = rng.random(400).astype(np.float32)
    y = (rng.random(400) < 0.5).astype(np.int32)
    got = binary_auroc(s, y, use_fused=True)
    _close(got, jax_binary_auroc(jnp.asarray(s), jnp.asarray(y), use_fused=True))


@pytest.mark.parametrize("average", ["macro", None])
@pytest.mark.parametrize(
    "n,c,levels,route",
    [(300, 5, 20, "auc_from_sorted"), (2**15, 200, None, "rank_sum_counts")],
    ids=["sort", "rank-sum"],
)
def test_multiclass_auroc_matches_jax(n, c, levels, route, average):
    s, y = _multiclass_data(n + c, n, c, levels)
    _build.reset_counts()
    got = multiclass_auroc(torch.from_numpy(s), torch.from_numpy(y), num_classes=c, average=average)
    assert dict(_build.PLAIN_CALLS) == {route: 1}
    want = jax_multiclass_auroc(jnp.asarray(s), jnp.asarray(y), num_classes=c, average=average)
    _close(got, want)


def test_pinned_cap_matches_the_decided_route(monkeypatch):
    s, y = _multiclass_data(1, 2**15, 200)
    st, yt = torch.from_numpy(s), torch.from_numpy(y)
    decided = multiclass_auroc(st, yt, num_classes=200, average=None)
    pinned = multiclass_auroc(st, yt, num_classes=200, average=None, ustat_cap=256)
    assert torch.equal(decided, pinned)
    _close(pinned, jax_multiclass_auroc(jnp.asarray(s), jnp.asarray(y), num_classes=200, average=None))
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_DISABLE_USTAT", "1")
    _build.reset_counts()
    off = multiclass_auroc(st, yt, num_classes=200, average=None, ustat_cap=256)
    assert dict(_build.PLAIN_CALLS) == {"auc_from_sorted": 1}
    _close(off, decided)


@pytest.mark.parametrize(
    "cap,match",
    [(24, "multiple of 16"), (2**15, "exact-int32"), (32, "one class has")],
)
def test_pinned_cap_checks(cap, match):
    s, y = _multiclass_data(2, 2**14, 200)
    with pytest.raises(ValueError, match=match):
        multiclass_auroc(s, y, num_classes=200, ustat_cap=cap)


def test_pinned_cap_checks_scores_and_targets():
    s, y = _multiclass_data(3, 1024, 8)
    bad = s.copy()
    bad[0, 0] = np.inf
    with pytest.raises(ValueError, match="3e38"):
        multiclass_auroc(bad, y, num_classes=8, ustat_cap=512)
    y_bad = y.copy()
    y_bad[0] = 8
    with pytest.raises(ValueError, match=r"\[0, 8\)"):
        multiclass_auroc(s, y_bad, num_classes=8, ustat_cap=512)
    with skip_value_checks():  # the caller's contract: no read back
        multiclass_auroc(s, y, num_classes=8, ustat_cap=512)


def test_out_of_range_targets_take_the_sort_path_like_jax():
    s, y = _multiclass_data(5, 2**15, 200)
    y[:10] = 250
    _build.reset_counts()
    got = multiclass_auroc(s, y, num_classes=200, average=None)
    assert dict(_build.PLAIN_CALLS) == {"auc_from_sorted": 1}
    _close(got, jax_multiclass_auroc(jnp.asarray(s), jnp.asarray(y), num_classes=200, average=None))


def test_no_samples_is_half():
    assert float(binary_auroc(np.zeros(0, np.float32), np.zeros(0, np.int32))) == 0.5
    got = multiclass_auroc(np.zeros((0, 3), np.float32), np.zeros(0, np.int32), num_classes=3, average=None)
    assert got.tolist() == [0.5, 0.5, 0.5]


def _messages(fn_jax, fn_port, *args, **kwargs):
    with pytest.raises(ValueError) as want:
        fn_jax(*[jnp.asarray(a) for a in args], **kwargs)
    with pytest.raises(ValueError) as got:
        fn_port(*[torch.as_tensor(a) for a in args], **kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "s_shape,y_shape,kwargs",
    [
        ((4,), (5,), {}),
        ((2, 4), (2, 4), {}),
        ((4,), (4,), {"num_tasks": 2}),
        ((3, 4), (3, 4), {"num_tasks": 2}),
    ],
)
def test_binary_errors_match_jax(s_shape, y_shape, kwargs):
    _messages(jax_binary_auroc, binary_auroc, np.zeros(s_shape, np.float32), np.zeros(y_shape, np.int32), **kwargs)


@pytest.mark.parametrize(
    "s_shape,y_shape,kwargs",
    [
        ((4, 3), (5,), {"num_classes": 3}),
        ((4, 3), (4, 1), {"num_classes": 3}),
        ((4, 3), (4,), {"num_classes": 4}),
        ((4, 3), (4,), {"num_classes": 1}),
        ((4, 3), (4,), {"num_classes": 3, "average": "micro"}),
    ],
)
def test_multiclass_errors_match_jax(s_shape, y_shape, kwargs):
    _messages(
        jax_multiclass_auroc, multiclass_auroc,
        np.zeros(s_shape, np.float32), np.zeros(y_shape, np.int32), **kwargs,
    )
