"""``ops/auc.py`` (the exact AUC scan) against the JAX Pallas kernel run in
interpret mode with a small tile, so several tiles carry state.

The port sums the tie-group products exactly in int64; the JAX kernel sums
them in Kahan-compensated f32.  They agree bit for bit while the partial
sums stay below 2^24 (P·N_neg < 2^24) and within 1e-6 beyond.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.ops.pallas_auc import (
    auc_from_sorted as jax_auc_from_sorted,
    pallas_binary_auroc,
)
from torcheval_tpu_torch.ops import _build
from torcheval_tpu_torch.ops.auc import (
    auc_from_sorted,
    binary_auroc_sorted_path,
)


def _sorted_rows(seed, rows, n, levels, p_hit=0.3):
    rng = np.random.default_rng(seed)
    s = (rng.integers(0, levels, (rows, n)) / levels).astype(np.float32)
    h = rng.random((rows, n)) < p_hit
    order = np.argsort(-s, axis=1, kind="stable")
    return np.take_along_axis(s, order, 1), np.take_along_axis(h, order, 1)


def _jax(t, h, tile=128):
    return np.asarray(
        jax_auc_from_sorted(
            jnp.asarray(t), jnp.asarray(h.astype(np.float32)), interpret=True, tile=tile
        )
    )


def test_bitwise_with_ties_and_degenerate_rows():
    t, h = _sorted_rows(0, 7, 700, 16)
    h[1] = False  # no positives
    h[2] = True  # no negatives
    t[3] = 0.5  # one tie group
    t[4, :350], t[4, 350:] = 0.75, 0.25  # two groups across tiles
    got = auc_from_sorted(torch.from_numpy(t), torch.from_numpy(h)).numpy()
    want = _jax(t, h)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got[1] == got[2] == got[3] == 0.5


def test_large_pair_counts_within_1e6():
    # P·N_neg ≈ 2.5e7 > 2^24: the JAX f32 partial sums round.
    t, h = _sorted_rows(1, 2, 10_000, 4096, p_hit=0.5)
    got = auc_from_sorted(torch.from_numpy(t), torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, _jax(t, h, tile=1024), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(500,), (3, 400)])
def test_binary_sorted_path_matches_pallas_binary_auroc(shape):
    rng = np.random.default_rng(2)
    s = (rng.integers(0, 50, shape) / 50).astype(np.float32)
    y = (rng.random(shape) < 0.4).astype(np.int32)
    want = np.asarray(pallas_binary_auroc(jnp.asarray(s), jnp.asarray(y), interpret=True))
    got = binary_auroc_sorted_path(torch.from_numpy(s), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_cpu_tensors_take_the_plain_version():
    t, h = _sorted_rows(3, 2, 64, 8)
    _build.reset_counts()
    auc_from_sorted(torch.from_numpy(t), torch.from_numpy(h))
    assert _build.PLAIN_CALLS["auc_from_sorted"] == 1
    assert _build.LAUNCHES["auc_from_sorted"] == 0


@pytest.mark.parametrize(
    "t,h,err",
    [
        (torch.zeros(2, 3), torch.zeros(2, 4, dtype=torch.bool), ValueError),
        (torch.zeros(2, 3, dtype=torch.float64), torch.zeros(2, 3, dtype=torch.bool), TypeError),
        (torch.zeros(2, 3), torch.zeros(2, 3, dtype=torch.int32), TypeError),
        (torch.zeros(3), torch.zeros(3, dtype=torch.bool), ValueError),
        (torch.zeros(2, 3, device="meta"), torch.zeros(2, 3, dtype=torch.bool, device="meta"), ValueError),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(t, h, err):
    with pytest.raises(err):
        auc_from_sorted(t, h)
