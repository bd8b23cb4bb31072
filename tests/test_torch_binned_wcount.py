"""``ops/binned.py::binned_weighted_counts`` (the weighted binned sums under
the sharded histograms) against the JAX package's weighted Pallas kernel
run in interpret mode, on the same numpy-seeded inputs.

Tolerances: within 1e-6 of the sum of |w| over the samples that reach each
cell (the summation-order contract of ``pallas_binned.py:245-251``); under
unit weights bit for bit equal to the port's and the JAX kernel's integer
counts.  A NaN score is the one kept divergence: the port counts it at
every threshold (its unweighted kernel's rule, the JAX sort route's
order), the JAX TPU kernel at none."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.ops.pallas_binned import (
    _pallas_binned_weighted_counts_jit,
    pallas_binned_counts,
)
from torcheval_tpu_torch.ops import _build
from torcheval_tpu_torch.ops import binned as port_binned
from torcheval_tpu_torch.ops.binned import binned_counts, binned_weighted_counts

_NAMES = ("w_tp", "w_fp", "w_pos", "w_total")


def _grid(t_count):
    return np.array(jnp.linspace(0, 1.0, t_count)) if t_count > 1 else np.array([0.5], np.float32)


def _inputs(seed, r, n, t_count, weights="positive"):
    rng = np.random.default_rng(seed)
    s = rng.random((r, n)).astype(np.float32)
    h = rng.random((r, n)) > 0.4
    w = (rng.random(n) + 0.5).astype(np.float32)
    if weights == "mixed":
        w = ((w - 1.0) * 3.0).astype(np.float32)
        w[::5] = 0.0
    return s, h, w, _grid(t_count)


def _port(s, h, w, th):
    return binned_weighted_counts(
        torch.from_numpy(s), torch.from_numpy(h), torch.from_numpy(w), torch.from_numpy(th)
    )


def _jax(s, h, w, th):
    out = _pallas_binned_weighted_counts_jit(
        jnp.asarray(s), jnp.asarray(h), jnp.asarray(w), jnp.asarray(th),
        interpret=True, split3=True,
    )
    return [np.asarray(x) for x in out]


def _assert_within(got, want, scale, msg=""):
    for g, x, a, name in zip(got, want, scale, _NAMES):
        g = g.numpy()
        assert g.dtype == np.float32 and g.shape == x.shape, f"{msg} {name}"
        np.testing.assert_array_less(np.abs(g.astype(np.float64) - x), 1e-6 * a + 1e-30,
                                     err_msg=f"{msg} {name}")


@pytest.mark.parametrize(
    "r,n,t_count,weights",
    [(1, 5000, 200, "positive"), (3, 2048, 100, "positive"), (2, 777, 300, "mixed"),
     (16, 555, 33, "positive"), (1, 4096, 1, "positive"), (4, 3000, 128, "mixed")],
)
def test_within_tolerance_of_the_jax_kernel(r, n, t_count, weights):
    s, h, w, th = _inputs(r * n + t_count, r, n, t_count, weights)
    _build.reset_counts()
    got = _port(s, h, w, th)
    assert _build.PLAIN_CALLS["binned_weighted_counts"] == 1 and not _build.LAUNCHES
    scale = [x.numpy() for x in _port(s, h, np.abs(w), th)]
    _assert_within(got, _jax(s, h, w, th), scale, f"{(r, n, t_count, weights)}")


@pytest.mark.parametrize("r,n,t_count", [(1, 5000, 200), (5, 1234, 64), (2, 4096, 1)])
def test_unit_weights_bitwise_equal_the_counts(r, n, t_count):
    s, h, _, th = _inputs(7 + n, r, n, t_count)
    ones = np.ones(n, np.float32)
    got = _port(s, h, ones, th)
    port = binned_counts(torch.from_numpy(s), torch.from_numpy(h), torch.from_numpy(th))
    jax_counts = pallas_binned_counts(jnp.asarray(s), jnp.asarray(h), jnp.asarray(th),
                                      interpret=True)
    jax_weighted = _jax(s, h, ones, th)
    for g, c, jc, jw in zip(got, port, jax_counts, jax_weighted):
        assert torch.equal(g, c.to(torch.float32))
        np.testing.assert_array_equal(g.numpy(), np.asarray(jc).astype(np.float32))
        np.testing.assert_array_equal(g.numpy(), jw)


def test_strided_class_view_equals_the_contiguous_rows():
    rng = np.random.default_rng(3)
    buf = rng.random((2000, 37)).astype(np.float32)  # the (N, C) score buffer
    y = rng.integers(0, 37, 2000)
    hits = y[None, :] == np.arange(37)[:, None]
    w = (rng.random(2000) + 0.5).astype(np.float32)
    th = _grid(50)
    view = torch.from_numpy(buf).T
    assert view.stride() == (1, 37)
    got = binned_weighted_counts(view, torch.from_numpy(hits), torch.from_numpy(w),
                                 torch.from_numpy(th))
    want = _port(np.ascontiguousarray(buf.T), hits, w, th)
    for g, x in zip(got, want):
        assert torch.equal(g, x)
    scale = [x.numpy() for x in _port(np.ascontiguousarray(buf.T), hits, np.abs(w), th)]
    _assert_within(got, _jax(np.ascontiguousarray(buf.T), hits, w, th), scale)


def test_empty_input_and_zero_weights():
    th = _grid(20)
    got = _port(np.zeros((3, 0), np.float32), np.zeros((3, 0), bool), np.zeros(0, np.float32), th)
    for g, x in zip(got, _jax(np.zeros((3, 0), np.float32), np.zeros((3, 0), bool),
                              np.zeros(0, np.float32), th)):
        np.testing.assert_array_equal(g.numpy(), x)
    assert got[0].shape == (3, 20) and got[3].shape == (3,)
    s, h, _, th = _inputs(11, 2, 900, 40)
    zeros = np.zeros(900, np.float32)
    for g in _port(s, h, zeros, th):
        assert not g.numpy().any()


def test_nan_scores_count_at_every_threshold_the_kept_divergence():
    # The port's slot rule is its unweighted kernel's (NaN -> slot T, as the
    # JAX sort route orders it); the JAX TPU kernel counts a NaN nowhere.
    # So the two differ by exactly the NaN samples' weights at every
    # threshold, and agree everywhere else.
    s, h, w, th = _inputs(5, 1, 1000, 64)
    nan_at = np.array([3, 17, 500, 999])
    s[0, nan_at] = np.nan
    got = [x.numpy().astype(np.float64) for x in _port(s, h, w, th)]
    want = _jax(s, h, w, th)
    extra_tp = float(np.sum(w[nan_at] * h[0, nan_at]))
    extra_fp = float(np.sum(w[nan_at] * ~h[0, nan_at]))
    np.testing.assert_allclose(got[0] - want[0], extra_tp, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[1] - want[1], extra_fp, rtol=0, atol=1e-3)
    # The unweighted port counts the same samples at every threshold.
    counts = binned_counts(torch.from_numpy(s), torch.from_numpy(h), torch.from_numpy(th))
    ones = _port(s, h, np.ones_like(w), th)
    assert torch.equal(ones[0], counts[0].to(torch.float32))


def test_argument_checks():
    s = torch.rand(2, 10)
    h = torch.rand(2, 10) > 0.5
    th = torch.linspace(0, 1, 5)
    with pytest.raises(ValueError, match="weights must be"):
        binned_weighted_counts(s, h, torch.ones(9), th)
    with pytest.raises(ValueError, match="one shape"):
        binned_weighted_counts(s, h[:, :5], torch.ones(10), th)


@pytest.mark.parametrize(
    "rows,n,t,row_warps,smem",
    [(1000, 2**17, 2048, False, 2), (1000, 2**15, 2048, True, 2),
     (2, 100_003, 5000, False, 2), (2, 100_003, 10_000, False, 1), (1, 2**20, 16384, False, 0),
     (2, 100_003, 60_000, False, 0), (37, 12_295, 60_000, True, 0), (1, 5, 1, False, 2),
     (1, 2**31 - 1, 2048, False, 2)],
)
def test_launch_plan_fits_the_card(rows, n, t, row_warps, smem):
    warps, smem_hist, ranges, per_range, scratch = port_binned._wcount_plan(rows, n, t, row_warps)
    assert smem_hist == smem and 1 <= warps <= 8
    assert ranges * per_range >= n and (ranges - 1) * per_range < n and ranges <= 65535
    if smem_hist:  # the warps' f64 histograms (and tags) and the thresholds in one block
        per_warp = 16 * (t + 1) + (4 * (t + 1) if smem_hist == 2 else 0)
        assert warps * per_warp + 4 * t <= port_binned._MAX_SMEM
        assert scratch == rows * ranges * 2 * (t + 1)
    else:
        per_part = 1 if row_warps else warps
        assert scratch == rows * ranges * per_part * 2 * (t + 1)
        assert ranges == 1 or scratch * 8 <= port_binned._SCRATCH_BYTES
