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


# ---------------------------------------------------------------------------
# The fixed-point route of csrc/binned_wcount.cu: its quantum and range
# check, its launch plan, and a numpy model of its sums.


@pytest.mark.parametrize(
    "wmax,wmin,n,exponent",
    [(1.5, 0.5, 2**17, -44), (1.0, 1.0, 2**17, -44), (0.999, 0.5, 2**17, -45),
     (1.0, 1.0, 1, -61), (1.0, 1.0, 2**31 - 1, -30), (2.0**-30, 2.0**-40, 1000, -81),
     (1.5, 2.0**-23, 100_003, -44), (1.5, 2.0**-23 * (1 - 2.0**-20), 100_003, None),
     (1.5, 0.0 + 2.0**-30, 2**17, None), (0.0, float("inf"), 10, 0),
     (float("inf"), 1.0, 10, None), (float("nan"), 1.0, 10, None), (3.0e38, 1.0e33, 2**20, 86),
     (3.0e38, 1.0e30, 2**20, None)],
)
def test_fixed_point_exponent(wmax, wmin, n, exponent):
    got = port_binned._fixed_point_exponent(wmax, wmin, n)
    assert got == exponent
    if got is not None and wmax > 0:
        q = 2.0**got
        # No row's cell passes 2^62 quanta; q within a factor 4 of the least.
        assert n * wmax <= 2.0**62 * q < 4 * n * wmax
        assert wmin >= 2.0**21 * q


def test_weight_range_reads_max_and_smallest_nonzero():
    w = torch.tensor([0.0, -3.0, 0.25, 0.0, 1.0])
    assert port_binned._weight_range(w) == (3.0, 0.25)
    assert port_binned._weight_range(torch.zeros(4)) == (0.0, float("inf"))
    wmax, _ = port_binned._weight_range(torch.tensor([1.0, float("nan")]))
    assert wmax != wmax


@pytest.mark.parametrize(
    "rows,n,t,window,smem_thr,ranges",
    [(1000, 2**17, 2048, 2049, True, 1), (1000, 2**15, 2048, 2049, True, 1),
     (1, 2**20, 16384, 8193, True, 66), (2, 100_003, 60_000, 12_001, False, 14),
     (2, 100_003, 10_000, 10_001, True, 25), (37, 12_295, 200, 201, True, 4),
     (1, 5, 1, 2, True, 1), (1, 2**26, 2048, 2049, True, 132),
     (1, 2**31 - 1, 2048, 2049, True, 132)],
)
def test_fixed_point_launch_plan_fits_the_card(rows, n, t, window, smem_thr, ranges):
    got = port_binned._wcount_fixed_plan(rows, n, t)
    assert (got[0], got[1], got[3]) == (window, ranges, smem_thr)
    per_range = got[2]
    assert ranges * per_range >= n and (ranges - 1) * per_range < n and ranges <= 65535
    splits = -(-(t + 1) // window)
    assert splits * window >= t + 1 and splits <= 65535
    assert 16 * window + (4 * t if smem_thr else 0) <= port_binned._MAX_SMEM
    if ranges > 1:  # about a block an SM, of about _MIN_RANGE samples or more
        assert ranges <= -(-n // port_binned._MIN_RANGE)
        assert rows * splits * (ranges - 1) < port_binned._FIXED_TARGET_BLOCKS


def test_weight_range_words_decode():
    # The range kernel's words: the bits of max |w|, and 0x7f800000 less
    # the bits of the smallest finite nonzero |w| (0: none).
    assert port_binned._decode_weight_range([0x3FC00000, 0x7F800000 - 0x3F000000]) == (1.5, 0.5)
    assert port_binned._decode_weight_range([0, 0]) == (0.0, float("inf"))
    wmax, wmin = port_binned._decode_weight_range([-0x00400000, 0x7F800000 - 0x3F800000])
    assert wmax != wmax and wmin == 1.0  # 0xffc00000 read as int32: a NaN's bits
    assert port_binned._decode_weight_range([0x7F800000, 0x7F800000 - 1]) == (float("inf"), 2.0**-149)


def _fixed_point_model(s, h, w, th):
    """The fixed-point route's sums in numpy: each weight rounded to an
    integer count of quanta (half to even, as __double2ll_rn), exact
    integer slot sums, each slot times q rounded once to f32, then the f64
    suffix sums rounded once."""
    r, n = s.shape
    t = th.shape[0]
    e = port_binned._fixed_point_exponent(
        float(np.abs(w).max()), float(np.abs(w[w != 0]).min()) if (w != 0).any() else np.inf, n)
    assert e is not None
    wq = np.rint(w.astype(np.float64) * 2.0**-e).astype(np.int64)
    slot = np.searchsorted(th, s, side="right")
    slot[np.isnan(s)] = t
    hist = np.zeros((r, 2, t + 1), dtype=object)  # Python ints: exact
    for row in range(r):
        for half, sel in ((0, h[row]), (1, ~h[row])):
            sums = np.zeros(t + 1, dtype=object)
            np.add.at(sums, slot[row][sel], wq[sel].astype(object))
            hist[row, half] = sums
    per_slot = (hist.astype(np.float64) * 2.0**e).astype(np.float32).astype(np.float64)
    cum = np.cumsum(per_slot[..., ::-1], axis=-1)[..., ::-1].astype(np.float32)
    return [cum[:, 0, 1:], cum[:, 1, 1:], cum[:, 0, 0]]


@pytest.mark.parametrize("edge", ["low", "high", "mixed-sign", "unit"])
def test_fixed_point_model_within_tolerance_of_the_plain_version(edge):
    # n = 3000: q = 2^(1 + 12 - 62) = 2^-49 for max|w| in [1, 2), so the
    # range reaches down to min|w| = 2^21 q = 2^-28.
    rng = np.random.default_rng({"low": 1, "high": 2, "mixed-sign": 3, "unit": 4}[edge])
    n, t = 3000, 64
    s = rng.random((2, n)).astype(np.float32)
    h = rng.random((2, n)) > 0.4
    w = (rng.random(n) + 0.5).astype(np.float32)
    if edge == "low":
        # Tiny weights with bits far below q, alone in the top slot.
        w[:40] = (2.0**-28 * (1 + rng.random(40) * 0.999)).astype(np.float32)
        w[40] = 1.5
        s[:, :40] = 1.0
    elif edge == "high":
        w[:] = np.float32(1.9999999)
    elif edge == "mixed-sign":
        w = ((w - 1.0) * 3.0).astype(np.float32)
        w[::5] = 0.0
    else:
        w[:] = 1.0
    th = _grid(t)
    assert port_binned._fixed_point_exponent(
        float(np.abs(w).max()), float(np.abs(w[w != 0]).min()), n) is not None
    got = _fixed_point_model(s, h, w, th)
    want = _port(s, h, w, th)
    scale = _port(s, h, np.abs(w), th)
    for g, x, a, name in zip(got, want, scale, _NAMES):
        np.testing.assert_array_less(np.abs(g.astype(np.float64) - x.numpy()),
                                     1e-6 * a.numpy() + 1e-30, err_msg=name)
    if edge == "unit":  # integer weights convert exactly: the counts, bit for bit
        counts = binned_counts(torch.from_numpy(s), torch.from_numpy(h), torch.from_numpy(th))
        for g, c in zip(got, counts):
            np.testing.assert_array_equal(g, c.numpy().astype(np.float32))
