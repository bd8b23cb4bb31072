"""Per-threshold prediction counts for the binned AUROC / AUPRC / PR-curve
family (the port of ``torcheval_tpu/ops/pallas_binned.py``, unweighted).

:func:`binned_counts` returns, for ``(R, N)`` score/hit rows and an
ascending threshold grid, the int32 ``(num_tp (R,T), num_fp (R,T),
num_pos (R,), num_total (R,))`` that every binned metric accumulates: a
per-slot (total, hit) histogram packed in one int64 a slot, slot
``k = #{j : t_j ≤ s}``, then one suffix sum (:func:`_counts_from_hist`).  For tensors on the GPU the histogram is
the CUDA kernel ``csrc/binned_count.cu``; for tensors on the CPU it is
:func:`_binned_counts_plain`.  Both count integers, so they agree bit for
bit with each other and with the JAX sort formulation
(``binned_auc._binned_counts_rows_sort``), NaN scores included: a NaN
counts at every threshold, where the sort orders it.

Dropped from the JAX module, because they exist only for the TPU's MXU
gather and its f32 accumulator: the finite pad sentinel and the score
clamp below it (``_SENTINEL``, ``_SENTINEL_BELOW``), the threshold table
(``_make_ttab``), the flattened row layout (``_flatten_rows``), the exact
bf16 split and its per-buffer memo (``_split_safe_thresholds``), and the
``N < 2^24`` / ``T ≤ 2^15`` bounds (the port counts in int32, and the
thresholds go to global memory past shared memory).

:func:`binned_weighted_counts` is the weighted entry (the port of
``pallas_binned_weighted_counts``): f32 sums of one per-sample weight
vector instead of counts, through ``csrc/binned_wcount.cu`` on the GPU and
:func:`_binned_weighted_counts_plain` on the CPU, with the same slot rule.
Dropped with the TPU kernel: the bf16 three-way weight split and its
``|w| >= 2^-100`` gate (``split_safe_weights``); any finite weight, of any
sign, is summed as it is.
"""

from __future__ import annotations

from typing import Tuple

import torch

from torcheval_tpu_torch.ops import _build

_MAX_N = 2**31  # int32 counts and sample indices

# The weighted kernel's launch plan (binned_wcount.cu): shared memory a
# block may use on the H100, warps a block at most, samples a range at
# least, the blocks a launch aims for, and the global path's scratch.
_MAX_SMEM = 232448
_MAX_WARPS = 8
_MIN_RANGE = 4096
_TARGET_BLOCKS = 1024
_SCRATCH_BYTES = 2**27
_MAX_GRID_Y = 65535

Counts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def binned_counts(
    scores: torch.Tensor, hits: torch.Tensor, thresholds: torch.Tensor
) -> Counts:
    """``(num_tp, num_fp, num_pos, num_total)`` as int32 for
    ``pred = score ≥ t`` over ``(R, N)`` rows: ``num_tp[r, j] = #{i :
    scores[r, i] ≥ t_j, hits[r, i]}``, ``num_fp`` the same over the misses,
    ``num_pos[r] = Σ_i hits[r, i]`` and ``num_total[r] = N``.  ``scores``
    and ``hits`` take any strides (the multiclass path passes the (N, C)
    buffer as a (C, N) view); ``thresholds`` is ``(T,)``, ascending,
    ``T ≥ 1``.  Requires ``N < 2^31``."""
    r, n, t = _check_binned_args(scores, hits, thresholds)
    if scores.device.type == "cpu":
        return _binned_counts_plain(scores, hits, thresholds)
    if scores.device.type != "cuda":
        raise ValueError(f"binned_counts runs on cuda or cpu, not {scores.device}.")
    if n == 0 or r == 0:
        return _empty_counts(r, t, scores.device)
    s = scores.to(torch.float32)
    h = hits.to(torch.bool)
    th = thresholds.to(torch.float32).contiguous()
    hist = torch.zeros((r, t + 1), dtype=torch.int64, device=scores.device)
    lib = _build.library()
    with torch.cuda.device(scores.device):
        err = lib.binned_count_launch(
            s.data_ptr(),
            s.stride(0),
            s.stride(1),
            h.data_ptr(),
            h.stride(0),
            h.stride(1),
            r,
            n,
            th.data_ptr(),
            t,
            hist.data_ptr(),
            _build.stream_handle(scores.device),
        )
    _build.check_launch("binned_count", err)
    _build.count_launch("binned_counts")
    return _counts_from_hist(hist, n)


def _check_binned_args(
    scores: torch.Tensor, hits: torch.Tensor, thresholds: torch.Tensor
) -> Tuple[int, int, int]:
    if scores.dim() != 2 or scores.shape != hits.shape:
        raise ValueError(
            "scores and hits must be (R, N) of one shape, got "
            f"{tuple(scores.shape)} and {tuple(hits.shape)}."
        )
    if thresholds.dim() != 1 or thresholds.shape[0] == 0:
        raise ValueError(
            f"thresholds must be a non-empty (T,) vector, got {tuple(thresholds.shape)}."
        )
    if not (scores.device == hits.device == thresholds.device):
        raise ValueError("scores, hits and thresholds must be on one device.")
    r, n = scores.shape
    if n >= _MAX_N:
        raise ValueError(f"binned_counts requires N < 2^31 (int32 counts), got {n}.")
    return r, n, thresholds.shape[0]


def _empty_counts(r: int, t: int, device: torch.device) -> Counts:
    zero_t = torch.zeros((r, t), dtype=torch.int32, device=device)
    zero_r = torch.zeros((r,), dtype=torch.int32, device=device)
    return zero_t, zero_t.clone(), zero_r, zero_r.clone()


def _counts_from_hist(hist: torch.Tensor, n: int) -> Counts:
    """The four count arrays from the ``(R, T + 1)`` packed slot
    histogram: each int64 slot holds ``(total << 32) | hits``.  Both
    halves stay below 2^31 through a row's sums, so ONE suffix sum carries
    them side by side without a carry between them.  Slot 0 holds the
    scores below every threshold, slot ``j + 1`` bin ``j``; the suffix sum
    at slot 0 is the row's hits."""
    cum = torch.cumsum(hist.flip(-1), dim=-1).flip(-1)
    num_ge = (cum[:, 1:] >> 32).to(torch.int32)
    hits = (cum & 0xFFFFFFFF).to(torch.int32)
    num_tp, num_pos = hits[:, 1:], hits[:, 0]
    return num_tp, num_ge - num_tp, num_pos, torch.full_like(num_pos, n)


def _binned_counts_plain(
    scores: torch.Tensor, hits: torch.Tensor, thresholds: torch.Tensor
) -> Counts:
    """The kernel's counts in plain PyTorch: ``bucketize(right=True)``
    gives each score's slot (NaN set to ``T`` explicitly, not left to the
    search), one ``index_add_`` of ``(1 << 32) | hit`` at ``row·(T+1) +
    slot`` gives the packed histogram, and the same suffix sum."""
    _build.count_plain("binned_counts")
    r, n = scores.shape
    t = thresholds.shape[0]
    if n == 0 or r == 0:
        return _empty_counts(r, t, scores.device)
    s = scores.to(torch.float32).contiguous()
    slot = torch.bucketize(s, thresholds.to(torch.float32).contiguous(), right=True)
    slot = torch.where(torch.isnan(s), t, slot)
    rows = torch.arange(r, device=s.device)[:, None]
    flat = (rows * (t + 1) + slot).reshape(-1)
    packed = ((hits != 0).to(torch.int64) | (1 << 32)).reshape(-1)
    hist = torch.zeros(r * (t + 1), dtype=torch.int64, device=s.device)
    hist.index_add_(0, flat, packed)
    return _counts_from_hist(hist.view(r, t + 1), n)


def binned_weighted_counts(
    scores: torch.Tensor,
    hits: torch.Tensor,
    weights: torch.Tensor,
    thresholds: torch.Tensor,
) -> Counts:
    """``(w_tp (R,T), w_fp (R,T), w_pos (R,), w_total (R,))`` as f32 for
    ``pred = score ≥ t`` over ``(R, N)`` rows and one ``(N,)`` weight
    vector shared by every row: ``w_tp[r, j] = Σ_i w_i·hits[r, i]·[scores[r,
    i] ≥ t_j]``, ``w_fp`` the same over the misses (summed directly, not
    as a difference), ``w_pos[r] = Σ_i w_i·hits[r, i]`` and ``w_total[r] =
    Σ_i w_i``.  Slots as :func:`binned_counts` (a NaN score counts at every
    threshold), so unit weights give its counts as f32, bit for bit, while
    every count is below 2^24.  Other weights agree with the plain version
    within ``1e-6·Σ|w|`` over the samples of each cell: both sum each slot
    in f64 and round it once to f32, so they differ only by the order of
    the f64 sums.  Two calls on one input give the same bits.  ``scores`` and
    ``hits`` take any strides; ``weights`` is ``(N,)``; ``thresholds`` is
    ``(T,)``, ascending, ``T ≥ 1``.  Requires ``N < 2^31``."""
    r, n, t = _check_binned_args(scores, hits, thresholds)
    if weights.dim() != 1 or weights.shape[0] != n:
        raise ValueError(
            f"weights must be (N,) = ({n},), got {tuple(weights.shape)}."
        )
    if weights.device != scores.device:
        raise ValueError("weights must be on the device of scores.")
    if scores.device.type == "cpu":
        return _binned_weighted_counts_plain(scores, hits, weights, thresholds)
    if scores.device.type != "cuda":
        raise ValueError(
            f"binned_weighted_counts runs on cuda or cpu, not {scores.device}."
        )
    w = weights.to(torch.float32).contiguous()
    if n == 0 or r == 0:
        return _empty_weighted(r, t, w)
    s = scores.to(torch.float32)
    h = hits.to(torch.bool)
    th = thresholds.to(torch.float32).contiguous()
    row_warps = s.stride(0) == 1 and r > 1
    warps, smem_hist, ranges, per_range, scratch_len = _wcount_plan(
        r, n, t, row_warps
    )
    # The global path's warps add into their scratch slices: zeroed first.
    alloc = torch.empty if smem_hist else torch.zeros
    scratch = alloc(scratch_len, dtype=torch.float64, device=s.device)
    w_tp = torch.empty((r, t), dtype=torch.float32, device=s.device)
    w_fp = torch.empty_like(w_tp)
    w_pos = torch.empty((r,), dtype=torch.float32, device=s.device)
    lib = _build.library()
    with torch.cuda.device(s.device):
        err = lib.binned_wcount_launch(
            s.data_ptr(),
            s.stride(0),
            s.stride(1),
            h.data_ptr(),
            h.stride(0),
            h.stride(1),
            w.data_ptr(),
            r,
            n,
            th.data_ptr(),
            t,
            warps,
            int(row_warps),
            smem_hist,
            ranges,
            per_range,
            scratch.data_ptr(),
            w_tp.data_ptr(),
            w_fp.data_ptr(),
            w_pos.data_ptr(),
            _build.stream_handle(s.device),
        )
    _build.check_launch("binned_wcount", err)
    _build.count_launch("binned_weighted_counts")
    return w_tp, w_fp, w_pos, w.sum().expand(r).clone()


def _wcount_plan(
    rows: int, n: int, t: int, row_warps: bool
) -> Tuple[int, int, int, int, int]:
    """``(warps, smem_hist, ranges, per_range, scratch_len)`` of a
    ``binned_wcount.cu`` launch (``scratch_len`` f64 elements).  A warp's
    private histogram is ``2 (T+1)`` f64 and its tag array ``T+1`` int32:
    as many warps as fit beside the thresholds in shared memory (at most
    8) with both (``smem_hist`` 2), else with the histograms only (1), else
    8 warps over a global scratch (0).  Sample ranges split each row so the launch has about
    ``_TARGET_BLOCKS`` blocks of at least ``_MIN_RANGE`` samples; the
    global path also keeps its scratch near ``_SCRATCH_BYTES``.  Depends
    on the shapes only, so one input is always summed in one order."""
    hist_bytes = 16 * (t + 1)
    smem_hist, warps = 0, _MAX_WARPS
    for mode, per_warp in ((2, hist_bytes + 4 * (t + 1)), (1, hist_bytes)):
        fit = min(_MAX_WARPS, (_MAX_SMEM - 4 * t) // per_warp)
        if fit >= 1:
            smem_hist, warps = mode, fit
            break
    row_blocks = -(-rows // warps) if row_warps else rows
    ranges = min(-(-n // _MIN_RANGE), -(-_TARGET_BLOCKS // row_blocks), _MAX_GRID_Y)
    # Partial histograms a (row, range): one, or a warp's each on the
    # global path of the one-row layout.
    per_part = 1 if (row_warps or smem_hist) else warps
    if not smem_hist:
        ranges = max(1, min(ranges, _SCRATCH_BYTES // (rows * per_part * hist_bytes)))
    per_range = -(-n // ranges)
    ranges = -(-n // per_range)
    return warps, smem_hist, ranges, per_range, rows * ranges * per_part * 2 * (t + 1)


def _empty_weighted(r: int, t: int, w: torch.Tensor) -> Counts:
    zero_t = torch.zeros((r, t), dtype=torch.float32, device=w.device)
    zero_r = torch.zeros((r,), dtype=torch.float32, device=w.device)
    return zero_t, zero_t.clone(), zero_r, w.sum().expand(r).clone()


def _binned_weighted_counts_plain(
    scores: torch.Tensor,
    hits: torch.Tensor,
    weights: torch.Tensor,
    thresholds: torch.Tensor,
) -> Counts:
    """The weighted kernel's sums in plain PyTorch: ``bucketize(right=True)``
    gives each score's slot (NaN set to ``T`` explicitly), one
    ``index_add_`` of ``w·hit`` and one of ``w·(1 − hit)`` at ``row·2(T+1)
    + slot`` (the fp half ``T + 1`` further on) give the per-slot sums, and
    the suffix sum runs from slot ``T`` down, as the kernel's.  The
    per-slot sums are taken in f64 and rounded once to f32, and the suffix
    sum in f64 over those, rounded once: an f32 ``index_add_`` adds a
    slot's samples one after another (in arrival order on the GPU), and an
    f32 suffix sum rounds once a slot, so over tens of thousands of samples
    in one slot, or thousands of slots, its own rounding would pass the
    kernel's tolerance and make it no reference.  A miss adds 0 to the tp half and a hit 0 to the fp half,
    whatever its weight (an infinite weight gives no ``inf·0``), as in the
    kernel."""
    _build.count_plain("binned_weighted_counts")
    r, n = scores.shape
    t = thresholds.shape[0]
    w = weights.to(torch.float32)
    if n == 0 or r == 0:
        return _empty_weighted(r, t, w)
    s = scores.to(torch.float32).contiguous()
    slot = torch.bucketize(s, thresholds.to(torch.float32).contiguous(), right=True)
    slot = torch.where(torch.isnan(s), t, slot)
    flat = (torch.arange(r, device=s.device)[:, None] * (2 * (t + 1)) + slot).reshape(-1)
    hit = (hits != 0).reshape(-1)
    ww = w.to(torch.float64).expand(r, n).reshape(-1)
    zero = torch.zeros((), dtype=torch.float64, device=s.device)
    hist = torch.zeros(r * 2 * (t + 1), dtype=torch.float64, device=s.device)
    hist.index_add_(0, flat, torch.where(hit, ww, zero))
    hist.index_add_(0, flat + (t + 1), torch.where(hit, zero, ww))
    hist = hist.to(torch.float32).to(torch.float64).view(r, 2, t + 1)
    cum = torch.cumsum(hist.flip(-1), dim=-1).flip(-1).to(torch.float32)
    return cum[:, 0, 1:], cum[:, 1, 1:], cum[:, 0, 0], w.sum().expand(r).clone()


__all__ = ("binned_counts", "binned_weighted_counts")
