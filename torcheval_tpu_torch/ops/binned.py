"""Per-threshold prediction counts for the binned AUROC / AUPRC / PR-curve
family (the port of ``torcheval_tpu/ops/pallas_binned.py``, unweighted).

:func:`binned_counts` returns, for ``(R, N)`` score/hit rows and an
ascending threshold grid, the int32 ``(num_tp (R,T), num_fp (R,T),
num_pos (R,), num_total (R,))`` that every binned metric accumulates: a
per-slot (total, hit) histogram packed in one int64 a slot, slot
``k = #{j : t_j ≤ s}``, then one suffix sum.  For tensors on the GPU both
are kernels of ``csrc/binned_count.cu`` (launch plan:
:func:`binned_count_plan`); for tensors on the CPU they are
:func:`_binned_counts_plain` and :func:`_counts_from_hist`.  Both count
integers, so they agree bit for bit with each other and with the JAX sort
formulation (``binned_auc._binned_counts_rows_sort``), NaN scores
included: a NaN counts at every threshold, where the sort orders it.

Dropped from the JAX module, because they exist only for the TPU's MXU
gather and its f32 accumulator: the finite pad sentinel and the score
clamp below it (``_SENTINEL``, ``_SENTINEL_BELOW``), the threshold table
(``_make_ttab``), the flattened row layout (``_flatten_rows``), the exact
bf16 split and its per-buffer memo (``_split_safe_thresholds``), and the
``N < 2^24`` / ``T ≤ 2^15`` bounds (the port counts in int32, and the
thresholds go to global memory past shared memory).

:func:`binned_weighted_counts` is the weighted entry (the port of
``pallas_binned_weighted_counts``): f32 sums of one per-sample weight
vector instead of counts, through ``csrc/binned_wcount.cu`` on the GPU (an
int64 fixed-point route for weights of a bounded range, an f64 route for
the rest) and :func:`_binned_weighted_counts_plain` on the CPU, with the
same slot rule.
Dropped with the TPU kernel: the bf16 three-way weight split and its
``|w| >= 2^-100`` gate (``split_safe_weights``); any finite weight, of any
sign, is summed as it is.
"""

from __future__ import annotations

import functools
import math
import struct
from typing import NamedTuple, Optional, Tuple

import torch

from torcheval_tpu_torch.ops import _build

_MAX_N = 2**31  # int32 counts and sample indices

# The count kernel's launch plans (binned_count.cu): warps a block, samples
# a lane, blocks an SM at most on the L2 route (two blocks of 512 threads
# at 64 registers, every form but G = 32 with the thresholds in L1/L2,
# fill an SM's 65 536; more blocks wait for a second wave and stage the
# thresholds again: 2 an SM measured 1-2 % faster than 1 and 3-4 % faster
# than 4 at the G = 32 layout and the north-star rank block, PERF.md);
# the private route's cells of slots, and its most tiles a warp (a
# block's 16 warps then count below 2^16 samples).
_COUNT_WARPS = 16
_COUNT_PER_LANE = 8
_COUNT_BLOCKS_PER_SM = 2
_CELL = 64
_PRIVATE_TILES_PER_WARP = 15

# The weighted kernel's launch plans (binned_wcount.cu): shared memory a
# block may use on the H100, warps a block at most (f64 route), samples a
# range at least, the blocks a launch aims for, and the f64 route's global
# scratch.
_MAX_SMEM = 232448
_MAX_WARPS = 8
_MIN_RANGE = 4096
_TARGET_BLOCKS = 1024
_SCRATCH_BYTES = 2**27
_MAX_GRID_Y = 65535
# The fixed-point route aims at a block an SM: each block zeroes, fills and
# flushes a whole histogram window, so more blocks than the card holds at
# once only add that cost (measured on the H100, PERF.md).
_FIXED_TARGET_BLOCKS = 132

# The fixed-point route: cells of a row stay within 2^_CELL_BITS quanta,
# and it is taken while the smallest nonzero |w| is at least
# 2^_RANGE_BITS quanta (a sample's rounding at most 2^-22 |w|).
_CELL_BITS = 62
_RANGE_BITS = 21

Counts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class CountPlan(NamedTuple):
    """One call of ``binned_count.cu``, as :func:`binned_count_plan`
    decides it."""

    group_rows: int  # 32: a warp's lanes are 32 adjacent rows; 1: samples of one row
    vec: bool  # G = 1: 16-byte score and 4-byte hit loads; G = 32: 8-byte hit loads
    smem: bool  # the thresholds staged in shared memory (else read through L1/L2)
    private: bool  # one row: a private histogram a block, its copies summed after
    tiles: int  # warp tiles: 256 samples of a row, or 32 rows x 8 samples
    blocks: int  # blocks of _COUNT_WARPS warps, grid-stride over the tiles

    def describe(self) -> str:
        layout = (
            "G = 32 (lanes are rows), "
            + ("8-byte hit loads" if self.vec else "1-byte hit loads")
            if self.group_rows == 32
            else "G = 1 (lanes are samples), "
            + ("16-byte score / 4-byte hit loads" if self.vec else "scalar loads at any strides")
        )
        route = (
            "a private histogram a block, copies summed a cell of 64 slots a block"
            if self.private
            else "atomics into one histogram in L2"
        )
        return (
            f"{layout}, thresholds in {'shared memory' if self.smem else 'L1/L2'}, {route}, "
            f"{self.tiles} warp tiles, {self.blocks} blocks of {_COUNT_WARPS} warps"
        )


def binned_count_plan(
    scores: torch.Tensor, hits: torch.Tensor, t: int, sms: int = _build.H100_SMS
) -> CountPlan:
    """The launch plan of :func:`binned_counts` on these ``(R, N)`` f32
    scores and one-byte hits over ``t`` thresholds."""
    r, n = scores.shape
    s_row, s_col = scores.stride()
    h_row, h_col = hits.stride()
    group_rows = 32 if s_row == 1 and r > 1 else 1
    if group_rows == 1:
        vec = (
            s_col == 1
            and h_col == 1
            and scores.data_ptr() % 16 == 0
            and hits.data_ptr() % 4 == 0
            and (r == 1 or (s_row % 4 == 0 and h_row % 4 == 0))
        )
    else:
        vec = h_col == 1 and hits.data_ptr() % 8 == 0 and h_row % 8 == 0
    return _count_plan(r, n, t, group_rows, vec, sms)


def _private_smem(t: int) -> int:
    """Shared memory of the private route's block (``binned_count.cu``'s
    ``private_smem``): the slots, the thresholds, the cells' sums."""
    t1 = t + 1
    return -(-4 * t1 // 16) * 16 + 4 * -(-t // 4) * 4 + 4 * -(-t1 // _CELL)


@functools.lru_cache(maxsize=256)
def _count_plan(r: int, n: int, t: int, group_rows: int, vec: bool, sms: int) -> CountPlan:
    """Warp tiles of :data:`_COUNT_PER_LANE` samples a lane.  One row whose
    slots and thresholds fit in a block's shared memory takes the private
    route, a block an SM at most, while no warp counts more than
    :data:`_PRIVATE_TILES_PER_WARP` tiles (L2 atomics into one small
    histogram were the slower route at the binned lifecycle's update,
    measured on the H100, PERF.md).  Else atomics into one histogram: the
    thresholds in shared memory where they fit (faster than reading them
    through L1/L2), about one tile a warp, at most
    :data:`_COUNT_BLOCKS_PER_SM` blocks an SM (one where two tables pass
    shared memory)."""
    if group_rows == 1:
        tiles = r * -(-n // (32 * _COUNT_PER_LANE))
    else:
        tiles = -(-r // 32) * -(-n // _COUNT_PER_LANE)
    if r == 1 and group_rows == 1 and _private_smem(t) <= _MAX_SMEM:
        blocks = max(1, min(-(-tiles // _COUNT_WARPS), sms))
        if -(-tiles // (blocks * _COUNT_WARPS)) <= _PRIVATE_TILES_PER_WARP:
            return CountPlan(group_rows, vec, True, True, tiles, blocks)
    table = 4 * t
    smem = table <= _MAX_SMEM
    per_sm = min(_COUNT_BLOCKS_PER_SM, _MAX_SMEM // table) if smem else _COUNT_BLOCKS_PER_SM
    blocks = max(1, min(-(-tiles // _COUNT_WARPS), sms * per_sm))
    return CountPlan(group_rows, vec, smem, False, tiles, blocks)


def binned_counts(
    scores: torch.Tensor, hits: torch.Tensor, thresholds: torch.Tensor
) -> Counts:
    """``(num_tp, num_fp, num_pos, num_total)`` as int32 for
    ``pred = score ≥ t`` over ``(R, N)`` rows: ``num_tp[r, j] = #{i :
    scores[r, i] ≥ t_j, hits[r, i]}``, ``num_fp`` the same over the misses,
    ``num_pos[r] = Σ_i hits[r, i]`` and ``num_total[r] = N``.  ``scores``
    and ``hits`` take any strides (the multiclass path passes the (N, C)
    buffer as a (C, N) view); ``thresholds`` is ``(T,)``, ascending,
    ``T ≥ 1``.  Requires ``N < 2^31``.  On the GPU a call is one C entry
    of ``binned_count.cu`` and two kernels, the count, then the suffix sum
    that writes the four arrays (one row: a private histogram a block, then
    the copies' sum; else a zero fill of one packed histogram with
    ``cudaMemsetAsync`` first); ``LAUNCHES["binned_counts"]`` counts one a
    call."""
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
    plan = binned_count_plan(s, h, t, _build.sm_count(s.device.index))
    return _launch_binned_count(s, h, th, plan)


def _launch_binned_count(
    s: torch.Tensor, h: torch.Tensor, th: torch.Tensor, plan: CountPlan
) -> Counts:
    """Launch ``binned_count.cu`` on checked CUDA operands (f32 scores,
    bool hits, contiguous f32 thresholds, ``N ≥ 1``) as ``plan`` says."""
    r, n = s.shape
    t = th.shape[0]
    if plan.private:  # the blocks' copies, then the cells' sums, all written whole
        cells = -(-(t + 1) // _CELL)
        scratch = torch.empty(plan.blocks * (t + 1 + cells), dtype=torch.int32, device=s.device)
        cell_sums = scratch[plan.blocks * (t + 1) :].data_ptr()
    else:  # one packed int64 histogram, zeroed by the C entry
        scratch = torch.empty((r, t + 1), dtype=torch.int64, device=s.device)
        cell_sums = None
    out = torch.empty(2 * r * t + 2 * r, dtype=torch.int32, device=s.device)
    num_tp, num_fp = out[: r * t].view(r, t), out[r * t : 2 * r * t].view(r, t)
    num_pos, num_total = out[2 * r * t : 2 * r * t + r], out[2 * r * t + r :]
    lib = _build.library()
    with torch.cuda.device(s.device):
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
            plan.group_rows,
            int(plan.vec),
            int(plan.smem),
            int(plan.private),
            plan.blocks,
            scratch.data_ptr(),
            cell_sums,
            num_tp.data_ptr(),
            num_fp.data_ptr(),
            num_pos.data_ptr(),
            num_total.data_ptr(),
            _build.stream_handle(s.device),
        )
    _build.check_launch("binned_count", err)
    _build.count_launch("binned_counts")
    return num_tp, num_fp, num_pos, num_total


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
    within ``1e-6·Σ|w|`` over the samples of each cell.  Two calls on one
    input give the same bits.  On the GPU one of two routes of
    ``csrc/binned_wcount.cu`` runs, each counted under its own name:
    weights within the range of :func:`_fixed_point_exponent` are summed
    as int64 multiples of a power-of-two quantum
    (``LAUNCHES["binned_weighted_counts"]``), any others in f64
    (``LAUNCHES["binned_weighted_counts_f64"]``); the choice reads the
    weights' range back to the host once.  ``scores`` and
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
    w_tp = torch.empty((r, t), dtype=torch.float32, device=s.device)
    w_fp = torch.empty_like(w_tp)
    w_pos = torch.empty((r,), dtype=torch.float32, device=s.device)
    # Made before the range is read back, so that after it only the launch
    # keeps the card waiting (the f64 route drops it).
    hist = torch.zeros((r, 2 * (t + 1)), dtype=torch.int64, device=s.device)
    exponent = _fixed_point_exponent(*_weight_range(w), n)
    lib = _build.library()
    with torch.cuda.device(s.device):
        stream = _build.stream_handle(s.device)
        if exponent is not None:
            window, ranges, per_range, smem_thr = _wcount_fixed_plan(r, n, t)
            err = lib.binned_wcount_fixed_launch(
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
                math.ldexp(1.0, -exponent),
                math.ldexp(1.0, exponent),
                window,
                ranges,
                per_range,
                int(smem_thr),
                hist.data_ptr(),
                w_tp.data_ptr(),
                w_fp.data_ptr(),
                w_pos.data_ptr(),
                stream,
            )
            _build.check_launch("binned_wcount_fixed", err)
            _build.count_launch("binned_weighted_counts")
            return w_tp, w_fp, w_pos, w.sum().expand(r).clone()
        del hist
        rows_adjacent = s.stride(0) == 1 and r > 1
        warps, smem_hist, ranges, per_range, scratch_len = _wcount_plan(
            r, n, t, rows_adjacent
        )
        # The global path's warps add into their scratch slices: zeroed first.
        alloc = torch.empty if smem_hist else torch.zeros
        scratch = alloc(scratch_len, dtype=torch.float64, device=s.device)
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
            int(rows_adjacent),
            smem_hist,
            ranges,
            per_range,
            scratch.data_ptr(),
            w_tp.data_ptr(),
            w_fp.data_ptr(),
            w_pos.data_ptr(),
            stream,
        )
    _build.check_launch("binned_wcount", err)
    _build.count_launch("binned_weighted_counts_f64")
    return w_tp, w_fp, w_pos, w.sum().expand(r).clone()


def _weight_range(w: torch.Tensor) -> Tuple[float, float]:
    """``(max |w|, smallest finite nonzero |w|)`` of a non-empty f32 weight
    vector (``inf`` for the second when there is none; NaN or ``inf`` for
    the first when a weight is not finite).  On the GPU one pass of
    ``binned_wcount.cu``'s range kernel, read back once; on the CPU
    :func:`_weight_range_plain`."""
    if w.device.type == "cpu":
        return _weight_range_plain(w)
    bits = torch.empty(2, dtype=torch.int32, device=w.device)
    with torch.cuda.device(w.device):
        err = _build.library().binned_wcount_range_launch(
            w.data_ptr(), w.shape[0], bits.data_ptr(), _build.stream_handle(w.device)
        )
    _build.check_launch("binned_wcount_range", err)
    return _decode_weight_range(bits.tolist())


def _decode_weight_range(bits) -> Tuple[float, float]:
    """``(max |w|, smallest finite nonzero |w|)`` from the range kernel's
    words: the bits of the largest |w|, and 0x7f800000 less the bits of
    the smallest finite nonzero one (0: none)."""
    hi, lo = (b & 0xFFFFFFFF for b in bits)
    wmax = struct.unpack("<f", struct.pack("<I", hi))[0]
    wmin = math.inf if lo == 0 else struct.unpack("<f", struct.pack("<I", 0x7F800000 - lo))[0]
    return wmax, wmin


def _weight_range_plain(w: torch.Tensor) -> Tuple[float, float]:
    """:func:`_weight_range` in plain torch ops."""
    a = w.to(torch.float32).abs()
    finite_nonzero = (a > 0) & (a < math.inf)
    wmin = torch.where(finite_nonzero, a, torch.full_like(a, math.inf))
    wmax, wmin = torch.stack([a.max(), wmin.min()]).tolist()  # max propagates NaN
    return wmax, wmin


def _fixed_point_exponent(wmax: float, wmin: float, n: int) -> Optional[int]:
    """The exponent ``e`` of the fixed-point quantum ``q = 2^e`` for
    weights of largest magnitude ``wmax`` and smallest nonzero ``wmin``
    over rows of ``n`` samples, or None when they take the f64 route.
    ``q = 2^(k + b - 62)`` for ``wmax < 2^k`` and ``n ≤ 2^b``, so ``n·wmax <
    2^62·q``: no cell of a row can pass 2^62 quanta, nor a partial sum of
    them 2^63, in any order.  The route
    needs ``wmin ≥ 2^21·q``, so a sample's rounding ``q/2`` is at most
    ``2^-22·|w|``.  Non-finite weights take the f64 route; all-zero weights
    the fixed point (q = 1, every sum 0)."""
    if not math.isfinite(wmax):
        return None
    if wmax == 0.0:
        return 0
    # wmax < 2^k and n <= 2^bits, so n·wmax < 2^(k + bits).
    k = math.frexp(wmax)[1]
    bits = (n - 1).bit_length()
    exponent = k + bits - _CELL_BITS
    if wmin < math.ldexp(1.0, exponent + _RANGE_BITS):
        return None
    return exponent


def _wcount_fixed_plan(rows: int, n: int, t: int) -> Tuple[int, int, int, bool]:
    """``(window, ranges, per_range, smem_thr)`` of a fixed-point launch
    (``binned_wcount_fixed_launch``), a row a block: a ``window`` of slots
    a block (``T + 1``, or fewer where one row's ``2 (T + 1)`` int64 pass
    shared memory, as at T = 16 384), the thresholds staged in shared
    memory where they fit beside it, and sample ranges so the launch has
    about :data:`_FIXED_TARGET_BLOCKS` blocks of at least
    :data:`_MIN_RANGE` samples.  Depends on the shapes only."""
    t1 = t + 1
    thr = 4 * t
    window = t1
    if 16 * window + thr > _MAX_SMEM:
        # As many slots as fit, beside the thresholds while they take at
        # most half the room; the windows split the slots evenly.
        room = _MAX_SMEM - (thr if thr <= _MAX_SMEM // 2 else 0)
        window = -(-t1 // -(-t1 // (room // 16)))
    smem_thr = 16 * window + thr <= _MAX_SMEM
    blocks = rows * -(-t1 // window)
    ranges = max(1, min(-(-n // _MIN_RANGE), -(-_FIXED_TARGET_BLOCKS // blocks), _MAX_GRID_Y))
    per_range = -(-n // ranges)
    ranges = -(-n // per_range)
    return window, ranges, per_range, smem_thr


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


__all__ = ("binned_count_plan", "binned_counts", "binned_weighted_counts")
