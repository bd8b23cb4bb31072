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
thresholds go to global memory past shared memory).  The weighted entry
(``pallas_binned_weighted_counts``) comes with the distributed slice.
"""

from __future__ import annotations

from typing import Tuple

import torch

from torcheval_tpu_torch.ops import _build

_MAX_N = 2**31  # int32 counts and sample indices

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
    _build.LAUNCHES["binned_counts"] += 1
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
    _build.PLAIN_CALLS["binned_counts"] += 1
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


__all__ = ("binned_counts",)
