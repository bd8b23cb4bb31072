"""Exact AUC scan over sorted scores (the port of
``torcheval_tpu/ops/pallas_auc.py``).

:func:`auc_from_sorted` launches the CUDA kernel ``csrc/auc_scan.cu`` for
tensors on the GPU and runs :func:`_auc_from_sorted_plain`, the same
arithmetic in plain PyTorch, for tensors on the CPU.  The group sum is an
exact int64 in both, so the two agree bit for bit.

Math (per row, scores sorted DESCENDING, ties adjacent), as in the JAX
kernel::

    area = P·N_neg − ½ · Σ_groups P_g · (end_fp_g + prevend_fp_g)
    AUC  = area / (P·N_neg)            (0.5 when P·N_neg == 0)

The kernel splits each row into chunks (:func:`auc_plan`): a block
reduces one chunk to an exact integer summary, and the chunks of a row
combine in order, so one long row spreads over every SM.  Any split gives
the same integers (``csrc/auc_scan.cu``'s ``combine``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from torcheval_tpu_torch.ops import _build
from torcheval_tpu_torch.telemetry import events as _telemetry

_ONE_BYTE = (torch.bool, torch.uint8, torch.int8)

# csrc/auc_scan.cu: 8 warps a block, a warp's step 32 lanes x 16 elements.
_WARPS = 8
_SPAN = 32 * 16
_CHUNK_UNIT = _WARPS * _SPAN
_SUM_BYTES = 32  # one chunk's summary (struct Sum)
# Blocks the plan aims at: about 4 resident on each SM, 4 waves of them.
_BLOCKS_PER_SM = 4
_WAVES = 4


class AucPlan(NamedTuple):
    """One call of ``auc_scan.cu``, as :func:`auc_plan` decides it."""

    chunk: int  # positions of a row a block reduces (a multiple of 4096)
    chunks: int  # chunks a row
    rows: int
    vec: bool  # 16-byte loads: both arrays 16-byte aligned
    reach: int  # positions of a row the chunks cover: n, plus 15 for a shift

    @property
    def blocks(self) -> int:
        return self.rows * self.chunks

    @property
    def combine(self) -> bool:
        """A second launch combines each row's chunks (else each block
        finishes its row)."""
        return self.chunks > 1

    def describe(self) -> str:
        return (
            f"{self.chunks} chunks of {self.chunk} a row, {self.blocks} blocks, "
            f"{self.chunk // _WARPS // _SPAN} spans of {_SPAN} a warp, "
            + ("16-byte loads" if self.vec else "4- and 1-byte loads")
            + (", a combine launch of one block a row" if self.combine else ", no combine launch")
        )


@functools.lru_cache(maxsize=256)
def _auc_plan(rows: int, n: int, vec: bool, sms: int) -> AucPlan:
    """Chunks of whole warp spans: about ``sms x _BLOCKS_PER_SM x _WAVES``
    blocks over all rows where the rows hold that much work, then spread
    evenly over each row; never fewer than one span a warp."""
    reach = n + (15 if vec and n % 16 else 0)
    spans = -(-reach // _SPAN)
    target_warps = sms * _BLOCKS_PER_SM * _WAVES * _WARPS
    per_warp = max(1, min(-(-spans // _WARPS), rows * spans // target_warps))
    chunks = -(-spans // (_WARPS * per_warp))
    per_warp = -(-spans // (_WARPS * chunks))
    return AucPlan(_WARPS * per_warp * _SPAN, chunks, rows, vec, reach)


def auc_plan(thresholds: torch.Tensor, hits: torch.Tensor, sms: int = _build.H100_SMS) -> AucPlan:
    """The launch plan of :func:`auc_from_sorted` on these ``(R, N)``
    contiguous operands."""
    rows, n = thresholds.shape
    vec = thresholds.data_ptr() % 16 == 0 and hits.data_ptr() % 16 == 0
    return _auc_plan(rows, n, vec, sms)


def auc_from_sorted(thresholds: torch.Tensor, hits: torch.Tensor) -> torch.Tensor:
    """Exact per-row AUC from ``(R, N)`` descending-sorted f32 scores and
    0/1 hits (bool, uint8 or int8).  Returns ``(R,)`` f32.  Counts are
    int32, so rows hold fewer than 2^31 samples."""
    if thresholds.dim() != 2 or thresholds.shape != hits.shape:
        raise ValueError(
            "thresholds and hits must be (R, N) of one shape, got "
            f"{tuple(thresholds.shape)} and {tuple(hits.shape)}."
        )
    if thresholds.dtype != torch.float32 or hits.dtype not in _ONE_BYTE:
        raise TypeError(
            "auc_from_sorted takes float32 thresholds and bool/uint8/int8 "
            f"hits, got {thresholds.dtype} and {hits.dtype}."
        )
    if thresholds.device != hits.device:
        raise ValueError("thresholds and hits must be on one device.")
    rows, n = thresholds.shape
    if n >= 2**31:
        raise ValueError(f"rows hold {n} samples; the int32 counts need N < 2^31.")
    if thresholds.device.type == "cpu":
        return _auc_from_sorted_plain(thresholds, hits)
    if thresholds.device.type != "cuda":
        raise ValueError(f"auc_from_sorted runs on cuda or cpu, not {thresholds.device}.")
    thresholds = thresholds.contiguous()
    hits = hits.contiguous()
    out = torch.empty(rows, dtype=torch.float32, device=thresholds.device)
    if rows == 0:
        return out
    if n == 0:
        return out.fill_(0.5)
    plan = auc_plan(thresholds, hits, _build.sm_count(thresholds.device.index))
    scratch = (
        torch.empty(plan.blocks * _SUM_BYTES // 8, dtype=torch.int64, device=thresholds.device)
        if plan.combine
        else None
    )
    lib = _build.library()
    with torch.cuda.device(thresholds.device):
        err = lib.auc_scan_launch(
            thresholds.data_ptr(),
            hits.data_ptr(),
            rows,
            n,
            plan.chunk,
            plan.chunks,
            int(plan.vec),
            None if scratch is None else scratch.data_ptr(),
            out.data_ptr(),
            _build.stream_handle(thresholds.device),
        )
    _build.check_launch("auc_scan", err)
    _build.count_launch("auc_from_sorted")
    return out


def _auc_from_sorted_plain(thresholds: torch.Tensor, hits: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in plain PyTorch (int64 exact group sum)."""
    _build.count_plain("auc_from_sorted")
    h = (hits != 0).to(torch.int64)
    cum_tp = torch.cumsum(h, dim=1)
    cum_fp = torch.cumsum(1 - h, dim=1)
    tp_m1 = cum_tp - h  # exclusive counts: a group's end values sit at the
    fp_m1 = cum_fp - (1 - h)  # first element of the next group
    flag = torch.zeros_like(h, dtype=torch.bool)
    flag[:, 1:] = thresholds[:, 1:] != thresholds[:, :-1]
    # Counts at the nearest boundary to the left (cumulative counts only
    # grow, so a running max finds it), shifted to exclude the element.
    b_tp = torch.cummax(torch.where(flag, tp_m1, 0), dim=1).values
    b_fp = torch.cummax(torch.where(flag, fp_m1, 0), dim=1).values
    prev_tp = torch.nn.functional.pad(b_tp[:, :-1], (1, 0))
    prev_fp = torch.nn.functional.pad(b_fp[:, :-1], (1, 0))
    acc = torch.where(flag, (tp_m1 - prev_tp) * (fp_m1 + prev_fp), 0).sum(dim=1)
    tot_tp, tot_fp = cum_tp[:, -1], cum_fp[:, -1]
    acc = acc + (tot_tp - b_tp[:, -1]) * (tot_fp + b_fp[:, -1])
    factor = tot_tp.to(torch.float32) * tot_fp.to(torch.float32)
    area = factor - 0.5 * acc.to(torch.float32)
    return torch.where(factor == 0, 0.5, area / factor)


def binary_auroc_sorted_path(scores: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Exact binary AUROC via a stable sort plus :func:`auc_from_sorted`
    (the counterpart of ``pallas_binary_auroc``).  Takes ``(N,)`` or
    multi-task ``(R, N)``; a target counts as a hit when it is nonzero
    after truncation to int8, as in the JAX sort payload."""
    from torcheval_tpu_torch.metrics.functional.classification._sort_scan import (
        sort_desc,
    )

    squeeze = scores.dim() == 1
    if squeeze:
        scores, targets = scores[None], targets[None]
    if scores.shape[-1] == 0:
        auc = torch.full(scores.shape[:-1], 0.5, device=scores.device)
    else:
        scores, targets = scores.to(torch.float32), targets.to(torch.int8)
        if _telemetry.ANNOTATE:
            with _telemetry.span("compute.sort"):
                thresholds, hits = sort_desc(scores, targets)
            with _telemetry.span("compute.kernel.auc_scan"):
                auc = auc_from_sorted(thresholds, hits)
        else:
            auc = auc_from_sorted(*sort_desc(scores, targets))
    return auc[0] if squeeze else auc
