"""Binned AUROC / AUPRC — the port of
``torcheval_tpu/metrics/functional/classification/binned_auc.py``.

Fixed-threshold areas under the ROC and PR curves.  Per-threshold TP/FP
counts are the sufficient statistics (fixed-shape, mergeable by
addition), so the unbounded sample buffers of the exact AUROC/AUPRC
metrics are traded for an O(T) state.

The update stage :func:`_binned_counts_rows` has two formulations with
bit-identical int32 counts (:func:`_select_binned_route`):

* ``"kernel"``: :func:`torcheval_tpu_torch.ops.binned.binned_counts`, a
  per-bin histogram and suffix sums (the CUDA kernel
  ``ops/csrc/binned_count.cu`` on the GPU, its plain version on the CPU),
  for every row shorter than 2^31 samples;
* ``"sort"``: one stable row sort and ``searchsorted``
  (:func:`_binned_counts_rows_sort`), beyond the kernel's bound.

Dropped from the JAX module: the ``"broadcast"`` route and its
``_BROADCAST_MAX_WORK`` cut (a TPU timing), the backend gate and the
Pallas switch.  The JAX kernel's ``N < 2^24`` (its f32 per-bin sums) and
``T ≤ 2^15`` (its VMEM one-hot tiles) do not bind the port: it counts in
int32, and the thresholds move from shared to global memory past 227 KB.

A NaN score counts at every threshold, as the JAX sort route orders it.
"""

from typing import List, Optional, Tuple, Union

import torch

from torcheval_tpu_torch.metrics.functional._host_checks import place_inputs
from torcheval_tpu_torch.metrics.functional.classification._sort_scan import class_hits
from torcheval_tpu_torch.metrics.functional.classification.auroc import (
    _binary_auroc_update_input_check,
    _multiclass_auroc_update_input_check,
)
from torcheval_tpu_torch.metrics.functional.classification.binned_precision_recall_curve import (
    _binned_precision_recall_curve_param_check,
    _create_threshold_tensor,
    _multiclass_binned_compute_kernel,
)
from torcheval_tpu_torch.metrics.functional.classification.precision import (
    _check_index_range,
)
from torcheval_tpu_torch.metrics.functional.classification.precision_recall_curve import (
    _multilabel_precision_recall_curve_update_input_check,
)
from torcheval_tpu_torch.ops.binned import _MAX_N, binned_counts

Threshold = Union[int, List[float], torch.Tensor]
Counts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def binary_binned_auroc(
    input,
    target,
    *,
    num_tasks: int = 1,
    threshold: Threshold = 200,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(auroc, thresholds) at fixed thresholds; multi-task via a
    ``(num_tasks, n)`` leading dim.  Degenerate rows (no positives or no
    negatives) yield 0.5, matching the exact ``binary_auroc``."""
    input, target = place_inputs(input, target)
    threshold = _create_threshold_tensor(threshold, input.device)
    _binned_precision_recall_curve_param_check(threshold)
    _binary_auroc_update_input_check(input, target, num_tasks)
    squeeze = input.dim() == 1
    if squeeze:
        input, target = input[None], target[None]
    auroc = _binned_auroc_from_counts(*_binned_counts_rows(input, target == 1, threshold))
    return (auroc[0] if squeeze else auroc), threshold


def multiclass_binned_auroc(
    input,
    target,
    *,
    num_classes: int,
    average: Optional[str] = "macro",
    threshold: Threshold = 200,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-vs-rest binned AUROC with macro/None averaging."""
    _binned_auc_average_param_check(num_classes, average, "num_classes")
    input, target = place_inputs(input, target)
    threshold = _create_threshold_tensor(threshold, input.device)
    _binned_precision_recall_curve_param_check(threshold)
    _multiclass_binned_auc_validate(input, target, num_classes)
    auroc = _binned_auroc_from_counts(
        *_multiclass_binned_counts_kernel(input, target, threshold, num_classes)
    )
    return (auroc.mean() if average == "macro" else auroc), threshold


def binary_binned_auprc(
    input,
    target,
    *,
    num_tasks: int = 1,
    threshold: Threshold = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(average precision, thresholds) at fixed thresholds; multi-task via
    a ``(num_tasks, n)`` leading dim.  Rows with no positives yield 0,
    matching the exact ``binary_auprc``."""
    input, target = place_inputs(input, target)
    threshold = _create_threshold_tensor(threshold, input.device)
    _binned_precision_recall_curve_param_check(threshold)
    _binary_auroc_update_input_check(input, target, num_tasks)
    squeeze = input.dim() == 1
    if squeeze:
        input, target = input[None], target[None]
    auprc = _binned_auprc_from_counts(*_binned_counts_rows(input, target == 1, threshold))
    return (auprc[0] if squeeze else auprc), threshold


def multiclass_binned_auprc(
    input,
    target,
    *,
    num_classes: int,
    average: Optional[str] = "macro",
    threshold: Threshold = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-vs-rest binned average precision with macro/None averaging."""
    _binned_auc_average_param_check(num_classes, average, "num_classes")
    input, target = place_inputs(input, target)
    threshold = _create_threshold_tensor(threshold, input.device)
    _binned_precision_recall_curve_param_check(threshold)
    _multiclass_binned_auc_validate(input, target, num_classes)
    auprc = _binned_auprc_from_counts(
        *_multiclass_binned_counts_kernel(input, target, threshold, num_classes)
    )
    return (auprc.mean() if average == "macro" else auprc), threshold


def multilabel_binned_auprc(
    input,
    target,
    *,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
    threshold: Threshold = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-label binned average precision over a ``(n, num_labels)`` 0/1
    target matrix with macro/None averaging."""
    _binned_auc_average_param_check(num_labels, average, "num_labels")
    input, target = place_inputs(input, target)
    threshold = _create_threshold_tensor(threshold, input.device)
    _binned_precision_recall_curve_param_check(threshold)
    _multilabel_precision_recall_curve_update_input_check(input, target, num_labels)
    auprc = _binned_auprc_from_counts(
        *_multilabel_binned_counts_kernel(input, target, threshold)
    )
    return (auprc.mean() if average == "macro" else auprc), threshold


def multilabel_binned_precision_recall_curve(
    input,
    target,
    *,
    num_labels: Optional[int] = None,
    threshold: Threshold = 100,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
    """Per-label binned PR curves over a ``(n, num_labels)`` 0/1 target
    matrix (per-label precision/recall vectors with the (1.0, 0.0)
    sentinel point, plus the shared thresholds)."""
    input, target = place_inputs(input, target)
    threshold = _create_threshold_tensor(threshold, input.device)
    _binned_precision_recall_curve_param_check(threshold)
    _multilabel_precision_recall_curve_update_input_check(input, target, num_labels)
    tp, fp, pos, _ = _multilabel_binned_counts_kernel(input, target, threshold)
    return _binned_curves_from_counts(tp, fp, pos, threshold)


def _binned_curves_from_counts(
    tp: torch.Tensor, fp: torch.Tensor, pos: torch.Tensor, threshold: torch.Tensor
) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
    """Row-count layout (R, T) → the reference's (T, R) binned-curve
    compute, with its sentinel/NaN semantics."""
    fn = pos[:, None] - tp
    precision, recall = _multiclass_binned_compute_kernel(tp.T, fp.T, fn.T)
    return list(precision.T), list(recall.T), threshold


def _multiclass_binned_auc_validate(
    input: torch.Tensor, target: torch.Tensor, num_classes: int
) -> None:
    """Shape check + out-of-range-target raise shared by the functional
    and class paths: ``class_hits`` would otherwise count an out-of-range
    target as a negative of every class."""
    _multiclass_auroc_update_input_check(input, target, num_classes)
    _check_index_range(target, num_classes, "target")


def _select_binned_route(num_samples: int) -> str:
    """The binned-counts formulation for rows of ``num_samples``:
    ``"kernel"`` (:func:`binned_counts`) below 2^31 samples, the kernel's
    int32 bound, else ``"sort"``.  Any number of thresholds and rows takes
    the kernel (thresholds in shared memory, or global memory past it).
    Shapes only: the route never reads the data and never depends on the
    device."""
    return "kernel" if num_samples < _MAX_N else "sort"


def _binned_counts_rows(
    scores: torch.Tensor,
    hits: torch.Tensor,
    thresholds: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Counts:
    """Per-threshold prediction counts for ``pred = score >= t`` over
    ``(R, N)`` score/hit rows, by the formulation
    :func:`_select_binned_route` picks.

    ``mask`` (shape ``(N,)``) excludes padded samples exactly: their
    scores become ``-inf``, which falls in no bin of either formulation,
    their hits are zeroed out of ``num_tp`` / ``num_pos``, and
    ``num_total`` becomes ``mask.sum()``.  A mask keeps the kernel (the
    JAX package moved masked updates to the sort route only because its
    TPU kernel pads with a finite sentinel)."""
    if mask is not None:
        valid = mask.to(torch.bool)
        scores = torch.where(valid[None, :], scores, float("-inf"))
        hits = torch.logical_and(hits, valid[None, :])
    if _select_binned_route(scores.shape[-1]) == "kernel":
        out = binned_counts(scores, hits, thresholds)
    else:
        out = _binned_counts_rows_sort(scores, hits, thresholds)
    if mask is None:
        return out
    num_tp, num_fp, num_pos, num_total = out
    num_total = torch.zeros_like(num_total) + valid.sum(dtype=torch.int32)
    return num_tp, num_fp, num_pos, num_total


def _binned_counts_rows_sort(
    scores: torch.Tensor, hits: torch.Tensor, thresholds: torch.Tensor
) -> Counts:
    """Sort-formulation binned counts: one stable row sort co-sorts the
    hits with the scores (NaN last), an inclusive cumsum gives the hits
    below any point, and ``searchsorted`` reads each threshold's boundary
    off the sorted row: ``num_tp(t) = total_hits − hits_below(t)``.
    Returns ``(num_tp (R,T), num_fp (R,T), num_pos (R,), num_total
    (R,))``, all int32."""
    num_rows, n = scores.shape
    num_t = thresholds.shape[0]
    device = scores.device
    if n == 0:
        zero_t = torch.zeros((num_rows, num_t), dtype=torch.int32, device=device)
        zero_r = torch.zeros((num_rows,), dtype=torch.int32, device=device)
        return zero_t, zero_t.clone(), zero_r, zero_r.clone()
    # NaN orders last, above every threshold (torch.searchsorted would
    # take a NaN for smaller than the value it seeks): +inf in its place.
    s = scores.to(torch.float32)
    s = torch.where(torch.isnan(s), float("inf"), s).contiguous()
    s_sorted, order = torch.sort(s, dim=-1, stable=True)
    h_sorted = torch.gather(hits.to(torch.int8), -1, order)
    cum_hits = torch.cumsum(h_sorted, dim=-1, dtype=torch.int32)
    total_hits = cum_hits[:, -1:]
    th = thresholds.to(torch.float32).expand(num_rows, num_t).contiguous()
    idx = torch.searchsorted(s_sorted, th, side="left")
    hits_below = torch.gather(
        torch.cat([torch.zeros_like(total_hits), cum_hits], dim=-1), -1, idx
    )
    num_tp = total_hits - hits_below
    num_fp = (n - idx).to(torch.int32) - num_tp
    num_total = torch.full((num_rows,), n, dtype=torch.int32, device=device)
    return num_tp, num_fp, total_hits[:, 0], num_total


def _multiclass_binned_counts_kernel(
    input: torch.Tensor,
    target: torch.Tensor,
    threshold: torch.Tensor,
    num_classes: int,
    mask: Optional[torch.Tensor] = None,
) -> Counts:
    """One-vs-rest counts: the (N, C) scores are read as (C, N) in place
    beside the (C, N) class hits."""
    return _binned_counts_rows(input.T, class_hits(target, num_classes), threshold, mask=mask)


def _multilabel_binned_counts_kernel(
    input: torch.Tensor,
    target: torch.Tensor,
    threshold: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Counts:
    return _binned_counts_rows(input.T, (target == 1).T, threshold, mask=mask)


def _binned_auroc_from_counts(
    num_tp: torch.Tensor,
    num_fp: torch.Tensor,
    num_pos: torch.Tensor,
    num_total: torch.Tensor,
) -> torch.Tensor:
    """Trapezoidal area under the binned ROC polyline, in ``jnp.trapezoid``'s
    order.  Thresholds ascend, so (FPR, TPR) descends toward the appended
    (0, 0) anchor; with thresholds starting at 0 and scores in [0, 1] the
    first point is (1, 1).  Degenerate rows (one class present) → 0.5."""
    num_rows = num_tp.shape[0]
    pos = num_pos.to(torch.float32)
    neg = (num_total - num_pos).to(torch.float32)
    tpr = num_tp / torch.clamp(pos, min=1.0)[:, None]
    fpr = num_fp / torch.clamp(neg, min=1.0)[:, None]
    zero = torch.zeros((num_rows, 1), device=num_tp.device)
    tpr = torch.cat([tpr, zero], dim=-1).flip(-1)
    fpr = torch.cat([fpr, zero], dim=-1).flip(-1)
    auroc = 0.5 * (torch.diff(fpr, dim=-1) * (tpr[:, 1:] + tpr[:, :-1])).sum(-1)
    return torch.where((num_pos == 0) | (num_pos == num_total), 0.5, auroc)


def _binned_auprc_from_counts(
    num_tp: torch.Tensor,
    num_fp: torch.Tensor,
    num_pos: torch.Tensor,
    num_total: torch.Tensor,
) -> torch.Tensor:
    """Step-sum average precision over the binned PR points: with
    thresholds ascending (recall non-increasing),
    AP = Σ_t (R_t − R_{t+1}) · P_t with R fading to 0 past the last
    threshold, the pairing of sklearn's step rule.  Rows with no
    positives → 0 (matching the exact AUPRC)."""
    del num_total
    pos = torch.clamp(num_pos.to(torch.float32), min=1.0)[:, None]
    precision = torch.nan_to_num(num_tp / (num_tp + num_fp), nan=1.0)
    recall = num_tp / pos
    recall_next = torch.cat([recall[:, 1:], torch.zeros_like(recall[:, :1])], dim=-1)
    ap = ((recall - recall_next) * precision).sum(-1)
    return torch.where(num_pos == 0, 0.0, ap)


def _binned_auc_average_param_check(
    num_rows: Optional[int], average: Optional[str], name: str
) -> None:
    average_options = ("macro", "none", None)
    if average not in average_options:
        raise ValueError(
            f"`average` was not in the allowed value of {average_options}, "
            f"got {average}."
        )
    if num_rows is not None and num_rows < 2:
        raise ValueError(f"`{name}` has to be at least 2.")
