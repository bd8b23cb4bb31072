"""Precision-recall curves — the port of
``torcheval_tpu/metrics/functional/classification/precision_recall_curve.py``
(parity with the reference ``torcheval/metrics/functional/classification/
precision_recall_curve.py``).

Ragged outputs: the device computes the fixed-shape sorted thresholds,
tie-group flags and cumulative TP/FP counts (``sorted_tie_cumsums``); the
ragged per-class curves are cut on the host, with ONE read back per
compute, and each curve is handed back on the input's device."""

from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.metrics.functional._host_checks import (
    place_inputs,
    to_host,
    x64_off,
)
from torcheval_tpu_torch.metrics.functional.classification._sort_scan import (
    class_hits,
    sorted_tie_cumsums,
)

Curve = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Curves = Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]


def binary_precision_recall_curve(input, target) -> Curve:
    """(precision, recall, thresholds) over ascending score thresholds
    (reference ``precision_recall_curve.py:18-90``)."""
    input, target = x64_off(*place_inputs(input, target))
    _binary_precision_recall_curve_update_input_check(input, target)
    return _binary_precision_recall_curve_compute(input, target)


def multiclass_precision_recall_curve(
    input,
    target,
    *,
    num_classes: Optional[int] = None,
) -> Curves:
    """Per-class PR curves; classes missing from target get recall 1.0
    (reference ``precision_recall_curve.py:93-203``)."""
    input, target = x64_off(*place_inputs(input, target))
    if num_classes is None and input.dim() == 2:
        num_classes = input.shape[1]
    _multiclass_precision_recall_curve_update_input_check(input, target, num_classes)
    return _multiclass_precision_recall_curve_compute(input, target, num_classes)


def _prc_device_kernel(
    input: torch.Tensor, target: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fixed-shape part: sort + tie flags + cumsums (binary, 1-D)."""
    threshold, is_last, num_tp, num_fp = sorted_tie_cumsums(
        input[None], (target == 1)[None]
    )
    return threshold[0], is_last[0], num_tp[0], num_fp[0]


def _binary_precision_recall_curve_compute(
    input: torch.Tensor, target: torch.Tensor
) -> Curve:
    return _compute_for_each_class(input, target, 1)


def _materialize_curve(
    tp: np.ndarray,
    fp: np.ndarray,
    thresholds_masked: np.ndarray,
    device: torch.device,
) -> Curve:
    """Shared host-side ragged materialization: flip to ascending
    thresholds, append the (1.0, 0.0) sentinel, NaN recall (no positives)
    → 1.0 (reference jit kernel ``precision_recall_curve.py:206-229``)."""
    with np.errstate(invalid="ignore", divide="ignore"):
        precision = (tp / (tp + fp))[::-1]
        total = tp[-1] if tp.size else 0
        recall = (tp / total)[::-1] if tp.size else tp.astype(np.float64)
    precision = np.concatenate([precision, np.ones(1)])
    recall = np.concatenate([recall, np.zeros(1)])
    if recall.size and np.isnan(recall[0]):
        recall = np.nan_to_num(recall, nan=1.0)
    return (
        torch.from_numpy(precision.astype(np.float32)).to(device),
        torch.from_numpy(recall.astype(np.float32)).to(device),
        # A copy: a reversed view keeps its negative stride, which
        # torch.from_numpy refuses (np.ascontiguousarray keeps a one-element one).
        torch.from_numpy(thresholds_masked[::-1].copy()).to(device),
    )


def _empty_curve(device: torch.device) -> Curve:
    """Zero-sample curve: just the (1.0, 0.0) sentinel point, no thresholds."""
    empty = np.zeros(0, dtype=np.int64)
    return _materialize_curve(empty, empty, np.zeros(0, dtype=np.float32), device)


def _compute_for_each_class(
    input: torch.Tensor, target: torch.Tensor, pos_label: int
) -> Curve:
    if input.shape[-1] == 0:
        return _empty_curve(input.device)
    threshold, is_last, num_tp, num_fp = to_host(
        *_prc_device_kernel(input, (target == pos_label).to(torch.int32)),
        site="precision_recall_curve",
    )
    return _materialize_curve(
        num_tp[is_last], num_fp[is_last], threshold[is_last], input.device
    )


def _prc_multiclass_device_kernel(input: torch.Tensor, target: torch.Tensor):
    """Fixed-shape part, over classes: (C, N) sorts + cumsums."""
    return sorted_tie_cumsums(input.T, class_hits(target, input.shape[1]))


def _multiclass_precision_recall_curve_compute(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int],
) -> Curves:
    if num_classes is None:
        num_classes = input.shape[1]
    return _materialize_row_curves(
        _prc_multiclass_device_kernel, input, target, num_classes
    )


def _materialize_row_curves(
    device_kernel: Callable,
    input: torch.Tensor,
    target: torch.Tensor,
    num_rows: int,
) -> Curves:
    """Shared ragged materialization for per-row (class/label) curve
    families: run the fixed-shape device kernel once, read it back once,
    then cut each row's tie groups on the host."""
    if input.shape[0] == 0:
        curves = [_empty_curve(input.device) for _ in range(num_rows)]
        return tuple(list(xs) for xs in zip(*curves))
    thresholds, is_last, num_tp, num_fp = to_host(
        *device_kernel(input, target), site="precision_recall_curve"
    )
    precisions, recalls, thresh_list = [], [], []
    for c in range(num_rows):
        mask = is_last[c]
        p, r, t = _materialize_curve(
            num_tp[c][mask], num_fp[c][mask], thresholds[c][mask], input.device
        )
        precisions.append(p)
        recalls.append(r)
        thresh_list.append(t)
    return precisions, recalls, thresh_list


def multilabel_precision_recall_curve(
    input,
    target,
    *,
    num_labels: Optional[int] = None,
) -> Curves:
    """Per-label PR curves over a ``(n_samples, num_labels)`` 0/1 target
    matrix: each label column is an independent binary curve, through the
    same ``(R, N)`` sort + tie scan as the multiclass form."""
    input, target = x64_off(*place_inputs(input, target))
    if num_labels is None and input.dim() == 2:
        num_labels = input.shape[1]
    _multilabel_precision_recall_curve_update_input_check(input, target, num_labels)
    return _multilabel_precision_recall_curve_compute(input, target, num_labels)


def _prc_multilabel_device_kernel(input: torch.Tensor, target: torch.Tensor):
    """Fixed-shape part, over labels: (L, N) sorts + cumsums."""
    return sorted_tie_cumsums(input.T, (target == 1).T)


def _multilabel_precision_recall_curve_compute(
    input: torch.Tensor,
    target: torch.Tensor,
    num_labels: Optional[int],
) -> Curves:
    if num_labels is None:
        num_labels = input.shape[1]
    return _materialize_row_curves(
        _prc_multilabel_device_kernel, input, target, num_labels
    )


def _binary_precision_recall_curve_update_input_check(
    input: torch.Tensor, target: torch.Tensor
) -> None:
    if input.dim() != 1:
        raise ValueError(
            f"input should be a one-dimensional tensor, got shape {tuple(input.shape)}."
        )
    if target.dim() != 1:
        raise ValueError(
            f"target should be a one-dimensional tensor, got shape {tuple(target.shape)}."
        )
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same shape, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )


def _multiclass_precision_recall_curve_update_input_check(
    input: torch.Tensor, target: torch.Tensor, num_classes: Optional[int]
) -> None:
    if input.shape[0] != target.shape[0]:
        raise ValueError(
            "The `input` and `target` should have the same first dimension, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if target.dim() != 1:
        raise ValueError(
            f"target should be a one-dimensional tensor, got shape {tuple(target.shape)}."
        )
    if not (input.dim() == 2 and (num_classes is None or input.shape[1] == num_classes)):
        raise ValueError(
            "input should have shape of (num_sample, num_classes), "
            f"got {tuple(input.shape)} and num_classes={num_classes}."
        )


def _multilabel_precision_recall_curve_update_input_check(
    input: torch.Tensor, target: torch.Tensor, num_labels: Optional[int]
) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "Expected both input.shape and target.shape to have the same shape"
            f" but got {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if not (input.dim() == 2 and (num_labels is None or input.shape[1] == num_labels)):
        raise ValueError(
            "input should have shape of (num_sample, num_labels), "
            f"got {tuple(input.shape)} and num_labels={num_labels}."
        )
