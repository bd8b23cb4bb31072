"""Binned precision-recall curves — the port of
``torcheval_tpu/metrics/functional/classification/binned_precision_recall_curve.py``
(parity with the reference ``torcheval/metrics/functional/classification/
binned_precision_recall_curve.py``).

Fixed thresholds make the sufficient statistics fixed-shape per-bin
TP/FP/FN counters, mergeable by addition.  Updates ride the shared
binned-counts core (``binned_auc._binned_counts_rows``: the CUDA kernel
``ops/csrc/binned_count.cu`` on the GPU, its plain version on the CPU).

The integer threshold grid is ``jnp.linspace(0, 1.0, T)`` bit for bit:
``f32(i) · (1 / f32(T − 1))`` and a last entry of exactly 1.0, as XLA
computes it
(:func:`_linspace_grid`).  ``torch.linspace`` and a correctly rounded
division both differ from it by one ulp on some entries, which moves
samples between bins.
"""

from functools import lru_cache
from typing import List, Optional, Tuple, Union

import torch

from torcheval_tpu_torch.metrics.functional._host_checks import place_inputs, to_host
from torcheval_tpu_torch.metrics.functional.classification.precision import (
    _check_index_range,
)

Threshold = Union[int, List[float], torch.Tensor]


def binary_binned_precision_recall_curve(
    input,
    target,
    *,
    threshold: Threshold = 100,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(precision, recall, thresholds) at fixed thresholds
    (reference ``binned_precision_recall_curve.py:17-110``)."""
    input, target = place_inputs(input, target)
    threshold = _create_threshold_tensor(threshold, input.device)
    _binned_precision_recall_curve_param_check(threshold)
    num_tp, num_fp, num_fn = _binary_binned_precision_recall_curve_update(
        input, target, threshold
    )
    return _binary_binned_precision_recall_curve_compute(
        num_tp, num_fp, num_fn, threshold
    )


def multiclass_binned_precision_recall_curve(
    input,
    target,
    num_classes: Optional[int] = None,
    threshold: Threshold = 100,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
    """Per-class binned PR curves over the shared binned-counts core
    (reference ``binned_precision_recall_curve.py:113-221``)."""
    input, target = place_inputs(input, target)
    threshold = _create_threshold_tensor(threshold, input.device)
    _binned_precision_recall_curve_param_check(threshold)
    if num_classes is None and input.dim() == 2:
        num_classes = input.shape[1]
    num_tp, num_fp, num_fn = _multiclass_binned_precision_recall_curve_update(
        input, target, num_classes, threshold
    )
    return _multiclass_binned_precision_recall_curve_compute(
        num_tp, num_fp, num_fn, num_classes, threshold
    )


def _binary_binned_precision_recall_curve_update(
    input: torch.Tensor,
    target: torch.Tensor,
    threshold: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _binary_binned_update_input_check(input, target)
    return _binary_binned_update_kernel(input, target, threshold)


def _binary_binned_update_kernel(
    input: torch.Tensor, target: torch.Tensor, threshold: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    # Lazy import: binned_auc imports this module's helpers.
    from torcheval_tpu_torch.metrics.functional.classification.binned_auc import (
        _binned_counts_rows,
    )

    num_tp, num_fp, num_pos, _ = _binned_counts_rows(
        input[None], (target == 1)[None], threshold
    )
    return num_tp[0], num_fp[0], num_pos[0] - num_tp[0]


def _binary_binned_precision_recall_curve_compute(
    num_tp: torch.Tensor,
    num_fp: torch.Tensor,
    num_fn: torch.Tensor,
    threshold: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    # Precision defaults to 1.0 where there are no positive predictions;
    # a final (1.0, 0.0) sentinel anchors the curve on the y-axis
    # (reference ``binned_precision_recall_curve.py:81-110``).
    precision = torch.nan_to_num(num_tp / (num_tp + num_fp), nan=1.0)
    recall = num_tp / (num_tp + num_fn)
    one = torch.ones(1, device=precision.device)
    precision = torch.cat([precision, one])
    recall = torch.cat([recall, torch.zeros_like(one)])
    return precision, recall, threshold


def _multiclass_binned_validate(
    input: torch.Tensor, target: torch.Tensor, num_classes: Optional[int]
) -> None:
    """Update validation shared by the functional and class paths."""
    _multiclass_binned_update_input_check(input, target, num_classes)
    # Out-of-range targets must raise: the one-vs-rest hits would count
    # them as a negative of every class.
    _check_index_range(
        target, num_classes, "target", site="binned_precision_recall_curve"
    )


def _multiclass_binned_precision_recall_curve_update(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int],
    threshold: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _multiclass_binned_validate(input, target, num_classes)
    return _multiclass_binned_update_kernel(input, target, threshold, num_classes)


def _multiclass_binned_update_kernel(
    input: torch.Tensor,
    target: torch.Tensor,
    threshold: torch.Tensor,
    num_classes: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    # One thin epilogue over the SAME one-vs-rest counts the binned AUC
    # family uses.
    from torcheval_tpu_torch.metrics.functional.classification.binned_auc import (
        _multiclass_binned_counts_kernel,
    )

    num_tp_c, num_fp_c, num_pos_c, _ = _multiclass_binned_counts_kernel(
        input, target, threshold, num_classes
    )
    num_tp = num_tp_c.T  # (T, C): the reference's state layout
    return num_tp, num_fp_c.T, num_pos_c[None, :] - num_tp


def _multiclass_binned_precision_recall_curve_compute(
    num_tp: torch.Tensor,
    num_fp: torch.Tensor,
    num_fn: torch.Tensor,
    num_classes: Optional[int],
    threshold: torch.Tensor,
) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
    precision, recall = _multiclass_binned_compute_kernel(num_tp, num_fp, num_fn)
    return list(precision.T), list(recall.T), threshold


def _multiclass_binned_compute_kernel(
    num_tp: torch.Tensor, num_fp: torch.Tensor, num_fn: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    num_classes = num_tp.shape[1]
    precision = torch.nan_to_num(num_tp / (num_tp + num_fp), nan=1.0)
    recall = num_tp / (num_tp + num_fn)
    ones = torch.ones((1, num_classes), device=precision.device)
    precision = torch.cat([precision, ones], dim=0)
    recall = torch.cat([recall, torch.zeros_like(ones)], dim=0)
    return precision, recall


def _create_threshold_tensor(threshold: Threshold, device: torch.device) -> torch.Tensor:
    """int → the ``jnp.linspace(0, 1, n)`` grid; a list or tensor becomes
    an f32 tensor (reference ``binned_precision_recall_curve.py:224-232``).
    Grids are cached per (count, device), so repeated calls hand the
    kernels the same buffer; treat it as read-only."""
    if isinstance(threshold, int):
        return _linspace_grid(threshold, torch.device(device))
    return torch.as_tensor(threshold, dtype=torch.float32, device=device)


@lru_cache(maxsize=64)
def _linspace_grid(count: int, device: torch.device) -> torch.Tensor:
    """``jnp.linspace(0, 1.0, count)`` in f32, bit for bit.  JAX divides
    the f32 iota ``0 .. count − 2`` by the constant ``f32(count − 1)``,
    which XLA compiles to a product with the f32 reciprocal, and appends
    ``stop = 1.0`` itself (``0·(1 − step) + 1·step`` is ``step``
    exactly).  A correctly rounded division, or the product carried to
    the last entry, each differ from it on some counts.  ``count == 1``
    is ``[0.]``."""
    grid = torch.arange(count, dtype=torch.float32, device=device)
    if count < 2:
        return grid
    step = torch.tensor(1.0, dtype=torch.float32) / torch.tensor(
        count - 1, dtype=torch.float32
    )
    grid = grid * step.to(device)
    grid[-1] = 1.0
    return grid


def _binned_precision_recall_curve_param_check(threshold: torch.Tensor) -> None:
    """Thresholds must be sorted and within [0, 1]
    (reference ``binned_precision_recall_curve.py:235-242``); one read
    back."""
    (t,) = to_host(threshold, site="binned_thresholds")
    if bool((t[1:] - t[:-1] < 0.0).any()):
        raise ValueError("The `threshold` should be a sorted array.")
    if bool((t < 0.0).any()) or bool((t > 1.0).any()):
        raise ValueError("The values in `threshold` should be in the range of [0, 1].")


def _binary_binned_update_input_check(input: torch.Tensor, target: torch.Tensor) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same shape, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if input.dim() != 1:
        raise ValueError(
            f"input should be a one-dimensional tensor, got shape {tuple(input.shape)}."
        )


def _multiclass_binned_update_input_check(
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
            f"got {tuple(input.shape)}."
        )
