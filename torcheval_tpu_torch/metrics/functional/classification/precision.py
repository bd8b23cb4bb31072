"""Precision — the port of
``torcheval_tpu/metrics/functional/classification/precision.py`` (parity
with the reference ``torcheval/metrics/functional/classification/
precision.py``).

Sufficient statistics ``num_tp`` / ``num_fp`` / ``num_label``: scalars
for micro, per-class int32 vectors otherwise, taken from the routed
confusion slab (``_class_counts``).  Classes absent from both input and
target are masked with arithmetic rather than boolean indexing, with
identical results.
"""

import logging
from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.metrics.functional._host_checks import (
    check_index_ranges as _check_index_ranges,
    place_inputs,
)
from torcheval_tpu_torch.metrics.functional.classification.confusion_matrix import (
    _class_counts,
    _counts_route,
)

_logger = logging.getLogger(__name__)


def binary_precision(input, target, *, threshold: float = 0.5) -> torch.Tensor:
    """TP / (TP + FP) after thresholding (reference ``precision.py:16-51``)."""
    input, target = place_inputs(input, target)
    num_tp, num_fp, num_label = _binary_precision_update(input, target, threshold)
    return _precision_compute(num_tp, num_fp, num_label, "micro")


def multiclass_precision(
    input,
    target,
    *,
    num_classes: Optional[int] = None,
    average: Optional[str] = "micro",
) -> torch.Tensor:
    """Multiclass precision with micro/macro/weighted/None averaging
    (reference ``precision.py:54-110``)."""
    _precision_param_check(num_classes, average)
    input, target = place_inputs(input, target)
    num_tp, num_fp, num_label = _precision_update(input, target, num_classes, average)
    return _precision_compute(num_tp, num_fp, num_label, average)


def _precision_update(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int],
    average: Optional[str],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _precision_validate(input, target, num_classes, average)
    return _precision_update_kernel(
        input,
        target,
        num_classes,
        average,
        _counts_route(input, num_classes, average),
    )


def _precision_validate(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int],
    average: Optional[str],
) -> None:
    """Update validation shared by the functional and class paths."""
    _precision_update_input_check(input, target, num_classes)
    if average != "micro":
        pairs = [(target, "target")]
        if input.dim() == 1:
            pairs.append((input, "input"))
        _check_index_ranges(pairs, num_classes)


def _micro_counts(
    input: torch.Tensor, target: torch.Tensor, mask: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """int32 ``(correct, wrong, rows)`` over the (masked) samples, the
    micro statistics of precision, recall and F1."""
    m = (
        torch.ones_like(target, dtype=torch.int32)
        if mask is None
        else mask.to(torch.int32)
    )
    hit = (input == target).to(torch.int32)
    return (
        (hit * m).sum(dtype=torch.int32),
        ((1 - hit) * m).sum(dtype=torch.int32),
        m.sum(dtype=torch.int32),
    )


def _precision_update_kernel(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int],
    average: Optional[str],
    route: str = "scatter",
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if input.dim() == 2:
        input = torch.argmax(input, dim=1)
    if average == "micro":
        num_tp, num_fp, _ = _micro_counts(input, target, mask)
        return num_tp, num_fp, torch.tensor(0.0, device=input.device)
    # One routed slab instead of three label scatters; the false
    # positives are the prediction marginal minus the diagonal.
    num_tp, num_label, num_prediction = _class_counts(
        input, target, num_classes, route, mask=mask
    )
    return num_tp, num_prediction - num_tp, num_label


def _precision_compute(
    num_tp: torch.Tensor,
    num_fp: torch.Tensor,
    num_label: torch.Tensor,
    average: Optional[str],
) -> torch.Tensor:
    if average in (None, "None") and num_tp.dim():
        nan_mask = ((num_tp + num_fp) == 0).cpu().numpy()
        if nan_mask.any():
            bad_class = nan_mask.nonzero()[0]
            _logger.warning(
                f"{bad_class} classes have zero instances in both the "
                "predictions and the ground truth labels. Precision is still "
                "logged as zero."
            )
    precision = torch.nan_to_num(num_tp / (num_tp + num_fp))
    if average == "micro" or average in (None, "None"):
        return precision
    # macro / weighted: ignore classes absent from both input and target
    # (reference ``precision.py:140-147``).
    mask = (num_label != 0) | ((num_tp + num_fp) != 0)
    if average == "macro":
        return torch.sum(torch.where(mask, precision, 0.0)) / torch.sum(mask)
    # weighted
    return torch.sum(precision * num_label) / torch.sum(num_label)


def _precision_param_check(
    num_classes: Optional[int], average: Optional[str]
) -> None:
    average_options = ("micro", "macro", "weighted", "None", None)
    if average not in average_options:
        raise ValueError(
            f"`average` was not in the allowed value of {average_options}, got {average}."
        )
    if average != "micro" and (num_classes is None or num_classes <= 0):
        raise ValueError(
            f"num_classes should be a positive number when average={average}."
            f" Got num_classes={num_classes}."
        )


def _precision_update_input_check(
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
    if not input.dim() == 1 and not (
        input.dim() == 2 and (num_classes is None or input.shape[1] == num_classes)
    ):
        raise ValueError(
            "input should have shape of (num_sample,) or (num_sample, num_classes), "
            f"got {tuple(input.shape)}."
        )


def _check_index_range(values: torch.Tensor, upper: Optional[int], name: str) -> None:
    """Out-of-range class indices must raise (the JAX scatters drop them
    where torch's ``scatter_`` raises)."""
    _check_index_ranges([(values, name)], upper)


def _binary_precision_update(
    input: torch.Tensor, target: torch.Tensor, threshold: float = 0.5
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _binary_precision_update_input_check(input, target)
    return _binary_precision_update_kernel(input, target, threshold)


def _binary_precision_update_kernel(
    input: torch.Tensor,
    target: torch.Tensor,
    threshold: float,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    pred_b = ~(input < threshold)  # where(input < threshold, 0, 1), NaN → 1
    target_b = target.to(torch.bool)
    if mask is not None:
        valid = mask.to(torch.bool)
        pred_b = pred_b & valid
        target_b = target_b & valid
    num_fp = (pred_b & ~target_b).sum(dtype=torch.int32)
    num_tp = (pred_b & target_b).sum(dtype=torch.int32)
    return num_tp, num_fp, torch.tensor(0.0, device=input.device)


def _binary_precision_update_input_check(
    input: torch.Tensor, target: torch.Tensor
) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same dimensions, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if target.dim() != 1:
        raise ValueError(
            f"target should be a one-dimensional tensor, got shape {tuple(target.shape)}."
        )
