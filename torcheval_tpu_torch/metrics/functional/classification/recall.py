"""Recall — the port of
``torcheval_tpu/metrics/functional/classification/recall.py`` (parity
with the reference ``torcheval/metrics/functional/classification/
recall.py``).

Sufficient statistics ``num_tp`` / ``num_labels`` / ``num_predictions``.
As in the JAX package, macro/weighted averages mask classes absent from
both input and target with arithmetic, which computes the statistic the
reference intends where its boolean indexing crashes
(reference ``recall.py:169-180``).
"""

import logging
from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.metrics.functional._host_checks import place_inputs
from torcheval_tpu_torch.metrics.functional.classification.confusion_matrix import (
    _class_counts,
    _counts_route,
)
from torcheval_tpu_torch.metrics.functional.classification.precision import (
    _check_index_ranges,
    _micro_counts,
)

_logger = logging.getLogger(__name__)


def binary_recall(input, target, *, threshold: float = 0.5) -> torch.Tensor:
    """TP / #positive-labels after thresholding (reference ``recall.py:13-46``)."""
    input, target = place_inputs(input, target)
    num_tp, num_true_labels = _binary_recall_update(input, target, threshold)
    return _binary_recall_compute(num_tp, num_true_labels)


def _binary_recall_compute(
    num_tp: torch.Tensor, num_true_labels: torch.Tensor
) -> torch.Tensor:
    """NaN (no positive labels) → 0 with a warning
    (reference ``recall.py:64-77``)."""
    recall = num_tp / num_true_labels
    if bool(torch.isnan(recall)):
        _logger.warning(
            "No positive instances have been seen in target. Recall is "
            "converted from NaN to 0s."
        )
    return torch.nan_to_num(recall)


def multiclass_recall(
    input,
    target,
    *,
    num_classes: Optional[int] = None,
    average: Optional[str] = "micro",
) -> torch.Tensor:
    """Multiclass recall with micro/macro/weighted/None averaging
    (reference ``recall.py:95-151``)."""
    _recall_param_check(num_classes, average)
    input, target = place_inputs(input, target)
    num_tp, num_labels, num_predictions = _recall_update(
        input, target, num_classes, average
    )
    return _recall_compute(num_tp, num_labels, num_predictions, average)


def _recall_update(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int],
    average: Optional[str],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _recall_validate(input, target, num_classes, average)
    return _recall_update_kernel(
        input,
        target,
        num_classes,
        average,
        _counts_route(input, num_classes, average),
    )


def _recall_validate(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int],
    average: Optional[str],
) -> None:
    """Update validation shared by the functional and class paths."""
    _recall_update_input_check(input, target, num_classes)
    if average != "micro":
        pairs = [(target, "target")]
        if input.dim() == 1:
            pairs.append((input, "input"))
        _check_index_ranges(pairs, num_classes, "recall")


def _recall_update_kernel(
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
        num_tp, _, num_labels = _micro_counts(input, target, mask)
        return num_tp, num_labels, num_labels
    # One routed slab instead of three label scatters (_class_counts).
    return _class_counts(input, target, num_classes, route, mask=mask)


def _recall_compute(
    num_tp: torch.Tensor,
    num_labels: torch.Tensor,
    num_predictions: torch.Tensor,
    average: Optional[str],
) -> torch.Tensor:
    if num_tp.dim():
        nan_mask = (num_labels == 0).cpu().numpy()
        if nan_mask.any():
            nan_classes = [int(i) for i in nan_mask.nonzero()[0]]
            _logger.warning(
                f"One or more NaNs identified, as no ground-truth instances of "
                f"{nan_classes} have been seen. These have been converted to zero."
            )
    recall = torch.nan_to_num(num_tp / num_labels)
    if average == "micro" or average is None:
        return recall
    # macro/weighted ignore classes with no samples in target and input
    mask = (num_labels != 0) | (num_predictions != 0)
    if average == "macro":
        return torch.sum(torch.where(mask, recall, 0.0)) / torch.sum(mask)
    # weighted
    return torch.sum(recall * num_labels) / torch.sum(num_labels)


def _recall_param_check(num_classes: Optional[int], average: Optional[str]) -> None:
    average_options = ("micro", "macro", "weighted", None)
    if average not in average_options:
        raise ValueError(
            f"`average` was not in the allowed values of {average_options}, "
            f"got {average}."
        )
    if average != "micro" and (num_classes is None or num_classes <= 0):
        raise ValueError(
            f"`num_classes` should be a positive number when average={average}, "
            f"got num_classes={num_classes}."
        )


def _recall_update_input_check(
    input: torch.Tensor, target: torch.Tensor, num_classes: Optional[int]
) -> None:
    if input.shape[0] != target.shape[0]:
        raise ValueError(
            "The `input` and `target` should have the same first dimension, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if target.dim() != 1:
        raise ValueError(
            f"`target` should be a one-dimensional tensor, got shape {tuple(target.shape)}."
        )
    if input.dim() != 1 and not (
        input.dim() == 2 and (num_classes is None or input.shape[1] == num_classes)
    ):
        raise ValueError(
            "`input` should have shape (num_samples,) or (num_samples, num_classes), "
            f"got {tuple(input.shape)}."
        )


def _binary_recall_update(
    input: torch.Tensor, target: torch.Tensor, threshold: float = 0.5
) -> Tuple[torch.Tensor, torch.Tensor]:
    _binary_recall_update_input_check(input, target)
    return _binary_recall_update_kernel(input, target, threshold)


def _binary_recall_update_kernel(
    input: torch.Tensor,
    target: torch.Tensor,
    threshold: float,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    pred_b = ~(input < threshold)  # where(input < threshold, 0, 1), NaN → 1
    target_b = target.to(torch.bool)
    if mask is not None:
        target_b = target_b & mask.to(torch.bool)
    num_tp = (pred_b & target_b).sum(dtype=torch.int32)
    num_true_labels = target_b.sum(dtype=torch.int32)
    return num_tp, num_true_labels


def _binary_recall_update_input_check(input: torch.Tensor, target: torch.Tensor) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same dimensions, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if target.dim() != 1:
        raise ValueError(
            f"target should be a one-dimensional tensor, got shape {tuple(target.shape)}."
        )
