"""F1 score — the port of
``torcheval_tpu/metrics/functional/classification/f1_score.py`` (parity
with the reference ``torcheval/metrics/functional/classification/
f1_score.py``).

Sufficient statistics ``num_tp`` / ``num_label`` / ``num_prediction``:
scalars for micro, per-class int32 vectors otherwise, taken from the
routed confusion slab (``_class_counts``: at 1000 classes the slab
kernel).  Macro/weighted masking is arithmetic, not boolean indexing.
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


def binary_f1_score(input, target, *, threshold: float = 0.5) -> torch.Tensor:
    """Binary F1 = 2·TP / (#labels + #predictions) after thresholding
    (reference ``f1_score.py:15-48,118-132``)."""
    input, target = place_inputs(input, target)
    num_tp, num_label, num_prediction = _binary_f1_score_update(
        input, target, threshold
    )
    return _f1_score_compute(num_tp, num_label, num_prediction, "micro")


def multiclass_f1_score(
    input,
    target,
    *,
    num_classes: Optional[int] = None,
    average: Optional[str] = "micro",
) -> torch.Tensor:
    """Multiclass F1 with micro/macro/weighted/None averaging
    (reference ``f1_score.py:51-115``)."""
    _f1_score_param_check(num_classes, average)
    input, target = place_inputs(input, target)
    num_tp, num_label, num_prediction = _f1_score_update(
        input, target, num_classes, average
    )
    return _f1_score_compute(num_tp, num_label, num_prediction, average)


def _f1_score_update(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int],
    average: Optional[str],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _f1_score_validate(input, target, num_classes, average)
    return _f1_score_update_kernel(
        input,
        target,
        num_classes,
        average,
        _counts_route(input, num_classes, average),
    )


def _f1_score_validate(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int],
    average: Optional[str],
) -> None:
    """Update validation shared by the functional and class paths."""
    _f1_score_update_input_check(input, target, num_classes)
    if average != "micro":
        pairs = [(target, "target")]
        if input.dim() == 1:
            pairs.append((input, "input"))
        _check_index_ranges(pairs, num_classes)


def _f1_score_update_kernel(
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
        num_tp, _, num_label = _micro_counts(input, target, mask)
        return num_tp, num_label, num_label
    # One routed slab instead of three label scatters (_class_counts).
    return _class_counts(input, target, num_classes, route, mask=mask)


def _f1_score_compute(
    num_tp: torch.Tensor,
    num_label: torch.Tensor,
    num_prediction: torch.Tensor,
    average: Optional[str],
) -> torch.Tensor:
    if num_label.dim() and bool(torch.any(num_label == 0)):
        _logger.warning(
            "Warning: Some classes do not exist in the target. F1 scores for "
            "these classes will be cast to zeros."
        )
    precision = num_tp / num_prediction
    recall = num_tp / num_label
    f1 = torch.nan_to_num(2 * precision * recall / (precision + recall))
    if average == "micro" or average is None:
        return f1
    mask = (num_label != 0) | (num_prediction != 0)
    if average == "macro":
        return torch.sum(torch.where(mask, f1, 0.0)) / torch.sum(mask)
    # weighted
    return torch.sum(f1 * num_label) / torch.sum(num_label)


def _binary_f1_score_update(
    input: torch.Tensor, target: torch.Tensor, threshold: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _binary_f1_score_update_input_check(input, target)
    return _binary_f1_score_update_kernel(input, target, threshold)


def _binary_f1_score_update_kernel(
    input: torch.Tensor,
    target: torch.Tensor,
    threshold: float,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    pred = torch.where(input < threshold, 0, 1).to(torch.int32)
    if mask is not None:
        target = target * mask.to(target.dtype)
        pred = pred * mask.to(pred.dtype)
    return _total(pred * target), _total(target), _total(pred)


def _total(x: torch.Tensor) -> torch.Tensor:
    """Sum in the input's JAX dtype: int32 for integers, float as is."""
    return x.sum() if x.is_floating_point() else x.sum(dtype=torch.int32)


def _f1_score_param_check(
    num_classes: Optional[int], average: Optional[str]
) -> None:
    average_options = ("micro", "macro", "weighted", None)
    if average not in average_options:
        raise ValueError(
            f"`average` was not in the allowed value of {average_options}, got {average}."
        )
    if average != "micro" and (num_classes is None or num_classes <= 0):
        raise ValueError(
            f"num_classes should be a positive number when average={average}, "
            f"got num_classes={num_classes}."
        )


def _f1_score_update_input_check(
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


def _binary_f1_score_update_input_check(input: torch.Tensor, target: torch.Tensor) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same dimensions, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if target.dim() != 1:
        raise ValueError(
            f"target should be a one-dimensional tensor, got shape {tuple(target.shape)}."
        )
