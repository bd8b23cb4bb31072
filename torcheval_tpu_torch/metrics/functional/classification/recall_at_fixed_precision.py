"""Recall at fixed precision — the port of
``torcheval_tpu/metrics/functional/classification/recall_at_fixed_precision.py``.

The best reachable recall under a precision floor, and the decision
threshold that reaches it, built on the exact PR-curve cores: the device
computes the fixed-shape sorted tie-group counts, and the selection over
curve points is a host-side epilogue at the compute boundary.

Semantics: over all PR-curve points with ``precision >= min_precision``,
return the maximum recall and the *largest* threshold attaining it (the
most conservative operating point at that recall).  When no threshold
satisfies the floor, returns ``(0.0, 1e6)``, the sentinel upstream
torcheval uses for "no feasible threshold".
"""

from typing import List, Optional, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.metrics.functional._host_checks import place_inputs, to_host
from torcheval_tpu_torch.metrics.functional.classification.precision_recall_curve import (
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_update_input_check,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_update_input_check,
)

_NO_THRESHOLD = 1e6


def binary_recall_at_fixed_precision(
    input,
    target,
    *,
    min_precision: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max recall, threshold) such that precision >= ``min_precision``."""
    _recall_at_fixed_precision_param_check(min_precision)
    input, target = place_inputs(input, target)
    _binary_precision_recall_curve_update_input_check(input, target)
    return _binary_recall_at_fixed_precision_compute(input, target, min_precision)


def multilabel_recall_at_fixed_precision(
    input,
    target,
    *,
    num_labels: Optional[int] = None,
    min_precision: float,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Per-label ``(max recalls, thresholds)`` lists such that each label's
    precision >= ``min_precision``."""
    _recall_at_fixed_precision_param_check(min_precision)
    input, target = place_inputs(input, target)
    if num_labels is None and input.dim() == 2:
        num_labels = input.shape[1]
    _multilabel_precision_recall_curve_update_input_check(input, target, num_labels)
    return _multilabel_recall_at_fixed_precision_compute(
        input, target, num_labels, min_precision
    )


def _best_point(
    precision: torch.Tensor,
    recall: torch.Tensor,
    thresholds: torch.Tensor,
    min_precision: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select max recall under the precision floor from one curve.  The
    curve arrays carry the (1.0, 0.0) sentinel as their last point, which
    has no threshold: it only matters when nothing else qualifies, and
    then the sentinel result (0.0, _NO_THRESHOLD) is returned anyway."""
    device = precision.device
    precision, recall, thresholds = to_host(precision, recall, thresholds)
    precision, recall = precision[:-1], recall[:-1]
    ok = precision >= min_precision
    if not ok.any() or float(recall[ok].max()) == 0.0:
        return (
            torch.tensor(0.0, device=device),
            torch.tensor(_NO_THRESHOLD, dtype=torch.float32, device=device),
        )
    max_recall = recall[ok].max()
    at_max = ok & (recall == max_recall)
    return (
        torch.tensor(np.float32(max_recall), device=device),
        torch.tensor(np.float32(thresholds[at_max].max()), device=device),
    )


def _binary_recall_at_fixed_precision_compute(
    input: torch.Tensor, target: torch.Tensor, min_precision: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    precision, recall, thresholds = _binary_precision_recall_curve_compute(
        input, target
    )
    return _best_point(precision, recall, thresholds, min_precision)


def _multilabel_recall_at_fixed_precision_compute(
    input: torch.Tensor,
    target: torch.Tensor,
    num_labels: Optional[int],
    min_precision: float,
) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    precisions, recalls, thresholds = _multilabel_precision_recall_curve_compute(
        input, target, num_labels
    )
    best = [
        _best_point(p, r, t, min_precision)
        for p, r, t in zip(precisions, recalls, thresholds)
    ]
    return [b[0] for b in best], [b[1] for b in best]


def _recall_at_fixed_precision_param_check(min_precision: float) -> None:
    if not isinstance(min_precision, float) or not 0.0 <= min_precision <= 1.0:
        raise ValueError(
            "Expected min_precision to be a float in the [0, 1] range, but got "
            f"{min_precision}."
        )
