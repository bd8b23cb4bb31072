"""Recall-at-fixed-precision metrics — the port of
``torcheval_tpu/metrics/classification/recall_at_fixed_precision.py``:
buffered samples, like the PR-curve classes they are built on."""

from typing import List, Optional, Tuple

import torch

from torcheval_tpu_torch.metrics.classification.precision_recall_curve import (
    _CurveBuffers,
)
from torcheval_tpu_torch.metrics.functional.classification.precision_recall_curve import (
    _binary_precision_recall_curve_update_input_check,
    _multilabel_precision_recall_curve_update_input_check,
)
from torcheval_tpu_torch.metrics.functional.classification.recall_at_fixed_precision import (
    _NO_THRESHOLD,
    _binary_recall_at_fixed_precision_compute,
    _multilabel_recall_at_fixed_precision_compute,
    _recall_at_fixed_precision_param_check,
)


class BinaryRecallAtFixedPrecision(_CurveBuffers):
    """Best recall (and its threshold) with precision >= ``min_precision``."""

    def __init__(self, *, min_precision: float, device=None) -> None:
        super().__init__(device=device)
        _recall_at_fixed_precision_param_check(min_precision)
        self.min_precision = min_precision

    def update(self, input, target) -> "BinaryRecallAtFixedPrecision":
        input, target = torch.as_tensor(input), torch.as_tensor(target)
        _binary_precision_recall_curve_update_input_check(input, target)
        self._append(input, target)
        return self

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor]:
        if not self.inputs:
            return (
                torch.tensor(0.0, device=self.device),
                torch.tensor(_NO_THRESHOLD, dtype=torch.float32, device=self.device),
            )
        return _binary_recall_at_fixed_precision_compute(
            torch.cat(self.inputs), torch.cat(self.targets), self.min_precision
        )


class MultilabelRecallAtFixedPrecision(_CurveBuffers):
    """Per-label best recalls (and thresholds) with precision >=
    ``min_precision``."""

    def __init__(
        self,
        *,
        num_labels: Optional[int] = None,
        min_precision: float,
        device=None,
    ) -> None:
        super().__init__(device=device)
        _recall_at_fixed_precision_param_check(min_precision)
        self.num_labels = num_labels
        self.min_precision = min_precision

    def update(self, input, target) -> "MultilabelRecallAtFixedPrecision":
        input, target = torch.as_tensor(input), torch.as_tensor(target)
        _multilabel_precision_recall_curve_update_input_check(
            input, target, self.num_labels
        )
        self._append(input, target)
        return self

    def compute(self) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        if not self.inputs:
            return ([], [])
        return _multilabel_recall_at_fixed_precision_compute(
            torch.cat(self.inputs, dim=0),
            torch.cat(self.targets, dim=0),
            self.num_labels,
            self.min_precision,
        )
