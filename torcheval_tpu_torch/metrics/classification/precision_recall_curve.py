"""PR-curve metrics — the port of
``torcheval_tpu/metrics/classification/precision_recall_curve.py``
(parity with the reference ``torcheval/metrics/classification/
precision_recall_curve.py``).

Sample-buffer states; all curve math happens at compute, with one read
back."""

from typing import Iterable, List, Optional, Tuple

import torch

from torcheval_tpu_torch.metrics._buffer import (
    merge_concat_buffers,
    prepare_concat_buffers,
)
from torcheval_tpu_torch.metrics.functional._host_checks import x64_off
from torcheval_tpu_torch.metrics.functional.classification.precision_recall_curve import (
    _binary_precision_recall_curve_compute,
    _binary_precision_recall_curve_update_input_check,
    _multiclass_precision_recall_curve_compute,
    _multiclass_precision_recall_curve_update_input_check,
    _multilabel_precision_recall_curve_compute,
    _multilabel_precision_recall_curve_update_input_check,
)
from torcheval_tpu_torch.metrics.metric import Metric

Curve = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Curves = Tuple[List[torch.Tensor], List[torch.Tensor], List[torch.Tensor]]


class _CurveBuffers(Metric):
    """``inputs``/``targets`` sample buffers along dim 0, merged by
    concatenation."""

    def __init__(self, device=None) -> None:
        super().__init__(device=device)
        self._add_state("inputs", [])
        self._add_state("targets", [])

    def _append(self, input: torch.Tensor, target: torch.Tensor) -> None:
        input, target = x64_off(input.to(self.device), target.to(self.device))
        self.inputs.append(input)
        self.targets.append(target)

    def merge_state(self, metrics: Iterable["_CurveBuffers"]):
        merge_concat_buffers(self, metrics, "inputs", "targets", dim=0)
        return self

    def _prepare_for_merge_state(self) -> None:
        prepare_concat_buffers(self, "inputs", "targets", dim=0)


class BinaryPrecisionRecallCurve(_CurveBuffers):
    def __init__(self, *, device=None) -> None:
        super().__init__(device=device)

    def update(self, input, target) -> "BinaryPrecisionRecallCurve":
        input, target = torch.as_tensor(input), torch.as_tensor(target)
        _binary_precision_recall_curve_update_input_check(input, target)
        self._append(input, target)
        return self

    def compute(self) -> Curve:
        if not self.inputs:
            empty = torch.zeros(0, device=self.device)
            return (empty, empty.clone(), empty.clone())
        return _binary_precision_recall_curve_compute(
            torch.cat(self.inputs), torch.cat(self.targets)
        )


class MulticlassPrecisionRecallCurve(_CurveBuffers):
    def __init__(self, *, num_classes: Optional[int] = None, device=None) -> None:
        super().__init__(device=device)
        self.num_classes = num_classes

    def update(self, input, target) -> "MulticlassPrecisionRecallCurve":
        input, target = torch.as_tensor(input), torch.as_tensor(target)
        _multiclass_precision_recall_curve_update_input_check(
            input, target, self.num_classes
        )
        self._append(input, target)
        return self

    def compute(self) -> Curves:
        if not self.inputs:
            return ([], [], [])
        return _multiclass_precision_recall_curve_compute(
            torch.cat(self.inputs, dim=0),
            torch.cat(self.targets, dim=0),
            self.num_classes,
        )


class MultilabelPrecisionRecallCurve(_CurveBuffers):
    """Per-label PR curves over a 0/1 label matrix."""

    def __init__(self, *, num_labels: Optional[int] = None, device=None) -> None:
        super().__init__(device=device)
        self.num_labels = num_labels

    def update(self, input, target) -> "MultilabelPrecisionRecallCurve":
        input, target = torch.as_tensor(input), torch.as_tensor(target)
        _multilabel_precision_recall_curve_update_input_check(
            input, target, self.num_labels
        )
        self._append(input, target)
        return self

    def compute(self) -> Curves:
        if not self.inputs:
            return ([], [], [])
        return _multilabel_precision_recall_curve_compute(
            torch.cat(self.inputs, dim=0),
            torch.cat(self.targets, dim=0),
            self.num_labels,
        )
