"""Binned PR-curve metrics — the port of
``torcheval_tpu/metrics/classification/binned_precision_recall_curve.py``
(parity with the reference ``torcheval/metrics/classification/
binned_precision_recall_curve.py``).  Fixed-threshold per-bin counters:
fixed-shape state, mergeable by addition.  As in the JAX package the
count states are f32 (the reference's ``zeros`` default), and each
update's int32 counts add into them."""

from typing import Iterable, List, Tuple

import torch

from torcheval_tpu_torch.metrics._fuse import accumulate, on_device
from torcheval_tpu_torch.metrics._merge import merge_add
from torcheval_tpu_torch.metrics.functional.classification.binned_precision_recall_curve import (
    Threshold,
    _binary_binned_precision_recall_curve_compute,
    _binary_binned_update_input_check,
    _binary_binned_update_kernel,
    _binned_precision_recall_curve_param_check,
    _create_threshold_tensor,
    _multiclass_binned_precision_recall_curve_compute,
    _multiclass_binned_update_kernel,
    _multiclass_binned_validate,
)
from torcheval_tpu_torch.metrics.metric import Metric

_COUNTS = ("num_tp", "num_fp", "num_fn")


class BinaryBinnedPrecisionRecallCurve(
    Metric[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
):
    """States: ``threshold`` + per-bin ``num_tp``/``num_fp``/``num_fn``
    vectors (reference ``binned_precision_recall_curve.py:64-80``); merge:
    add counts (reference ``:121-133``)."""

    def __init__(self, *, threshold: Threshold = 100, device=None) -> None:
        super().__init__(device=device)
        threshold = _create_threshold_tensor(threshold, self.device)
        _binned_precision_recall_curve_param_check(threshold)
        self._add_state("threshold", threshold)
        n = threshold.shape[0]
        for name in _COUNTS:
            self._add_state(name, torch.zeros(n))

    def update(self, input, target) -> "BinaryBinnedPrecisionRecallCurve":
        input, target = on_device(self.device, input, target)
        _binary_binned_update_input_check(input, target)
        self.num_tp, self.num_fp, self.num_fn = accumulate(
            _binary_binned_update_kernel,
            (self.num_tp, self.num_fp, self.num_fn),
            input,
            target,
            self.threshold,
        )
        return self

    def compute(self) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(precision, recall, thresholds); precision/recall carry the extra
        (1.0, 0.0) sentinel point."""
        return _binary_binned_precision_recall_curve_compute(
            self.num_tp, self.num_fp, self.num_fn, self.threshold
        )

    def merge_state(self, metrics: Iterable["BinaryBinnedPrecisionRecallCurve"]):
        merge_add(self, metrics, *_COUNTS)
        return self


class MulticlassBinnedPrecisionRecallCurve(
    Metric[Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]]
):
    """States: ``threshold`` + ``(n_thresholds, n_classes)`` count matrices
    (reference ``binned_precision_recall_curve.py:167-194``); merge: add."""

    def __init__(
        self,
        *,
        num_classes: int,
        threshold: Threshold = 100,
        device=None,
    ) -> None:
        super().__init__(device=device)
        threshold = _create_threshold_tensor(threshold, self.device)
        _binned_precision_recall_curve_param_check(threshold)
        if not isinstance(num_classes, int) or num_classes < 2:
            raise ValueError(f"`num_classes` has to be at least 2, got {num_classes}.")
        self.num_classes = num_classes
        self._add_state("threshold", threshold)
        n = threshold.shape[0]
        for name in _COUNTS:
            self._add_state(name, torch.zeros((n, num_classes)))

    def update(self, input, target) -> "MulticlassBinnedPrecisionRecallCurve":
        input, target = on_device(self.device, input, target)
        _multiclass_binned_validate(input, target, self.num_classes)
        self.num_tp, self.num_fp, self.num_fn = accumulate(
            _multiclass_binned_update_kernel,
            (self.num_tp, self.num_fp, self.num_fn),
            input,
            target,
            self.threshold,
            statics=(self.num_classes,),
        )
        return self

    def compute(self) -> Tuple[List[torch.Tensor], List[torch.Tensor], torch.Tensor]:
        return _multiclass_binned_precision_recall_curve_compute(
            self.num_tp, self.num_fp, self.num_fn, self.num_classes, self.threshold
        )

    def merge_state(self, metrics: Iterable["MulticlassBinnedPrecisionRecallCurve"]):
        merge_add(self, metrics, *_COUNTS)
        return self
