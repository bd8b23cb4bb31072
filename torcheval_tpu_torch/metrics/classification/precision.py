"""Precision metrics — the port of
``torcheval_tpu/metrics/classification/precision.py`` (parity with the
reference ``torcheval/metrics/classification/precision.py``)."""

from typing import Iterable, Optional

import torch

from torcheval_tpu_torch.metrics._fuse import accumulate, on_device
from torcheval_tpu_torch.metrics._merge import merge_add
from torcheval_tpu_torch.metrics.functional.classification.confusion_matrix import (
    _counts_route,
)
from torcheval_tpu_torch.metrics.functional.classification.precision import (
    _binary_precision_update_input_check,
    _binary_precision_update_kernel,
    _precision_compute,
    _precision_param_check,
    _precision_update_kernel,
    _precision_validate,
)
from torcheval_tpu_torch.metrics.metric import Metric

_STATES = ("num_tp", "num_fp", "num_label")


class MulticlassPrecision(Metric[torch.Tensor]):
    """States ``num_tp`` / ``num_fp`` / ``num_label``: f32 scalars for
    micro, per-class f32 vectors otherwise (reference
    ``precision.py:89-110``); merge: add."""

    # Accepts update(..., mask=): rows where the mask is 0 add nothing.
    _supports_mask = True

    def __init__(
        self,
        *,
        num_classes: Optional[int] = None,
        average: Optional[str] = "micro",
        device=None,
    ) -> None:
        super().__init__(device=device)
        _precision_param_check(num_classes, average)
        self.num_classes = num_classes
        self.average = average
        for name in _STATES:
            self._add_state(
                name, torch.tensor(0.0) if average == "micro" else torch.zeros(num_classes)
            )

    def update(self, input, target, *, mask=None) -> "MulticlassPrecision":
        input, target, mask = on_device(self.device, input, target, mask)
        _precision_validate(input, target, self.num_classes, self.average)
        self.num_tp, self.num_fp, self.num_label = accumulate(
            _precision_update_kernel,
            (self.num_tp, self.num_fp, self.num_label),
            input,
            target,
            statics=(
                self.num_classes,
                self.average,
                _counts_route(input, self.num_classes, self.average),
            ),
            mask=mask,
        )
        return self

    def compute(self) -> torch.Tensor:
        return _precision_compute(
            self.num_tp, self.num_fp, self.num_label, self.average
        )

    def merge_state(self, metrics: Iterable["MulticlassPrecision"]):
        merge_add(self, metrics, *_STATES)
        return self


class BinaryPrecision(MulticlassPrecision):
    """Binary precision over thresholded predictions
    (reference ``precision.py:155-214``)."""

    def __init__(self, *, threshold: float = 0.5, device=None) -> None:
        super().__init__(num_classes=2, device=device)
        self.threshold = threshold

    def update(self, input, target, *, mask=None) -> "BinaryPrecision":
        input, target, mask = on_device(self.device, input, target, mask)
        _binary_precision_update_input_check(input, target)
        self.num_tp, self.num_fp, self.num_label = accumulate(
            _binary_precision_update_kernel,
            (self.num_tp, self.num_fp, self.num_label),
            input,
            target,
            statics=(self.threshold,),
            mask=mask,
        )
        return self
