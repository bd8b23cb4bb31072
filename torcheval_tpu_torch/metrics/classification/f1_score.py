"""F1 metrics — the port of
``torcheval_tpu/metrics/classification/f1_score.py`` (parity with the
reference ``torcheval/metrics/classification/f1_score.py``)."""

from typing import Iterable, Optional

import torch

from torcheval_tpu_torch.metrics._fuse import accumulate, on_device
from torcheval_tpu_torch.metrics._merge import merge_add
from torcheval_tpu_torch.metrics.functional.classification.confusion_matrix import (
    _counts_route,
)
from torcheval_tpu_torch.metrics.functional.classification.f1_score import (
    _binary_f1_score_update_input_check,
    _binary_f1_score_update_kernel,
    _f1_score_compute,
    _f1_score_param_check,
    _f1_score_update_kernel,
    _f1_score_validate,
)
from torcheval_tpu_torch.metrics.metric import Metric

_STATES = ("num_tp", "num_label", "num_prediction")


class MulticlassF1Score(Metric[torch.Tensor]):
    """States ``num_tp`` / ``num_label`` / ``num_prediction``: f32
    scalars for micro, per-class f32 vectors otherwise (reference
    ``f1_score.py:91-114``); merge: add."""

    # Accepts update(..., mask=): rows where the mask is 0 add nothing.
    _supports_mask = True
    # update() is _validate() then _update_body() (Metric._graph_update).
    _graph_update = True

    def __init__(
        self,
        *,
        num_classes: Optional[int] = None,
        average: Optional[str] = "micro",
        device=None,
    ) -> None:
        super().__init__(device=device)
        _f1_score_param_check(num_classes, average)
        self.num_classes = num_classes
        self.average = average
        for name in _STATES:
            self._add_state(
                name, torch.tensor(0.0) if average == "micro" else torch.zeros(num_classes)
            )

    def update(self, input, target, *, mask=None) -> "MulticlassF1Score":
        input, target, mask = on_device(self.device, input, target, mask)
        self._validate(input, target, mask=mask)
        self._update_body(input, target, mask=mask)
        return self

    def _validate(self, input, target, *, mask=None) -> None:
        _f1_score_validate(input, target, self.num_classes, self.average)

    def _update_body(self, input, target, *, mask=None) -> None:
        self.num_tp, self.num_label, self.num_prediction = accumulate(
            _f1_score_update_kernel,
            (self.num_tp, self.num_label, self.num_prediction),
            input,
            target,
            statics=(
                self.num_classes,
                self.average,
                _counts_route(input, self.num_classes, self.average),
            ),
            mask=mask,
        )

    def compute(self) -> torch.Tensor:
        return _f1_score_compute(
            self.num_tp, self.num_label, self.num_prediction, self.average
        )

    def merge_state(self, metrics: Iterable["MulticlassF1Score"]):
        merge_add(self, metrics, *_STATES)
        return self


class BinaryF1Score(MulticlassF1Score):
    """Binary F1 over thresholded predictions
    (reference ``f1_score.py:157-218``)."""

    def __init__(self, *, threshold: float = 0.5, device=None) -> None:
        super().__init__(average="micro", device=device)
        self.threshold = threshold

    def _validate(self, input, target, *, mask=None) -> None:
        _binary_f1_score_update_input_check(input, target)

    def _update_body(self, input, target, *, mask=None) -> None:
        self.num_tp, self.num_label, self.num_prediction = accumulate(
            _binary_f1_score_update_kernel,
            (self.num_tp, self.num_label, self.num_prediction),
            input,
            target,
            statics=(self.threshold,),
            mask=mask,
        )
