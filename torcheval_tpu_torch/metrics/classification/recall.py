"""Recall metrics — the port of
``torcheval_tpu/metrics/classification/recall.py`` (parity with the
reference ``torcheval/metrics/classification/recall.py``)."""

from typing import Iterable, Optional

import torch

from torcheval_tpu_torch.metrics._fuse import accumulate, on_device
from torcheval_tpu_torch.metrics._merge import merge_add
from torcheval_tpu_torch.metrics.functional.classification.confusion_matrix import (
    _counts_route,
)
from torcheval_tpu_torch.metrics.functional.classification.recall import (
    _binary_recall_compute,
    _binary_recall_update_input_check,
    _binary_recall_update_kernel,
    _recall_compute,
    _recall_param_check,
    _recall_update_kernel,
    _recall_validate,
)
from torcheval_tpu_torch.metrics.metric import Metric


class BinaryRecall(Metric[torch.Tensor]):
    """States ``num_tp`` / ``num_true_labels``, f32 scalars
    (reference ``recall.py:26-110``); merge: add."""

    # Accepts update(..., mask=): rows where the mask is 0 add nothing.
    _supports_mask = True

    def __init__(self, *, threshold: float = 0.5, device=None) -> None:
        super().__init__(device=device)
        self.threshold = threshold
        self._add_state("num_tp", torch.tensor(0.0))
        self._add_state("num_true_labels", torch.tensor(0.0))

    def update(self, input, target, *, mask=None) -> "BinaryRecall":
        input, target, mask = on_device(self.device, input, target, mask)
        _binary_recall_update_input_check(input, target)
        self.num_tp, self.num_true_labels = accumulate(
            _binary_recall_update_kernel,
            (self.num_tp, self.num_true_labels),
            input,
            target,
            statics=(self.threshold,),
            mask=mask,
        )
        return self

    def compute(self) -> torch.Tensor:
        return _binary_recall_compute(self.num_tp, self.num_true_labels)

    def merge_state(self, metrics: Iterable["BinaryRecall"]):
        merge_add(self, metrics, "num_tp", "num_true_labels")
        return self


class MulticlassRecall(Metric[torch.Tensor]):
    """States ``num_tp`` / ``num_labels`` / ``num_predictions``
    (reference ``recall.py:113-245``); merge: add."""

    # Accepts update(..., mask=): rows where the mask is 0 add nothing.
    _supports_mask = True

    _STATES = ("num_tp", "num_labels", "num_predictions")

    def __init__(
        self,
        *,
        num_classes: Optional[int] = None,
        average: Optional[str] = "micro",
        device=None,
    ) -> None:
        super().__init__(device=device)
        _recall_param_check(num_classes, average)
        self.num_classes = num_classes
        self.average = average
        for name in self._STATES:
            self._add_state(
                name, torch.tensor(0.0) if average == "micro" else torch.zeros(num_classes)
            )

    def update(self, input, target, *, mask=None) -> "MulticlassRecall":
        input, target, mask = on_device(self.device, input, target, mask)
        _recall_validate(input, target, self.num_classes, self.average)
        self.num_tp, self.num_labels, self.num_predictions = accumulate(
            _recall_update_kernel,
            (self.num_tp, self.num_labels, self.num_predictions),
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
        return _recall_compute(
            self.num_tp, self.num_labels, self.num_predictions, self.average
        )

    def merge_state(self, metrics: Iterable["MulticlassRecall"]):
        merge_add(self, metrics, *self._STATES)
        return self
