"""Confusion-matrix metrics — the port of
``torcheval_tpu/metrics/classification/confusion_matrix.py`` (parity with
the reference ``torcheval/metrics/classification/confusion_matrix.py``)."""

from typing import Iterable, Optional

import torch

from torcheval_tpu_torch.metrics._fuse import accumulate, on_device
from torcheval_tpu_torch.metrics._merge import merge_add
from torcheval_tpu_torch.metrics.functional.classification.confusion_matrix import (
    _binary_confusion_matrix_update_kernel,
    _binary_confusion_matrix_validate,
    _cm_route,
    _confusion_matrix_compute,
    _confusion_matrix_param_check,
    _confusion_matrix_update_input_check,
    _confusion_matrix_update_kernel,
    _use_matmul_cm,
)
from torcheval_tpu_torch.metrics.metric import Metric


class MulticlassConfusionMatrix(Metric[torch.Tensor]):
    """State: ``confusion_matrix``, a (C, C) int32 counter (reference
    ``confusion_matrix.py:30-210``); merge: add.  Entry (i, j) counts
    true class i predicted as j."""

    # Accepts update(..., mask=): rows where the mask is 0 add nothing.
    _supports_mask = True
    # update() is _validate() then _update_body() (Metric._graph_update).
    _graph_update = True

    def __init__(
        self,
        num_classes: int,
        *,
        normalize: Optional[str] = None,
        device=None,
    ) -> None:
        super().__init__(device=device)
        _confusion_matrix_param_check(num_classes, normalize)
        self.num_classes = num_classes
        self.normalize = normalize
        self._add_state(
            "confusion_matrix", torch.zeros((num_classes, num_classes), dtype=torch.int32)
        )

    def update(self, input, target, *, mask=None) -> "MulticlassConfusionMatrix":
        input, target, mask = on_device(self.device, input, target, mask)
        self._validate(input, target, mask=mask)
        self._update_body(input, target, mask=mask)
        return self

    def _validate(self, input, target, *, mask=None) -> None:
        _confusion_matrix_update_input_check(input, target, self.num_classes)

    def _update_body(self, input, target, *, mask=None) -> None:
        (self.confusion_matrix,) = accumulate(
            _confusion_matrix_update_kernel,
            (self.confusion_matrix,),
            input,
            target,
            statics=(self.num_classes, _cm_route(self.num_classes, input.shape[0])),
            mask=mask,
        )

    def compute(self) -> torch.Tensor:
        return _confusion_matrix_compute(self.confusion_matrix, self.normalize)

    def normalized(self, normalize: Optional[str] = None) -> torch.Tensor:
        """The confusion matrix under a different normalization without
        changing the state (reference ``confusion_matrix.py:183-201``)."""
        _confusion_matrix_param_check(self.num_classes, normalize)
        return _confusion_matrix_compute(self.confusion_matrix, normalize)

    def merge_state(self, metrics: Iterable["MulticlassConfusionMatrix"]):
        merge_add(self, metrics, "confusion_matrix")
        return self


class BinaryConfusionMatrix(MulticlassConfusionMatrix):
    """2×2 confusion matrix of thresholded predictions
    (reference ``confusion_matrix.py:212-306``)."""

    def __init__(
        self,
        *,
        threshold: float = 0.5,
        normalize: Optional[str] = None,
        device=None,
    ) -> None:
        super().__init__(num_classes=2, normalize=normalize, device=device)
        self.threshold = threshold

    def _validate(self, input, target, *, mask=None) -> None:
        _binary_confusion_matrix_validate(input, target)

    def _update_body(self, input, target, *, mask=None) -> None:
        (self.confusion_matrix,) = accumulate(
            _binary_confusion_matrix_update_kernel,
            (self.confusion_matrix,),
            input,
            target,
            statics=(self.threshold, _use_matmul_cm(2, input.shape[0])),
            mask=mask,
        )
