"""Accuracy family — the port of
``torcheval_tpu/metrics/classification/accuracy.py`` (parity with the
reference ``torcheval/metrics/classification/accuracy.py``):
``MulticlassAccuracy`` and its subclasses ``BinaryAccuracy``,
``MultilabelAccuracy`` and ``TopKMultilabelAccuracy``.  Counter states
(``num_correct`` / ``num_total``) merge by addition."""

from typing import Iterable, Optional

import torch

from torcheval_tpu_torch.metrics._fuse import accumulate, on_device
from torcheval_tpu_torch.metrics._merge import merge_add
from torcheval_tpu_torch.metrics.functional.classification.accuracy import (
    _accuracy_compute,
    _accuracy_param_check,
    _binary_accuracy_update_input_check,
    _binary_accuracy_update_kernel,
    _multiclass_accuracy_update_kernel,
    _multiclass_accuracy_validate,
    _multilabel_accuracy_param_check,
    _multilabel_accuracy_update_input_check,
    _multilabel_accuracy_update_kernel,
    _topk_multilabel_accuracy_param_check,
    _topk_multilabel_accuracy_update_input_check,
    _topk_multilabel_accuracy_update_kernel,
)
from torcheval_tpu_torch.metrics.metric import Metric


class MulticlassAccuracy(Metric[torch.Tensor]):
    """Multiclass accuracy (reference ``classification/accuracy.py:32-160``).

    States: micro → scalar f32 ``num_correct``/``num_total``; macro/None →
    per-class f32 vectors.  Merge: elementwise add."""

    # Accepts update(..., mask=): rows where the mask is 0 add nothing.
    _supports_mask = True
    # update() is _validate() then _update_body(), here and in every
    # subclass below (Metric._graph_update).
    _graph_update = True

    def __init__(
        self,
        *,
        average: Optional[str] = "micro",
        num_classes: Optional[int] = None,
        k: int = 1,
        device=None,
    ) -> None:
        super().__init__(device=device)
        _accuracy_param_check(average, num_classes, k)
        self.average = average
        self.num_classes = num_classes
        self.k = k
        if average == "micro":
            self._add_state("num_correct", torch.tensor(0.0))
            self._add_state("num_total", torch.tensor(0.0))
        else:
            self._add_state("num_correct", torch.zeros(num_classes or 0))
            self._add_state("num_total", torch.zeros(num_classes or 0))

    def update(self, input, target, *, mask=None):
        input, target, mask = on_device(self.device, input, target, mask)
        self._validate(input, target, mask=mask)
        self._update_body(input, target, mask=mask)
        return self

    def _validate(self, input, target, *, mask=None) -> None:
        _multiclass_accuracy_validate(
            input, target, self.average, self.num_classes, self.k
        )

    def _update_body(self, input, target, *, mask=None) -> None:
        self.num_correct, self.num_total = accumulate(
            _multiclass_accuracy_update_kernel,
            (self.num_correct, self.num_total),
            input,
            target,
            statics=(self.average, self.num_classes, self.k),
            mask=mask,
        )

    def compute(self) -> torch.Tensor:
        """The accuracy; 0/0 gives NaN before any update (reference
        behavior)."""
        return _accuracy_compute(self.num_correct, self.num_total, self.average)

    def merge_state(self, metrics: Iterable["MulticlassAccuracy"]):
        merge_add(self, metrics, "num_correct", "num_total")
        return self


class BinaryAccuracy(MulticlassAccuracy):
    """Binary accuracy over thresholded predictions."""

    def __init__(
        self,
        *,
        threshold: float = 0.5,
        device=None,
    ) -> None:
        super().__init__(device=device)
        self.threshold = threshold

    def _validate(self, input, target, *, mask=None) -> None:
        _binary_accuracy_update_input_check(input, target)

    def _update_body(self, input, target, *, mask=None) -> None:
        self.num_correct, self.num_total = accumulate(
            _binary_accuracy_update_kernel,
            (self.num_correct, self.num_total),
            input,
            target,
            statics=(self.threshold,),
            mask=mask,
        )


class MultilabelAccuracy(MulticlassAccuracy):
    """Multilabel accuracy under the exact_match / hamming / overlap /
    contain / belong criteria."""

    def __init__(
        self,
        *,
        threshold: float = 0.5,
        criteria: str = "exact_match",
        device=None,
    ) -> None:
        super().__init__(device=device)
        _multilabel_accuracy_param_check(criteria)
        self.threshold = threshold
        self.criteria = criteria

    def _validate(self, input, target, *, mask=None) -> None:
        _multilabel_accuracy_update_input_check(input, target)

    def _update_body(self, input, target, *, mask=None) -> None:
        self.num_correct, self.num_total = accumulate(
            _multilabel_accuracy_update_kernel,
            (self.num_correct, self.num_total),
            input,
            target,
            statics=(self.threshold, self.criteria),
            mask=mask,
        )


class TopKMultilabelAccuracy(MulticlassAccuracy):
    """Top-k multilabel accuracy; honors ``k`` where the reference
    hardcodes ``topk(k=2)`` (reference functional ``accuracy.py:393-395``)."""

    def __init__(
        self,
        *,
        criteria: str = "exact_match",
        k: int = 2,
        device=None,
    ) -> None:
        super().__init__(device=device)
        _topk_multilabel_accuracy_param_check(criteria, k)
        self.criteria = criteria
        self.k = k

    def _validate(self, input, target, *, mask=None) -> None:
        _topk_multilabel_accuracy_update_input_check(input, target, self.k)

    def _update_body(self, input, target, *, mask=None) -> None:
        self.num_correct, self.num_total = accumulate(
            _topk_multilabel_accuracy_update_kernel,
            (self.num_correct, self.num_total),
            input,
            target,
            statics=(self.criteria, self.k),
            mask=mask,
        )
