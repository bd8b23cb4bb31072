"""BinaryNormalizedEntropy metric (the port of
``torcheval_tpu/metrics/classification/binary_normalized_entropy.py``;
parity with the reference
``torcheval/metrics/classification/binary_normalized_entropy.py``).

States: per-task ``total_entropy`` / ``num_examples`` / ``num_positive``
(float64 in the reference; see the dtype note in the functional module);
merge: add."""

from typing import Iterable

import torch

from torcheval_tpu_torch import _stats
from torcheval_tpu_torch.metrics._fuse import accumulate, on_device
from torcheval_tpu_torch.metrics._merge import merge_add
from torcheval_tpu_torch.metrics.functional.classification.binary_normalized_entropy import (
    _accum_dtype,
    _baseline_update,
    _ne_input_check,
    _ne_update_kernel,
    _ne_update_kernel_unweighted,
)
from torcheval_tpu_torch.metrics.metric import Metric

_STATES = ("total_entropy", "num_examples", "num_positive")


class BinaryNormalizedEntropy(Metric[torch.Tensor]):
    # update() is _validate() then _update_body() (Metric._graph_update).
    _graph_update = True

    def __init__(
        self,
        *,
        from_logits: bool = False,
        num_tasks: int = 1,
        device=None,
    ) -> None:
        super().__init__(device=device)
        if num_tasks < 1:
            raise ValueError(
                "`num_tasks` value should be greater than and equal to 1, "
                f"but received {num_tasks}. "
            )
        self.from_logits = from_logits
        self.num_tasks = num_tasks
        for name in _STATES:
            self._add_state(name, torch.zeros(num_tasks, dtype=_accum_dtype()))

    def update(self, input, target, *, weight=None) -> "BinaryNormalizedEntropy":
        input, target, weight = on_device(self.device, input, target, weight)
        self._validate(input, target, weight=weight)
        self._update_body(input, target, weight=weight)
        return self

    def _validate(self, input, target, *, weight=None) -> None:
        _ne_input_check(input, target, self.from_logits, self.num_tasks, weight)

    def _update_body(self, input, target, *, weight=None) -> None:
        # State order follows the kernel's (entropy, positive, examples).
        if weight is None:
            kernel, args = _ne_update_kernel_unweighted, (input, target)
        else:
            kernel, args = _ne_update_kernel, (input, target, weight)
        self.total_entropy, self.num_positive, self.num_examples = accumulate(
            kernel,
            (self.total_entropy, self.num_positive, self.num_examples),
            *args,
            statics=(self.from_logits,),
        )

    def compute(self) -> torch.Tensor:
        """Per-task NE, or an empty tensor when any task saw no examples
        (reference ``binary_normalized_entropy.py:~115-130``)."""
        empty = torch.any(self.num_examples == 0.0)
        if _stats.readback("normalized_entropy.empty", bool, empty):
            return torch.zeros(0, device=self.device)
        baseline_entropy = _baseline_update(self.num_positive, self.num_examples)
        cross_entropy = self.total_entropy / self.num_examples
        return cross_entropy / baseline_entropy

    def merge_state(self, metrics: Iterable["BinaryNormalizedEntropy"]):
        merge_add(self, metrics, *_STATES)
        return self
