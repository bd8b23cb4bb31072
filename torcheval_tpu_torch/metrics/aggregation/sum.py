"""Sum metric (the port of ``torcheval_tpu/metrics/aggregation/sum.py``;
parity with the reference ``torcheval/metrics/aggregation/sum.py``).
State: a scalar ``weighted_sum``; merge: add."""

from typing import Iterable, Union

import torch

from torcheval_tpu_torch.metrics._fuse import accumulate, on_device
from torcheval_tpu_torch.metrics._merge import merge_add
from torcheval_tpu_torch.metrics.functional._host_checks import x64_off
from torcheval_tpu_torch.metrics.functional.aggregation.sum import (
    _sum_validate,
    _weighted_sum,
)
from torcheval_tpu_torch.metrics.metric import Metric


class Sum(Metric[torch.Tensor]):
    def __init__(self, *, device=None) -> None:
        super().__init__(device=device)
        self._add_state("weighted_sum", torch.tensor(0.0))

    def update(self, input, weight: Union[float, int, torch.Tensor] = 1.0) -> "Sum":
        (input,) = x64_off(*on_device(self.device, input))
        _sum_validate(input, weight)
        if not isinstance(weight, (float, int)):
            (weight,) = x64_off(*on_device(self.device, weight))
        (self.weighted_sum,) = accumulate(
            _weighted_sum, (self.weighted_sum,), input, weight
        )
        return self

    def compute(self) -> torch.Tensor:
        return self.weighted_sum

    def merge_state(self, metrics: Iterable["Sum"]) -> "Sum":
        merge_add(self, metrics, "weighted_sum")
        return self
