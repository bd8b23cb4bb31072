"""Max metric (the port of ``torcheval_tpu/metrics/aggregation/max.py``;
parity with the reference ``torcheval/metrics/aggregation/max.py``).
State: a scalar initialized to -inf; merge: pairwise max."""

from typing import Iterable

import torch

from torcheval_tpu_torch.metrics._fuse import on_device
from torcheval_tpu_torch.metrics.functional._host_checks import x64_off
from torcheval_tpu_torch.metrics.metric import Metric


class Max(Metric[torch.Tensor]):
    _extremum_states = ("max",)

    def __init__(self, *, device=None) -> None:
        super().__init__(device=device)
        self._add_state("max", torch.tensor(float("-inf")))

    def update(self, input) -> "Max":
        (input,) = x64_off(*on_device(self.device, input))
        self.max = torch.maximum(self.max, torch.max(input))
        return self

    def compute(self) -> torch.Tensor:
        return self.max

    def merge_state(self, metrics: Iterable["Max"]) -> "Max":
        for metric in metrics:
            self.max = torch.maximum(self.max, metric.max.to(self.device))
        return self
