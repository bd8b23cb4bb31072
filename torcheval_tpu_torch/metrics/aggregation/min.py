"""Min metric (the port of ``torcheval_tpu/metrics/aggregation/min.py``;
parity with the reference ``torcheval/metrics/aggregation/min.py``).
State: a scalar initialized to +inf; merge: pairwise min."""

from typing import Iterable

import torch

from torcheval_tpu_torch.metrics._fuse import on_device
from torcheval_tpu_torch.metrics.functional._host_checks import x64_off
from torcheval_tpu_torch.metrics.metric import Metric


class Min(Metric[torch.Tensor]):
    _extremum_states = ("min",)

    def __init__(self, *, device=None) -> None:
        super().__init__(device=device)
        self._add_state("min", torch.tensor(float("inf")))

    def update(self, input) -> "Min":
        (input,) = x64_off(*on_device(self.device, input))
        self.min = torch.minimum(self.min, torch.min(input))
        return self

    def compute(self) -> torch.Tensor:
        return self.min

    def merge_state(self, metrics: Iterable["Min"]) -> "Min":
        for metric in metrics:
            self.min = torch.minimum(self.min, metric.min.to(self.device))
        return self
