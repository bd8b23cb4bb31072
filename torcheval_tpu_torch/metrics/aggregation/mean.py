"""Mean metric (the port of ``torcheval_tpu/metrics/aggregation/mean.py``;
parity with the reference ``torcheval/metrics/aggregation/mean.py``).
State: ``weighted_sum`` + ``weights``; merge: add."""

import logging
from typing import Iterable, Union

import torch

from torcheval_tpu_torch.metrics._fuse import accumulate, on_device
from torcheval_tpu_torch.metrics._merge import merge_add
from torcheval_tpu_torch.metrics.functional._host_checks import x64_off
from torcheval_tpu_torch.metrics.functional.aggregation.mean import _mean_select_kernel
from torcheval_tpu_torch.metrics.metric import Metric

_logger: logging.Logger = logging.getLogger(__name__)


class Mean(Metric[torch.Tensor]):
    def __init__(self, *, device=None) -> None:
        super().__init__(device=device)
        self._add_state("weighted_sum", torch.tensor(0.0))
        self._add_state("weights", torch.tensor(0.0))

    def update(self, input, weight: Union[float, int, torch.Tensor] = 1.0) -> "Mean":
        (input,) = x64_off(*on_device(self.device, input))
        kernel, args = _mean_select_kernel(input, weight)
        self.weighted_sum, self.weights = accumulate(
            kernel, (self.weighted_sum, self.weights), *args
        )
        return self

    def compute(self) -> torch.Tensor:
        """Weighted mean; warns and returns 0.0 when no update has
        contributed (reference ``mean.py:63-71``)."""
        if not float(self.weighted_sum):
            _logger.warning("No calls to update() have been made - returning 0.0")
            return torch.tensor(0.0, device=self.device)
        return self.weighted_sum / self.weights

    def merge_state(self, metrics: Iterable["Mean"]) -> "Mean":
        merge_add(self, metrics, "weighted_sum", "weights")
        return self
