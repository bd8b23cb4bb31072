"""MeanSquaredError metric (the port of
``torcheval_tpu/metrics/regression/mean_squared_error.py``; parity with
the reference ``torcheval/metrics/regression/mean_squared_error.py``).

States: ``sum_squared_error`` + ``sum_weight``, f32; the per-output state
grows from a scalar to a vector on the first 2-D update (reference
behaviour); merge: add."""

from typing import Iterable

import torch

from torcheval_tpu_torch.metrics._fuse import accumulate, on_device
from torcheval_tpu_torch.metrics.functional._host_checks import x64_off
from torcheval_tpu_torch.metrics.functional.regression.mean_squared_error import (
    _mean_squared_error_compute,
    _mean_squared_error_param_check,
    _mean_squared_error_update_input_check,
    _update_unweighted,
    _update_weighted,
)
from torcheval_tpu_torch.metrics.metric import Metric


class MeanSquaredError(Metric[torch.Tensor]):
    def __init__(self, *, multioutput: str = "uniform_average", device=None) -> None:
        super().__init__(device=device)
        _mean_squared_error_param_check(multioutput)
        self.multioutput = multioutput
        self._add_state("sum_squared_error", torch.tensor(0.0))
        self._add_state("sum_weight", torch.tensor(0.0))

    def update(self, input, target, *, sample_weight=None) -> "MeanSquaredError":
        input, target, sample_weight = x64_off(
            *on_device(self.device, input, target, sample_weight)
        )
        _mean_squared_error_update_input_check(input, target, sample_weight)
        if sample_weight is None:
            kernel, args = _update_unweighted, (input, target)
        else:
            kernel, args = _update_weighted, (input, target, sample_weight)
        self.sum_squared_error, self.sum_weight = accumulate(
            kernel, (self.sum_squared_error, self.sum_weight), *args, grow=True
        )
        return self

    def compute(self) -> torch.Tensor:
        """MSE; NaN before any update (0/0)."""
        return _mean_squared_error_compute(
            self.sum_squared_error, self.multioutput, self.sum_weight
        )

    def merge_state(self, metrics: Iterable["MeanSquaredError"]) -> "MeanSquaredError":
        for metric in metrics:
            other = metric.sum_squared_error.to(self.device)
            if self.sum_squared_error.dim() == 0 and other.dim() == 1:
                self.sum_squared_error = other
            else:
                self.sum_squared_error = self.sum_squared_error + other
            self.sum_weight = self.sum_weight + metric.sum_weight.to(self.device)
        return self
