"""PeakSignalNoiseRatio metric (the port of
``torcheval_tpu/metrics/image/psnr.py``).

States: summed squared error + element count (add merge) and the observed
target min/max (extremum merge, like Min/Max), read when ``data_range``
is unset."""

from typing import Iterable, Optional

import torch

from torcheval_tpu_torch.metrics._fuse import on_device
from torcheval_tpu_torch.metrics._merge import merge_add
from torcheval_tpu_torch.metrics.functional._host_checks import x64_off
from torcheval_tpu_torch.metrics.functional.image.psnr import (
    _psnr_compute,
    _psnr_input_check,
    _psnr_param_check,
    _psnr_sums,
)
from torcheval_tpu_torch.metrics.metric import Metric


class PeakSignalNoiseRatio(Metric[torch.Tensor]):
    """PSNR over everything seen; NaN before any update (0/0)."""

    def __init__(self, *, data_range: Optional[float] = None, device=None) -> None:
        super().__init__(device=device)
        _psnr_param_check(data_range)
        self.data_range = data_range
        self._add_state("sum_squared_error", torch.tensor(0.0))
        self._add_state("num_observations", torch.tensor(0.0))
        self._add_state("target_min", torch.tensor(float("inf")))
        self._add_state("target_max", torch.tensor(float("-inf")))
        if data_range is None:
            # Read by compute only without a data_range.
            self._extremum_states = ("target_min", "target_max")

    def update(self, input, target) -> "PeakSignalNoiseRatio":
        input, target = x64_off(*on_device(self.device, input, target))
        _psnr_input_check(input, target)
        sum_se, n = _psnr_sums(input, target)
        lo, hi = torch.aminmax(target)
        self.sum_squared_error = self.sum_squared_error + sum_se
        self.num_observations = self.num_observations + n
        self.target_min = torch.minimum(self.target_min, lo.to(torch.float32))
        self.target_max = torch.maximum(self.target_max, hi.to(torch.float32))
        return self

    def compute(self) -> torch.Tensor:
        data_range = (
            torch.tensor(float(self.data_range), device=self.device)
            if self.data_range is not None
            else self.target_max - self.target_min
        )
        return _psnr_compute(self.sum_squared_error, self.num_observations, data_range)

    def merge_state(self, metrics: Iterable["PeakSignalNoiseRatio"]) -> "PeakSignalNoiseRatio":
        metrics = list(metrics)
        merge_add(self, metrics, "sum_squared_error", "num_observations")
        for other in metrics:
            self.target_min = torch.minimum(self.target_min, other.target_min.to(self.device))
            self.target_max = torch.maximum(self.target_max, other.target_max.to(self.device))
        return self
