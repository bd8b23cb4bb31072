"""R2Score metric (the port of ``torcheval_tpu/metrics/regression/r2_score.py``;
parity with the reference ``torcheval/metrics/regression/r2_score.py``).

States: ``sum_squared_obs`` / ``sum_obs`` / ``sum_squared_residual`` /
``num_obs`` (streaming TSS / RSS), f32; the per-output states grow from
scalars to vectors on the first 2-D update; merge: add."""

from typing import Iterable

import torch

from torcheval_tpu_torch.metrics._fuse import accumulate, on_device
from torcheval_tpu_torch.metrics.functional._host_checks import x64_off
from torcheval_tpu_torch.metrics.functional.regression.r2_score import (
    _r2_score_compute,
    _r2_score_param_check,
    _r2_score_update_input_check,
    _update as _r2_update_kernel,
)
from torcheval_tpu_torch.metrics.metric import Metric

_GROWABLE = ("sum_squared_obs", "sum_obs", "sum_squared_residual")


class R2Score(Metric[torch.Tensor]):
    def __init__(
        self, *, multioutput: str = "uniform_average", num_regressors: int = 0, device=None
    ) -> None:
        super().__init__(device=device)
        _r2_score_param_check(multioutput, num_regressors)
        self.multioutput = multioutput
        self.num_regressors = num_regressors
        for name in (*_GROWABLE, "num_obs"):
            self._add_state(name, torch.tensor(0.0))

    def update(self, input, target) -> "R2Score":
        input, target = x64_off(*on_device(self.device, input, target))
        _r2_score_update_input_check(input, target)
        # num_obs stays a scalar, so it always adds.
        (
            self.sum_squared_obs,
            self.sum_obs,
            self.sum_squared_residual,
            self.num_obs,
        ) = accumulate(
            _r2_update_kernel,
            (self.sum_squared_obs, self.sum_obs, self.sum_squared_residual, self.num_obs),
            input,
            target,
            grow=True,
        )
        return self

    def compute(self) -> torch.Tensor:
        """R²; raises before enough data (n < 2), as the reference does
        (``r2_score.py:117-125``)."""
        return _r2_score_compute(
            self.sum_squared_obs,
            self.sum_obs,
            self.sum_squared_residual,
            self.num_obs,
            self.multioutput,
            self.num_regressors,
        )

    def merge_state(self, metrics: Iterable["R2Score"]) -> "R2Score":
        for metric in metrics:
            grow = self.sum_squared_obs.dim() == 0 and metric.sum_squared_obs.dim() == 1
            for name in _GROWABLE:
                other = getattr(metric, name).to(self.device)
                setattr(self, name, other if grow else getattr(self, name) + other)
            self.num_obs = self.num_obs + metric.num_obs.to(self.device)
        return self
