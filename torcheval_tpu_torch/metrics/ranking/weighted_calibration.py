"""WeightedCalibration metric (the port of
``torcheval_tpu/metrics/ranking/weighted_calibration.py``; parity with the
reference ``torcheval/metrics/ranking/weighted_calibration.py``).

States: per-task ``weighted_input_sum`` / ``weighted_target_sum``, f32
(reference ``:67-74``); merge: add (reference ``:117``)."""

from typing import Iterable, Union

import torch

from torcheval_tpu_torch.metrics._fuse import accumulate, on_device
from torcheval_tpu_torch.metrics._merge import merge_add
from torcheval_tpu_torch.metrics.functional._host_checks import x64_off
from torcheval_tpu_torch.metrics.functional.classification.binary_normalized_entropy import (
    _accum_dtype,
)
from torcheval_tpu_torch.metrics.functional.ranking.weighted_calibration import (
    _weighted_calibration_select_kernel,
)
from torcheval_tpu_torch.metrics.metric import Metric

_STATES = ("weighted_input_sum", "weighted_target_sum")


class WeightedCalibration(Metric[torch.Tensor]):
    def __init__(self, *, num_tasks: int = 1, device=None) -> None:
        super().__init__(device=device)
        if num_tasks < 1:
            raise ValueError(
                "`num_tasks` value should be greater than and equal to 1, "
                f"but received {num_tasks}. "
            )
        self.num_tasks = num_tasks
        for name in _STATES:
            self._add_state(name, torch.zeros(num_tasks, dtype=_accum_dtype()))

    def update(
        self, input, target, weight: Union[float, int, torch.Tensor] = 1.0
    ) -> "WeightedCalibration":
        input, target = x64_off(*on_device(self.device, input, target))
        kernel, args = _weighted_calibration_select_kernel(
            input, target, weight, num_tasks=self.num_tasks
        )
        self.weighted_input_sum, self.weighted_target_sum = accumulate(
            kernel, (self.weighted_input_sum, self.weighted_target_sum), *args
        )
        return self

    def compute(self) -> torch.Tensor:
        """Σw·input / Σw·target per task; NaN where no target weight has
        been seen (0/0)."""
        return self.weighted_input_sum / self.weighted_target_sum

    def merge_state(self, metrics: Iterable["WeightedCalibration"]):
        merge_add(self, metrics, *_STATES)
        return self
