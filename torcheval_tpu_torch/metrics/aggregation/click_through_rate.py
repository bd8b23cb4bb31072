"""ClickThroughRate metric (the port of
``torcheval_tpu/metrics/aggregation/click_through_rate.py``): two per-task
sums that merge by addition."""

from typing import Iterable, Union

import torch

from torcheval_tpu_torch.metrics._fuse import accumulate, on_device
from torcheval_tpu_torch.metrics._merge import merge_add
from torcheval_tpu_torch.metrics.functional.aggregation.click_through_rate import (
    _ctr_input_check,
    _ctr_pick_kernel,
)
from torcheval_tpu_torch.metrics.functional.classification.binary_normalized_entropy import (
    _accum_dtype,
)
from torcheval_tpu_torch.metrics.metric import Metric


class ClickThroughRate(Metric[torch.Tensor]):
    """Weighted click fraction Σw·click / Σw per task; NaN before any
    weighted update (0/0)."""

    # update() is _validate() then _update_body() (Metric._graph_update).
    _graph_update = True

    def __init__(self, *, num_tasks: int = 1, device=None) -> None:
        super().__init__(device=device)
        if num_tasks < 1:
            raise ValueError(
                "`num_tasks` value should be greater than and equal to 1, "
                f"but received {num_tasks}. "
            )
        self.num_tasks = num_tasks
        self._add_state("click_total", torch.zeros(num_tasks, dtype=_accum_dtype()))
        self._add_state("weight_total", torch.zeros(num_tasks, dtype=_accum_dtype()))

    def update(
        self, input, weights: Union[float, int, torch.Tensor] = 1.0
    ) -> "ClickThroughRate":
        (input,) = on_device(self.device, input)
        if not isinstance(weights, (float, int)):
            (weights,) = on_device(self.device, weights)
        self._validate(input, weights)
        self._update_body(input, weights)
        return self

    def _validate(self, input, weights: Union[float, int, torch.Tensor] = 1.0) -> None:
        _ctr_input_check(input, weights, num_tasks=self.num_tasks)

    def _update_body(self, input, weights: Union[float, int, torch.Tensor] = 1.0) -> None:
        kernel, args = _ctr_pick_kernel(input, weights)
        self.click_total, self.weight_total = accumulate(
            kernel, (self.click_total, self.weight_total), *args
        )

    def compute(self) -> torch.Tensor:
        """CTR per task (scalar when ``num_tasks == 1``)."""
        ctr = self.click_total / self.weight_total
        return ctr[0] if self.num_tasks == 1 else ctr

    def merge_state(self, metrics: Iterable["ClickThroughRate"]):
        merge_add(self, metrics, "click_total", "weight_total")
        return self
