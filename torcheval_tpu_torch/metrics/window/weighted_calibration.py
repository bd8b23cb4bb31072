"""WindowedWeightedCalibration (the port of
``torcheval_tpu/metrics/window/weighted_calibration.py``): weighted
calibration over the last ``max_num_updates`` update calls, plus optional
lifetime values.  Same shared machinery as ``WindowedClickThroughRate``
(WindowedLifetimeMixin); float64 inputs are cast to float32 first, as the
JAX package holds them with x64 off."""

from typing import Iterable, Tuple, Union

import torch

from torcheval_tpu_torch.metrics._buffer import WindowedLifetimeMixin
from torcheval_tpu_torch.metrics._fuse import on_device
from torcheval_tpu_torch.metrics.functional._host_checks import x64_off
from torcheval_tpu_torch.metrics.functional.classification.binary_normalized_entropy import (
    _accum_dtype,
)
from torcheval_tpu_torch.metrics.functional.ranking.weighted_calibration import (
    _wc_pick_kernel,
    _weighted_calibration_input_check,
)
from torcheval_tpu_torch.metrics.metric import Metric


class WindowedWeightedCalibration(
    WindowedLifetimeMixin, Metric[Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]]
):
    """Windowed (and optionally lifetime) weighted calibration
    Σw·input / Σw·target per task."""

    _window_states = ("windowed_weighted_input_sum", "windowed_weighted_target_sum")
    _window_counters = ("total_updates",)
    _lifetime_states = ("weighted_input_sum", "weighted_target_sum")
    # update() is _validate(), _update_body() at the cursor, then
    # _update_host() (Metric._graph_update, RingWindowMixin).
    _graph_update = True

    def __init__(
        self,
        *,
        num_tasks: int = 1,
        max_num_updates: int = 100,
        enable_lifetime: bool = True,
        device=None,
    ) -> None:
        super().__init__(device=device)
        self._init_task_window(num_tasks, max_num_updates, enable_lifetime, _accum_dtype())

    def update(
        self, input, target, weight: Union[float, int, torch.Tensor] = 1.0
    ) -> "WindowedWeightedCalibration":
        self._split_update(*on_device(self.device, input, target), weight)
        return self

    def _validate(self, input, target, weight: Union[float, int, torch.Tensor] = 1.0) -> None:
        _weighted_calibration_input_check(input, target, weight, num_tasks=self.num_tasks)

    def _update_body(
        self, start: torch.Tensor, input, target, weight: Union[float, int, torch.Tensor] = 1.0
    ) -> None:
        self._update_windowed_pair(start, *_wc_pick_kernel(*x64_off(input, target), weight))

    def compute(self) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """``(lifetime, windowed)`` calibration when ``enable_lifetime``
        else the windowed calibration; empty tensor(s) before any update."""
        return self._ratio_compute()

    def merge_state(
        self, metrics: Iterable["WindowedWeightedCalibration"]
    ) -> "WindowedWeightedCalibration":
        """Pack valid window columns into an enlarged window and add
        lifetime vectors (WindowedLifetimeMixin)."""
        return self._merge_windowed(metrics)
