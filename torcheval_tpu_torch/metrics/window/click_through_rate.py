"""WindowedClickThroughRate (the port of
``torcheval_tpu/metrics/window/click_through_rate.py``): CTR over the last
``max_num_updates`` update calls, plus optional lifetime values.

All machinery (per-task ring columns, the pair update, ratio compute,
merge that grows the window) comes from
:class:`~torcheval_tpu_torch.metrics._buffer.WindowedLifetimeMixin`."""

from typing import Iterable, Tuple, Union

import torch

from torcheval_tpu_torch.metrics._buffer import WindowedLifetimeMixin
from torcheval_tpu_torch.metrics._fuse import on_device
from torcheval_tpu_torch.metrics.functional.aggregation.click_through_rate import (
    _ctr_input_check,
    _ctr_pick_kernel,
)
from torcheval_tpu_torch.metrics.functional.classification.binary_normalized_entropy import (
    _accum_dtype,
)
from torcheval_tpu_torch.metrics.metric import Metric


class WindowedClickThroughRate(
    WindowedLifetimeMixin, Metric[Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]]
):
    """Windowed (and optionally lifetime) click-through rate."""

    _window_states = ("windowed_click_total", "windowed_weight_total")
    _window_counters = ("total_updates",)
    _lifetime_states = ("click_total", "weight_total")
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
        self, input, weights: Union[float, int, torch.Tensor] = 1.0
    ) -> "WindowedClickThroughRate":
        (input,) = on_device(self.device, input)
        if not isinstance(weights, (float, int)):
            (weights,) = on_device(self.device, weights)
        self._split_update(input, weights)
        return self

    def _validate(self, input, weights: Union[float, int, torch.Tensor] = 1.0) -> None:
        _ctr_input_check(input, weights, num_tasks=self.num_tasks)

    def _update_body(
        self, start: torch.Tensor, input, weights: Union[float, int, torch.Tensor] = 1.0
    ) -> None:
        self._update_windowed_pair(start, *_ctr_pick_kernel(input, weights))

    def compute(self) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """``(lifetime, windowed)`` CTR when ``enable_lifetime`` else the
        windowed CTR; empty tensor(s) before any update."""
        return self._ratio_compute()

    def merge_state(
        self, metrics: Iterable["WindowedClickThroughRate"]
    ) -> "WindowedClickThroughRate":
        """Pack valid window columns into an enlarged window and add
        lifetime vectors (WindowedLifetimeMixin)."""
        return self._merge_windowed(metrics)
