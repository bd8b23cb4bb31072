"""WindowedMeanSquaredError (the port of
``torcheval_tpu/metrics/window/mean_squared_error.py``): MSE over the
last ``max_num_updates`` update calls, plus optional lifetime values.

Per-update sufficient statistics sit in ring columns with the
valid-prefix invariant of ``RingWindowMixin``; the row dimension is the
output dimension, sized on the first update the way ``MeanSquaredError``'s
per-output state grows on its first 2-D update.  Float64 inputs are cast
to float32 first, as the JAX package holds them with x64 off."""

from typing import Iterable, Tuple, Union

import torch

from torcheval_tpu_torch.metrics._buffer import WindowedLifetimeMixin
from torcheval_tpu_torch.metrics._fuse import on_device
from torcheval_tpu_torch.metrics.functional._host_checks import x64_off
from torcheval_tpu_torch.metrics.functional.regression.mean_squared_error import (
    _mean_squared_error_compute,
    _mean_squared_error_param_check,
    _mean_squared_error_update_input_check,
    _update_unweighted,
    _update_weighted,
)
from torcheval_tpu_torch.metrics.metric import Metric


class WindowedMeanSquaredError(
    WindowedLifetimeMixin, Metric[Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]]
):
    """Windowed (and optionally lifetime) mean squared error with
    ``uniform_average`` / ``raw_values`` multioutput."""

    _window_states = ("windowed_sum_squared_error", "windowed_sum_weight")
    _window_counters = ("total_updates", "_num_outputs")
    # sum_squared_error needs grow-aware addition, handled in merge_state;
    # only sum_weight rides the mixin's plain lifetime add.
    _lifetime_states = ("sum_weight",)

    def __init__(
        self,
        *,
        multioutput: str = "uniform_average",
        max_num_updates: int = 100,
        enable_lifetime: bool = True,
        device=None,
    ) -> None:
        super().__init__(device=device)
        _mean_squared_error_param_check(multioutput)
        if max_num_updates < 1:
            raise ValueError(
                "`max_num_updates` value should be greater than and equal to 1, "
                f"but received {max_num_updates}. "
            )
        self.multioutput = multioutput
        self.enable_lifetime = enable_lifetime
        self._init_window(max_num_updates)
        self.total_updates = 0
        # 0 = undecided, 1 with 1-D updates seen = scalar outputs, else the
        # output dimension of the 2-D updates.  Rides state_dict via
        # _window_counters.
        self._num_outputs = 0
        if enable_lifetime:
            self._add_state("sum_squared_error", torch.tensor(0.0))
            self._add_state("sum_weight", torch.tensor(0.0))
        self._add_state("windowed_sum_squared_error", torch.zeros((1, max_num_updates)))
        self._add_state("windowed_sum_weight", torch.zeros((1, max_num_updates)))

    def _ensure_rows(self, num_outputs: int) -> None:
        """Decide/verify the output dimension; grow the window's rows (and
        the lifetime state, like MeanSquaredError) on the first 2-D update."""
        if self._num_outputs == 0:
            self._num_outputs = num_outputs
            if num_outputs > 1:
                self.windowed_sum_squared_error = torch.zeros(
                    (num_outputs, self._window_capacity), device=self.device
                )
                if self.enable_lifetime:
                    self.sum_squared_error = torch.zeros(num_outputs, device=self.device)
        elif num_outputs != self._num_outputs:
            raise ValueError(
                "The number of outputs must stay fixed across updates, got "
                f"{num_outputs} after {self._num_outputs}."
            )

    def update(self, input, target, *, sample_weight=None) -> "WindowedMeanSquaredError":
        input, target, sample_weight = x64_off(
            *on_device(self.device, input, target, sample_weight)
        )
        _mean_squared_error_update_input_check(input, target, sample_weight)
        self._ensure_rows(1 if input.dim() == 1 else input.shape[1])
        if sample_weight is None:
            kernel, args = _update_unweighted, (input, target)
        else:
            kernel, args = _update_weighted, (input, target, sample_weight)
        self._update_windowed_pair(kernel, args, ("sum_squared_error", "sum_weight"))
        return self

    def _finalize(self, sse: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        if self._num_outputs <= 1:
            sse = torch.squeeze(sse)
        return _mean_squared_error_compute(sse, self.multioutput, weight)

    def compute(self) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """``(lifetime, windowed)`` MSE when ``enable_lifetime`` else the
        windowed MSE; empty tensor(s) before any update."""
        if self._num_valid == 0:
            empty = torch.zeros(0, device=self.device)
            return (empty, empty) if self.enable_lifetime else empty
        ncols = self._num_valid
        windowed = self._finalize(
            self.windowed_sum_squared_error[:, :ncols].sum(dim=1),
            self.windowed_sum_weight[0, :ncols].sum(),
        )
        if self.enable_lifetime:
            lifetime = _mean_squared_error_compute(
                self.sum_squared_error, self.multioutput, self.sum_weight
            )
            return lifetime, windowed
        return windowed

    def merge_state(
        self, metrics: Iterable["WindowedMeanSquaredError"]
    ) -> "WindowedMeanSquaredError":
        """Pack every metric's valid window columns into an enlarged window
        and add lifetime values."""
        metrics = list(metrics)
        for m in metrics:
            if m._num_outputs and self._num_outputs and m._num_outputs != self._num_outputs:
                raise ValueError(
                    "Merged metrics must have the same number of outputs; "
                    f"got {self._num_outputs} vs {m._num_outputs}."
                )
        # Adopt the output dimension of the first sized metric so an
        # un-updated recipient can absorb vector-output sources.
        for m in metrics:
            if self._num_outputs == 0 and m._num_outputs:
                self._ensure_rows(m._num_outputs)
        self._merge_windowed(metrics)
        if self.enable_lifetime:
            for m in metrics:
                # Grow-aware add (a scalar state absorbs a vector source),
                # like MeanSquaredError.merge_state.
                other = m.sum_squared_error.to(self.device)
                if self.sum_squared_error.dim() == 0 and other.dim() == 1:
                    self.sum_squared_error = other
                else:
                    self.sum_squared_error = self.sum_squared_error + other
        return self

    def reset(self) -> "WindowedMeanSquaredError":
        """Reset states AND the host-side window bookkeeping."""
        super().reset()
        self._num_outputs = 0
        return self
