"""WindowedBinaryNormalizedEntropy (the port of
``torcheval_tpu/metrics/window/normalized_entropy.py``; parity with the
reference ``torcheval/metrics/window/normalized_entropy.py``).

NE over the last ``max_num_updates`` *update calls* (the window counts
updates, not samples, reference ``window/normalized_entropy.py:27``), plus
optional lifetime values.  State: per-update windowed sufficient
statistics ``(num_tasks, max_num_updates)`` x3 and, when
``enable_lifetime``, lifetime vectors x3 (float64 in the reference; see
the accumulator dtype note in the functional NE module).

Divergences (documented, both in favor of correctness, as in the JAX
package): merge updates ``max_num_updates`` to the enlarged size (the
reference forgets to, ``window/normalized_entropy.py:245-295``), and
``reset()`` also restores the capacity and zeroes the host counters.
"""

from typing import Iterable, Tuple, Union

import torch

from torcheval_tpu_torch.metrics._buffer import WindowedLifetimeMixin
from torcheval_tpu_torch.metrics._fuse import on_device
from torcheval_tpu_torch.metrics.functional.classification.binary_normalized_entropy import (
    _accum_dtype,
    _baseline_update,
    _ne_input_check,
    _ne_update_kernel,
    _ne_update_kernel_unweighted,
)
from torcheval_tpu_torch.metrics.metric import Metric

_LIFETIME_STATES = ("total_entropy", "num_examples", "num_positive")


class WindowedBinaryNormalizedEntropy(
    WindowedLifetimeMixin, Metric[Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]]
):
    """Windowed (and optionally lifetime) normalized binary cross entropy
    (reference ``window/normalized_entropy.py:22-77``)."""

    _window_states = (
        "windowed_total_entropy",
        "windowed_num_examples",
        "windowed_num_positive",
    )
    _window_counters = ("total_updates",)
    _lifetime_states = _LIFETIME_STATES

    def __init__(
        self,
        *,
        from_logits: bool = False,
        num_tasks: int = 1,
        max_num_updates: int = 100,
        enable_lifetime: bool = True,
        device=None,
    ) -> None:
        super().__init__(device=device)
        self.from_logits = from_logits
        self._init_task_window(num_tasks, max_num_updates, enable_lifetime, _accum_dtype())

    def update(self, input, target, *, weight=None) -> "WindowedBinaryNormalizedEntropy":
        """Write this update's sufficient statistics into the next window
        column (reference ``window/normalized_entropy.py:146-179``)."""
        input, target, weight = on_device(self.device, input, target, weight)
        _ne_input_check(input, target, self.from_logits, self.num_tasks, weight)
        if weight is not None:
            ce, npos, nex = _ne_update_kernel(input, target, weight, self.from_logits)
        else:
            ce, npos, nex = _ne_update_kernel_unweighted(input, target, self.from_logits)
        col = self.next_inserted
        self.windowed_total_entropy[:, col] = ce
        self.windowed_num_examples[:, col] = nex
        self.windowed_num_positive[:, col] = npos
        if self.enable_lifetime:
            self.total_entropy = self.total_entropy + ce
            self.num_examples = self.num_examples + nex
            self.num_positive = self.num_positive + npos
        self._window_advance(1)
        self.total_updates += 1
        return self

    def compute(self) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """``(lifetime, windowed)`` NE when ``enable_lifetime`` else the
        windowed NE; empty tensor(s) before any update
        (reference ``window/normalized_entropy.py:181-230``)."""
        if self._num_valid == 0:
            empty = torch.zeros(0, device=self.device)
            return (empty, empty) if self.enable_lifetime else empty
        ncols = self._num_valid
        w_entropy = self.windowed_total_entropy[:, :ncols].sum(dim=1)
        w_examples = self.windowed_num_examples[:, :ncols].sum(dim=1)
        w_positive = self.windowed_num_positive[:, :ncols].sum(dim=1)
        windowed_ne = (w_entropy / w_examples) / _baseline_update(w_positive, w_examples)
        if self.enable_lifetime:
            lifetime_ne = (self.total_entropy / self.num_examples) / _baseline_update(
                self.num_positive, self.num_examples
            )
            return lifetime_ne, windowed_ne
        return windowed_ne

    def merge_state(
        self, metrics: Iterable["WindowedBinaryNormalizedEntropy"]
    ) -> "WindowedBinaryNormalizedEntropy":
        """Pack every metric's valid window columns into an enlarged window
        (size = sum of window sizes) and add lifetime vectors
        (reference ``window/normalized_entropy.py:232-296``;
        WindowedLifetimeMixin)."""
        return self._merge_windowed(metrics)
