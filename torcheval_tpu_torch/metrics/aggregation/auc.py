"""AUC metric (the port of ``torcheval_tpu/metrics/aggregation/auc.py``):
buffered (x, y) curve samples, trapezoid at compute.

Buffer states like the exact curve metrics: points accumulate across
updates (and across ranks through the concat merge) and the area is
integrated once over the full, optionally re-sorted, curve."""

from typing import Iterable

import torch

from torcheval_tpu_torch.metrics._buffer import merge_concat_buffers, prepare_concat_buffers
from torcheval_tpu_torch.metrics._fuse import on_device
from torcheval_tpu_torch.metrics.functional.aggregation.auc import (
    _auc_compute_kernel,
    _auc_input_check,
)
from torcheval_tpu_torch.metrics.metric import Metric


class AUC(Metric[torch.Tensor]):
    """Area under the curve sampled by all (x, y) updates so far."""

    def __init__(
        self, *, reorder: bool = True, num_tasks: int = 1, device=None
    ) -> None:
        super().__init__(device=device)
        if num_tasks < 1:
            raise ValueError(
                "`num_tasks` value should be greater than and equal to 1, "
                f"but received {num_tasks}. "
            )
        self.reorder = reorder
        self.num_tasks = num_tasks
        self._add_state("x", [])
        self._add_state("y", [])

    def update(self, x, y) -> "AUC":
        x, y = on_device(self.device, x, y)
        _auc_input_check(x, y, self.num_tasks)
        self.x.append(x)
        self.y.append(y)
        return self

    def compute(self) -> torch.Tensor:
        """Trapezoidal area per task; zeros before any update."""
        if not self.x:
            shape = () if self.num_tasks == 1 else (self.num_tasks,)
            return torch.zeros(shape, device=self.device)
        return _auc_compute_kernel(
            torch.cat(self.x, dim=-1),
            torch.cat(self.y, dim=-1),
            self.reorder,
        )

    def merge_state(self, metrics: Iterable["AUC"]) -> "AUC":
        merge_concat_buffers(self, metrics, "x", "y", dim=-1)
        return self

    def _prepare_for_merge_state(self) -> None:
        prepare_concat_buffers(self, "x", "y", dim=-1)
