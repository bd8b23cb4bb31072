"""Cat metric (the port of ``torcheval_tpu/metrics/aggregation/cat.py``;
parity with the reference ``torcheval/metrics/aggregation/cat.py``).
Buffer state: a list of tensors concatenated along ``dim`` at compute;
``_prepare_for_merge_state`` pre-concatenates so a sync carries one
buffer (reference ``cat.py:93-96``)."""

from typing import Iterable

import torch

from torcheval_tpu_torch.metrics._buffer import merge_concat_buffers, prepare_concat_buffers
from torcheval_tpu_torch.metrics._fuse import on_device
from torcheval_tpu_torch.metrics.functional._host_checks import x64_off
from torcheval_tpu_torch.metrics.metric import Metric


class Cat(Metric[torch.Tensor]):
    """Concatenate all input tensors.  The functional version is
    ``torch.cat`` (reference ``cat.py:21-22``)."""

    def __init__(self, *, dim: int = 0, device=None) -> None:
        super().__init__(device=device)
        self.dim = dim
        self._add_state("inputs", [])

    def update(self, input) -> "Cat":
        (input,) = x64_off(*on_device(self.device, input))
        self.inputs.append(input)
        return self

    def compute(self) -> torch.Tensor:
        """Concatenated inputs; an empty tensor when no update has been
        made (reference ``cat.py:77-82``)."""
        if not self.inputs:
            return torch.zeros(0, device=self.device)
        return torch.cat(self.inputs, dim=self.dim)

    def merge_state(self, metrics: Iterable["Cat"]) -> "Cat":
        for metric in metrics:
            merge_concat_buffers(self, [metric], "inputs", dim=metric.dim)
        return self

    def _prepare_for_merge_state(self) -> None:
        prepare_concat_buffers(self, "inputs", dim=self.dim)
