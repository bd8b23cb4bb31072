"""The per-sample score buffer shared by the ranking classes: each update
appends a functional's scores, compute concatenates them, and a merge
concatenates the buffers (``_buffer.py``)."""

from typing import Iterable

import torch

from torcheval_tpu_torch.metrics._buffer import merge_concat_buffers, prepare_concat_buffers
from torcheval_tpu_torch.metrics.metric import Metric


class ScoreBuffer(Metric[torch.Tensor]):
    def __init__(self, device=None) -> None:
        super().__init__(device=device)
        self._add_state("scores", [])

    def compute(self) -> torch.Tensor:
        """The concatenated scores; an empty tensor before any update."""
        if not self.scores:
            return torch.zeros(0, device=self.device)
        return torch.cat(self.scores, dim=0)

    def merge_state(self, metrics: Iterable["ScoreBuffer"]):
        merge_concat_buffers(self, metrics, "scores", dim=0)
        return self

    def _prepare_for_merge_state(self) -> None:
        prepare_concat_buffers(self, "scores", dim=0)
