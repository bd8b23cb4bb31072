"""Shared helpers for sample-buffer metrics (AUROC in this slice).

Buffer states are Python lists of tensors; all math is deferred to
``compute()``, where one concatenation feeds the kernels.  Merge
concatenates; ``_prepare_for_merge_state`` pre-concatenates each buffer so
a sync ships a single tensor per state (reference
``classification/auroc.py:130-134``)."""

from typing import Iterable

import torch

from torcheval_tpu_torch.metrics.metric import Metric


def merge_concat_buffers(
    metric: Metric, metrics: Iterable[Metric], *state_names: str, dim: int = -1
) -> None:
    """Append each source metric's concatenated buffer (reference merge
    semantics: one pre-concatenated tensor per source,
    ``classification/auroc.py:121-128``)."""
    for other in metrics:
        if getattr(other, state_names[0]):
            for name in state_names:
                buf = getattr(other, name)
                getattr(metric, name).append(
                    torch.cat(buf, dim=dim).to(metric.device)
                )


def prepare_concat_buffers(metric: Metric, *state_names: str, dim: int = -1) -> None:
    for name in state_names:
        buf = getattr(metric, name)
        if buf:
            setattr(metric, name, [torch.cat(buf, dim=dim)])
