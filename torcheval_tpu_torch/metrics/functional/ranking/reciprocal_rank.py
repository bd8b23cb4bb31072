"""Reciprocal rank (the port of
``torcheval_tpu/metrics/functional/ranking/reciprocal_rank.py``; parity
with the reference ``torcheval/metrics/functional/ranking/reciprocal_rank.py``)."""

from typing import Optional

import torch

from torcheval_tpu_torch.metrics.functional._host_checks import place_inputs
from torcheval_tpu_torch.metrics.functional.ranking.hit_rate import _target_rank


def reciprocal_rank(input, target, *, k: Optional[int] = None) -> torch.Tensor:
    """Per-sample f32 ``1 / (rank + 1)`` of the target class, zero past
    ``k`` (reference ``reciprocal_rank.py:41-47``)."""
    input, target = place_inputs(input, target)
    _reciprocal_rank_input_check(input, target)
    rank = _target_rank(input, target)
    score = 1.0 / (rank.to(torch.float32) + 1.0)
    if k is not None:
        score = torch.where(rank >= k, torch.zeros_like(score), score)
    return score


def _reciprocal_rank_input_check(input: torch.Tensor, target: torch.Tensor) -> None:
    if target.dim() != 1:
        raise ValueError(
            f"target should be a one-dimensional tensor, got shape {tuple(target.shape)}."
        )
    if input.dim() != 2:
        raise ValueError(
            f"input should be a two-dimensional tensor, got shape {tuple(input.shape)}."
        )
    if input.shape[0] != target.shape[0]:
        raise ValueError(
            "`input` and `target` should have the same minibatch dimension, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}, respectively."
        )
