"""Hit rate (the port of ``torcheval_tpu/metrics/functional/ranking/hit_rate.py``;
parity with the reference ``torcheval/metrics/functional/ranking/hit_rate.py``)."""

from typing import Optional

import torch

from torcheval_tpu_torch.metrics.functional._host_checks import place_inputs


def hit_rate(input, target, *, k: Optional[int] = None) -> torch.Tensor:
    """Per-sample f32 hit indicator of the target class among the top-k
    predictions; rank = #(scores strictly above the target's score)
    (reference ``hit_rate.py:40-46``)."""
    input, target = place_inputs(input, target)
    _hit_rate_input_check(input, target, k)
    if k is None or k >= input.shape[-1]:
        return torch.ones(target.shape, dtype=torch.float32, device=target.device)
    return (_target_rank(input, target) < k).to(torch.float32)


def _target_rank(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """#(scores strictly above the target's score), per sample."""
    y_score = torch.take_along_dim(input, target.to(torch.int64)[:, None], dim=-1)
    return torch.sum(input > y_score, dim=-1)


def _hit_rate_input_check(
    input: torch.Tensor, target: torch.Tensor, k: Optional[int] = None
) -> None:
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
    if k is not None and k <= 0:
        raise ValueError(f"k should be None or positive, got {k}.")
