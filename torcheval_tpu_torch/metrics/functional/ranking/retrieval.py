"""Retrieval precision / recall at k (the port of
``torcheval_tpu/metrics/functional/ranking/retrieval.py``).

One call scores one query's candidate list (or ``num_tasks`` of them
through a leading dim):

    precision@k = relevant-in-top-k / k_eff
    recall@k    = relevant-in-top-k / total-relevant

``k=None`` uses every candidate; ``limit_k_to_size`` clamps ``k`` to the
candidate count.  The top k is taken by a stable descending sort, so tied
scores keep the lower index first, as ``lax.top_k`` does."""

from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.metrics.functional._host_checks import (
    place_inputs,
    value_checks_enabled,
)


def retrieval_precision(
    input,
    target,
    k: Optional[int] = None,
    *,
    limit_k_to_size: bool = False,
    num_tasks: int = 1,
) -> torch.Tensor:
    """Fraction of the top-``k`` scored candidates that are relevant."""
    input, target, k_eff, k_sel = _retrieval_prepare(input, target, k, limit_k_to_size, num_tasks)
    out = _topk_hits(input, target, k_sel) / k_eff
    return out[0] if num_tasks == 1 else out


def retrieval_recall(
    input,
    target,
    k: Optional[int] = None,
    *,
    limit_k_to_size: bool = False,
    num_tasks: int = 1,
) -> torch.Tensor:
    """Fraction of all relevant candidates found in the top ``k``."""
    input, target, _, k_sel = _retrieval_prepare(input, target, k, limit_k_to_size, num_tasks)
    out = _topk_hits(input, target, k_sel) / (target == 1).sum(dim=-1)
    return out[0] if num_tasks == 1 else out


def _retrieval_prepare(
    input, target, k: Optional[int], limit_k_to_size: bool, num_tasks: int
) -> Tuple[torch.Tensor, torch.Tensor, int, int]:
    """Validate, lift to ``(num_tasks, n)``, and resolve the effective k
    (the precision denominator) and the selection k (``<= n``)."""
    _retrieval_param_check(k, limit_k_to_size)
    input, target = place_inputs(input, target)
    _retrieval_input_check(input, target, num_tasks)
    if input.dim() == 1:
        input, target = input[None], target[None]
    n = input.shape[-1]
    k_eff = n if k is None else (min(k, n) if limit_k_to_size else k)
    return input, target, k_eff, min(k_eff, n)


def _topk_hits(input: torch.Tensor, target: torch.Tensor, k_sel: int) -> torch.Tensor:
    """Relevant count among each row's top ``k_sel`` scored candidates."""
    idx = torch.sort(input, dim=-1, descending=True, stable=True).indices[..., :k_sel]
    return torch.take_along_dim(target, idx, dim=-1).sum(dim=-1)


def _retrieval_param_check(k: Optional[int], limit_k_to_size: bool) -> None:
    if k is not None and k < 1:
        raise ValueError(f"`k` should be a positive integer, got k={k}.")
    if limit_k_to_size and k is None:
        raise ValueError("when `limit_k_to_size` is True, `k` must not be None.")


def _retrieval_input_check(input: torch.Tensor, target: torch.Tensor, num_tasks: int) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same shape, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if num_tasks == 1:
        if input.dim() != 1:
            raise ValueError(
                "`input` should be a one-dimensional tensor for num_tasks = 1, "
                f"got shape {tuple(input.shape)}."
            )
    elif input.dim() != 2 or input.shape[0] != num_tasks:
        raise ValueError(
            f"`input` should have shape ({num_tasks}, num_candidates) for "
            f"num_tasks = {num_tasks}, got shape {tuple(input.shape)}."
        )
    # Relevance must be 0/1: graded targets would inflate the top-k hit sum
    # against the exact-1 relevant count.  One read back.
    if target.numel() and value_checks_enabled():
        if not bool(torch.all((target == 0) | (target == 1))):
            raise ValueError("`target` should be a binary tensor of 0/1 relevance labels.")
