"""Click-through rate: the weighted click fraction Σw·click / Σw per task
(the port of
``torcheval_tpu/metrics/functional/aggregation/click_through_rate.py``).
Two sums that merge by addition."""

from typing import Tuple, Union

import numpy as np
import torch

from torcheval_tpu_torch.metrics.functional._host_checks import (
    place_inputs,
    value_check,
    value_checks_enabled,
)
from torcheval_tpu_torch.telemetry import events as _telemetry


def click_through_rate(
    input,
    weights: Union[float, int, torch.Tensor] = 1.0,
    *,
    num_tasks: int = 1,
) -> torch.Tensor:
    """CTR per task over 0/1 click events; ``weights`` is a scalar or a
    per-event tensor of impression weights."""
    if isinstance(weights, (float, int)):
        (input,) = place_inputs(input)
    else:
        input, weights = place_inputs(input, weights)
    kernel, args = _ctr_select_kernel(input, weights, num_tasks=num_tasks)
    click_total, weight_total = kernel(*args)
    return click_total / weight_total


def _ctr_scalar_kernel(
    input: torch.Tensor, weights
) -> Tuple[torch.Tensor, torch.Tensor]:
    n = input.shape[-1]
    return weights * torch.sum(input, dim=-1), weights * torch.full(
        input.shape[:-1], n, dtype=input.dtype, device=input.device
    )


def _ctr_array_kernel(
    input: torch.Tensor, weights: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.sum(weights * input, dim=-1), torch.sum(
        torch.broadcast_to(weights, input.shape), dim=-1
    )


def _ctr_select_kernel(
    input: torch.Tensor,
    weights: Union[float, int, torch.Tensor],
    *,
    num_tasks: int,
):
    """Validate and pick the matching kernel; returns ``(kernel, args)``
    so callers can call it directly or through ``accumulate``."""
    _ctr_input_check(input, weights, num_tasks=num_tasks)
    return _ctr_pick_kernel(input, weights)


def _ctr_pick_kernel(input: torch.Tensor, weights: Union[float, int, torch.Tensor]):
    """The kernel for ``weights``' kind, and its arguments."""
    if isinstance(weights, (float, int)):
        return _ctr_scalar_kernel, (input, float(weights))
    weights = torch.as_tensor(weights, device=input.device)
    if weights.dim() == 0:  # scalar tensor: same path as a Python float
        return _ctr_scalar_kernel, (input, weights)
    return _ctr_array_kernel, (input, weights)


def _ctr_input_check(
    input: torch.Tensor,
    weights: Union[float, int, torch.Tensor],
    *,
    num_tasks: int,
) -> None:
    if num_tasks == 1:
        if input.dim() != 1:
            raise ValueError(
                "`input` should be a one-dimensional tensor for num_tasks = 1, "
                f"got shape {tuple(input.shape)}."
            )
    elif input.dim() != 2 or input.shape[0] != num_tasks:
        raise ValueError(
            f"`input` should have shape ({num_tasks}, num_samples) for "
            f"num_tasks = {num_tasks}, got shape {tuple(input.shape)}."
        )
    if not isinstance(weights, (float, int)):
        wshape = tuple(np.shape(weights))
        shape = tuple(input.shape)
        if wshape not in ((), shape, shape[-1:]):
            raise ValueError(
                "`weights` must be a float, or a tensor broadcastable to the "
                f"input shape {shape}, got shape {wshape}."
            )
    # Click events must be 0/1: a data-dependent check (one read back),
    # skipped like every value check (_host_checks.py).
    if input.numel() and value_checks_enabled():
        if _telemetry.ANNOTATE:
            with _telemetry.span("check.click_through_rate"):
                return _check_binary(input)
        _check_binary(input)


def _check_binary(input: torch.Tensor) -> None:
    value_check("click_through_rate", _judge_binary, flag=torch.all((input == 0) | (input == 1)))


def _judge_binary(binary: bool) -> None:
    if not binary:
        raise ValueError("`input` should be a binary tensor of 0/1 click events.")
