"""Weighted calibration (the port of
``torcheval_tpu/metrics/functional/ranking/weighted_calibration.py``;
parity with the reference
``torcheval/metrics/functional/ranking/weighted_calibration.py``).

``Σ w·input / Σ w·target`` per task; the sufficient statistics are two
per-task sums, mergeable by addition.  Float64 inputs are cast to float32
first, as the JAX package holds them with x64 off."""

from typing import Tuple, Union

import numpy as np
import torch

from torcheval_tpu_torch.metrics.functional._host_checks import place_inputs, x64_off


def weighted_calibration(
    input,
    target,
    weight: Union[float, int, torch.Tensor] = 1.0,
    *,
    num_tasks: int = 1,
) -> torch.Tensor:
    """Weighted calibration Σw·input / Σw·target
    (reference ``weighted_calibration.py:13-59``)."""
    input, target = x64_off(*place_inputs(input, target))
    kernel, args = _weighted_calibration_select_kernel(input, target, weight, num_tasks=num_tasks)
    weighted_input_sum, weighted_target_sum = kernel(*args)
    return weighted_input_sum / weighted_target_sum


def _wc_scalar_kernel(
    input: torch.Tensor, target: torch.Tensor, weight: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    # The weight rounds to float32 first, as the JAX package's traced scalar.
    w = torch.full((), weight, dtype=torch.float32, device=input.device)
    return w * torch.sum(input, dim=-1), w * torch.sum(target, dim=-1)


def _wc_array_kernel(
    input: torch.Tensor, target: torch.Tensor, weight: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.sum(weight * input, dim=-1), torch.sum(weight * target, dim=-1)


def _weighted_calibration_select_kernel(
    input: torch.Tensor,
    target: torch.Tensor,
    weight: Union[float, int, torch.Tensor],
    *,
    num_tasks: int,
):
    """Validate and pick the matching kernel; returns ``(kernel, args)``
    so callers can call it directly or through ``accumulate``."""
    _weighted_calibration_input_check(input, target, weight, num_tasks=num_tasks)
    return _wc_pick_kernel(input, target, weight)


def _wc_pick_kernel(
    input: torch.Tensor, target: torch.Tensor, weight: Union[float, int, torch.Tensor]
):
    """The kernel for a checked ``weight``'s kind, and its arguments."""
    if isinstance(weight, (float, int)):
        return _wc_scalar_kernel, (input, target, float(weight))
    return _wc_array_kernel, (
        input, target, *x64_off(torch.as_tensor(weight, device=input.device)))


def _weighted_calibration_input_check(
    input: torch.Tensor,
    target: torch.Tensor,
    weight: Union[float, int, torch.Tensor],
    num_tasks: int,
) -> None:
    if input.shape != target.shape:
        raise ValueError(
            f"`input` shape ({tuple(input.shape)}) is different from `target` shape "
            f"({tuple(target.shape)})"
        )
    if num_tasks == 1:
        if input.dim() > 1:
            raise ValueError(
                "`num_tasks = 1`, `input` is expected to be one-dimensional "
                f"tensor, but got shape ({tuple(input.shape)})."
            )
    elif input.dim() == 1 or input.shape[0] != num_tasks:
        raise ValueError(
            f"`num_tasks = {num_tasks}`, `input`'s shape is expected to be "
            f"({num_tasks}, num_samples), but got shape ({tuple(input.shape)})."
        )
    if not isinstance(weight, (float, int)) and not (
        isinstance(weight, (torch.Tensor, np.ndarray))
        and tuple(input.shape) == tuple(np.shape(weight))
    ):
        raise ValueError(
            "Weight must be either a float value or a tensor that matches the "
            f"input tensor size. Got {weight} instead."
        )
