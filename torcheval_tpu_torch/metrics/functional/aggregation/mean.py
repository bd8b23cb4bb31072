"""Weighted mean (the port of
``torcheval_tpu/metrics/functional/aggregation/mean.py``; parity with the
reference ``torcheval/metrics/functional/aggregation/mean.py``)."""

from typing import Tuple, Union

import numpy as np
import torch

from torcheval_tpu_torch.metrics.functional._host_checks import place_inputs, x64_off


def mean(input, weight: Union[float, int, torch.Tensor] = 1.0) -> torch.Tensor:
    """``sum(weight * input) / sum(weight)`` (reference ``mean.py:44-58``)."""
    (input,) = x64_off(*place_inputs(input))
    weighted_sum, weights = _mean_update(input, weight)
    return weighted_sum / weights


def _mean_select_kernel(input: torch.Tensor, weight):
    """Validate ``weight`` and pick the matching kernel; returns
    ``(kernel, args)`` so callers can call it directly or through
    ``accumulate``."""
    if isinstance(weight, (float, int)):
        return _scalar_weighted, (input, float(weight))
    if isinstance(weight, (torch.Tensor, np.ndarray)) and tuple(input.shape) == tuple(
        np.shape(weight)
    ):
        return _array_weighted, (input, *x64_off(torch.as_tensor(weight, device=input.device)))
    raise ValueError(
        "Weight must be either a float value or a tensor that matches the "
        f"input tensor size. Got {weight} instead."
    )


def _mean_update(input: torch.Tensor, weight) -> Tuple[torch.Tensor, torch.Tensor]:
    kernel, args = _mean_select_kernel(input, weight)
    return kernel(*args)


def _scalar_weighted(input: torch.Tensor, weight: float) -> Tuple[torch.Tensor, torch.Tensor]:
    # The weight rounds to float32 before it multiplies the count, as the
    # JAX package's traced scalar does.
    w = torch.full((), weight, dtype=torch.float32, device=input.device)
    return w * torch.sum(input), w * input.numel()


def _array_weighted(
    input: torch.Tensor, weight: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.sum(weight * input), torch.sum(weight)
