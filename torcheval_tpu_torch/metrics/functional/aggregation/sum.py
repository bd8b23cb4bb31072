"""Weighted sum (the port of
``torcheval_tpu/metrics/functional/aggregation/sum.py``; parity with the
reference ``torcheval/metrics/functional/aggregation/sum.py``)."""

from typing import Union

import numpy as np
import torch

from torcheval_tpu_torch.metrics.functional._host_checks import place_inputs, x64_off


def sum(input, weight: Union[float, int, torch.Tensor] = 1.0) -> torch.Tensor:  # noqa: A001
    """Weighted sum of ``input``; scalar or same-size tensor ``weight``
    (reference ``sum.py:43-56``)."""
    (input,) = x64_off(*place_inputs(input))
    return _sum_update(input, weight)


def _sum_validate(input: torch.Tensor, weight) -> None:
    if isinstance(weight, (float, int)) or (
        isinstance(weight, (torch.Tensor, np.ndarray))
        and tuple(input.shape) == tuple(np.shape(weight))
    ):
        return
    raise ValueError(
        "Weight must be either a float value or an int value or a tensor "
        f"that matches the input tensor size. Got {weight} instead."
    )


def _sum_update(input: torch.Tensor, weight) -> torch.Tensor:
    _sum_validate(input, weight)
    return _weighted_sum(input, weight)


def _weighted_sum(input: torch.Tensor, weight) -> torch.Tensor:
    if isinstance(weight, np.ndarray):
        weight = torch.as_tensor(weight, device=input.device)
    (weight,) = x64_off(weight)
    return (input * weight).sum()
