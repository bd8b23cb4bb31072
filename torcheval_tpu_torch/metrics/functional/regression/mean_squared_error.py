"""Mean squared error (the port of
``torcheval_tpu/metrics/functional/regression/mean_squared_error.py``;
parity with the reference
``torcheval/metrics/functional/regression/mean_squared_error.py``).

Sufficient statistics: weighted sums of squared error and of weight, one
reduction a batch.  Float64 inputs are cast to float32 first, as the JAX
package holds them with x64 off."""

from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.metrics.functional._host_checks import place_inputs, x64_off


def mean_squared_error(
    input,
    target,
    *,
    sample_weight=None,
    multioutput: str = "uniform_average",
) -> torch.Tensor:
    """Weighted MSE with ``uniform_average`` / ``raw_values`` multioutput
    (reference ``mean_squared_error.py:7-66``)."""
    _mean_squared_error_param_check(multioutput)
    if sample_weight is None:
        input, target = x64_off(*place_inputs(input, target))
    else:
        input, target, sample_weight = x64_off(*place_inputs(input, target, sample_weight))
    sum_squared_error, sum_weight = _mean_squared_error_update(input, target, sample_weight)
    return _mean_squared_error_compute(sum_squared_error, multioutput, sum_weight)


def _mean_squared_error_update(
    input: torch.Tensor,
    target: torch.Tensor,
    sample_weight: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    _mean_squared_error_update_input_check(input, target, sample_weight)
    if sample_weight is None:
        return _update_unweighted(input, target)
    return _update_weighted(input, target, sample_weight)


def _update_unweighted(
    input: torch.Tensor, target: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    squared_error = torch.square(target - input)
    return squared_error.sum(dim=0), torch.full((), target.shape[0], device=target.device)


def _update_weighted(
    input: torch.Tensor, target: torch.Tensor, sample_weight: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    squared_error = torch.square(target - input)
    weight = sample_weight[:, None] if squared_error.dim() == 2 else sample_weight
    return (squared_error * weight).sum(dim=0), torch.squeeze(weight.sum(dim=0))


def _mean_squared_error_compute(
    sum_squared_error: torch.Tensor,
    multioutput: str,
    sum_weight: torch.Tensor,
) -> torch.Tensor:
    raw = sum_squared_error / sum_weight
    return raw if multioutput == "raw_values" else raw.mean()


def _mean_squared_error_update_input_check(
    input: torch.Tensor,
    target: torch.Tensor,
    sample_weight: Optional[torch.Tensor],
) -> None:
    if input.dim() >= 3 or target.dim() >= 3:
        raise ValueError(
            "The dimension `input` and `target` should be 1D or 2D, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same size, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if sample_weight is not None and target.shape[0] != sample_weight.shape[0]:
        raise ValueError(
            "The first dimension of `input`, `target` and `sample_weight` "
            f"should be the same size, got shapes {tuple(input.shape)}, "
            f"{tuple(target.shape)} and {tuple(sample_weight.shape)}."
        )


def _mean_squared_error_param_check(multioutput: str) -> None:
    if multioutput not in ("raw_values", "uniform_average"):
        raise ValueError(
            "The `multioutput` must be either `raw_values` or `uniform_average`, "
            f"got multioutput={multioutput}."
        )
