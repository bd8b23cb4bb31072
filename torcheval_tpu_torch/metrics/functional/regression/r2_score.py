"""R² score (the port of
``torcheval_tpu/metrics/functional/regression/r2_score.py``; parity with
the reference ``torcheval/metrics/functional/regression/r2_score.py``).

Streaming sufficient statistics, mergeable by addition:
``tss = Σy² − (Σy)²/n``, ``r² = 1 − rss/tss``; ``raw_values`` /
``uniform_average`` / ``variance_weighted`` multioutput and adjusted R²
through ``num_regressors``.  The size guards (n ≥ 2, num_regressors <
n − 1) read the sample count on the host.  Float64 inputs are cast to
float32 first, as the JAX package holds them with x64 off."""

from typing import Tuple

import torch

from torcheval_tpu_torch.metrics.functional._host_checks import place_inputs, x64_off


def r2_score(
    input,
    target,
    *,
    multioutput: str = "uniform_average",
    num_regressors: int = 0,
) -> torch.Tensor:
    """R² (coefficient of determination), optionally adjusted
    (reference ``r2_score.py:~20-80``)."""
    _r2_score_param_check(multioutput, num_regressors)
    input, target = x64_off(*place_inputs(input, target))
    _r2_score_update_input_check(input, target)
    _r2_score_size_check(target.shape[0] if target.dim() else 0, num_regressors)
    sum_squared_obs, sum_obs, sum_squared_residual, num_obs = _update(input, target)
    return _compute(
        sum_squared_obs, sum_obs, sum_squared_residual, num_obs, multioutput, num_regressors
    )


def _r2_score_update(
    input: torch.Tensor, target: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    _r2_score_update_input_check(input, target)
    return _update(input, target)


def _update(
    input: torch.Tensor, target: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    sum_squared_obs = torch.sum(torch.square(target), dim=0)
    sum_obs = torch.sum(target, dim=0)
    sum_squared_residual = torch.sum(torch.square(target - input), dim=0)
    num_obs = torch.full((), target.shape[0], device=target.device)
    return sum_squared_obs, sum_obs, sum_squared_residual, num_obs


def _r2_score_compute(
    sum_squared_obs: torch.Tensor,
    sum_obs: torch.Tensor,
    rss: torch.Tensor,
    num_obs: torch.Tensor,
    multioutput: str,
    num_regressors: int,
) -> torch.Tensor:
    """The class path's compute: the size guards on the accumulated count
    (one read back), then :func:`_compute`."""
    _r2_score_size_check(int(num_obs), num_regressors)
    return _compute(sum_squared_obs, sum_obs, rss, num_obs, multioutput, num_regressors)


def _r2_score_size_check(num_obs: int, num_regressors: int) -> None:
    if num_obs < 2:
        raise ValueError(
            "Not enough data to compute: the R2 score needs at least two samples."
        )
    if num_regressors >= num_obs - 1:
        raise ValueError(
            "The `num_regressors` must be smaller than n_samples - 1, "
            f"got num_regressors={num_regressors}, n_samples={num_obs}.",
        )


def _compute(
    sum_squared_obs: torch.Tensor,
    sum_obs: torch.Tensor,
    rss: torch.Tensor,
    num_obs: torch.Tensor,
    multioutput: str,
    num_regressors: int,
) -> torch.Tensor:
    tss = sum_squared_obs - torch.square(sum_obs) / num_obs
    r_squared = 1 - (rss / tss)
    if multioutput == "uniform_average":
        r_squared = torch.mean(r_squared)
    elif multioutput == "variance_weighted":
        r_squared = torch.sum(r_squared * tss / torch.sum(tss))
    if num_regressors != 0:
        r_squared = 1 - (1 - r_squared) * (num_obs - 1) / (num_obs - num_regressors - 1)
    return r_squared


def _r2_score_param_check(multioutput: str, num_regressors: int) -> None:
    if multioutput not in ("raw_values", "uniform_average", "variance_weighted"):
        raise ValueError(
            "The `multioutput` must be either `raw_values` or "
            "`uniform_average` or `variance_weighted`, "
            f"got multioutput={multioutput}."
        )
    if not isinstance(num_regressors, int) or num_regressors < 0:
        raise ValueError(
            "The `num_regressors` must an integer larger or equal to zero, "
            f"got num_regressors={num_regressors}."
        )


def _r2_score_update_input_check(input: torch.Tensor, target: torch.Tensor) -> None:
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
