"""Peak signal-to-noise ratio (the port of
``torcheval_tpu/metrics/functional/image/psnr.py``).

PSNR = 10·log10(data_range² / MSE); the sufficient statistics are the
summed squared error and the element count, add-mergeable counters, one
reduction a batch.  Float64 inputs are cast to float32 first, as the JAX
package holds them with x64 off."""

from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.metrics.functional._host_checks import place_inputs, x64_off


def peak_signal_noise_ratio(
    input,
    target,
    data_range: Optional[float] = None,
) -> torch.Tensor:
    """PSNR between two images or batches of images of the same shape.
    ``data_range`` defaults to ``max(target) − min(target)`` of the data
    seen (the convention upstream uses when unset)."""
    _psnr_param_check(data_range)
    input, target = x64_off(*place_inputs(input, target))
    _psnr_input_check(input, target)
    sum_se, n, observed_range = _psnr_update_kernel(input, target)
    if data_range is not None:
        observed_range = torch.tensor(float(data_range), device=input.device)
    return _psnr_compute(sum_se, n, observed_range)


def _psnr_update_kernel(
    input: torch.Tensor, target: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    lo, hi = torch.aminmax(target)
    return (*_psnr_sums(input, target), (hi - lo).to(torch.float32))


def _psnr_sums(input: torch.Tensor, target: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The summed squared error and the element count, both float32."""
    err = (input - target).to(torch.float32)
    return (
        torch.sum(torch.square(err)),
        torch.tensor(float(input.numel()), device=input.device),
    )


def _psnr_compute(
    sum_se: torch.Tensor, n: torch.Tensor, data_range: torch.Tensor
) -> torch.Tensor:
    mse = sum_se / n
    return 10.0 * torch.log10(torch.square(data_range) / mse)


def _psnr_param_check(data_range: Optional[float]) -> None:
    if data_range is not None:
        if not isinstance(data_range, (int, float)):
            raise ValueError(f"`data_range` should be a float, got {type(data_range)}.")
        if data_range <= 0:
            raise ValueError(f"`data_range` should be positive, got {data_range}.")


def _psnr_input_check(input: torch.Tensor, target: torch.Tensor) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same shape, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
