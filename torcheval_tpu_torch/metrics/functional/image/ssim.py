"""Structural similarity (SSIM), Wang et al. 2004 (the port of
``torcheval_tpu/metrics/functional/image/ssim.py``).

The 11×11 σ=1.5 gaussian windowing is a depthwise convolution per moment,
``torch.nn.functional.conv2d(..., groups=C)`` with no padding over the
same float32 window as the JAX package's
``lax.conv_general_dilated(..., feature_group_count=C)``: a library call,
as the JAX package leaves it to XLA.  The convolutions run in full float32
(:func:`~._precision.full_f32`), so a caller's TF32 setting changes no
bit.  The SSIM map is averaged over the valid region; the sufficient
statistics are the per-image SSIM sum and the image count."""

from typing import Tuple

import numpy as np
import torch

from torcheval_tpu_torch.metrics.functional._host_checks import place_inputs
from torcheval_tpu_torch.metrics.functional.image._precision import full_f32


def structural_similarity(
    input,
    target,
    *,
    data_range: float = 1.0,
    kernel_size: int = 11,
    sigma: float = 1.5,
    k1: float = 0.01,
    k2: float = 0.03,
) -> torch.Tensor:
    """Mean SSIM over a batch of ``(N, C, H, W)`` image pairs."""
    input, target = place_inputs(input, target)
    _ssim_input_check(input, target, kernel_size)
    per_image = _ssim_per_image(input, target, data_range, kernel_size, sigma, k1, k2)
    return per_image.mean()


def _ssim_per_image(
    input: torch.Tensor,
    target: torch.Tensor,
    data_range: float,
    kernel_size: int,
    sigma: float,
    k1: float,
    k2: float,
) -> torch.Tensor:
    """Per-image mean SSIM, shape ``(N,)``."""
    x = input.to(torch.float32)
    y = target.to(torch.float32)
    window = _gaussian_window(x.shape[1], kernel_size, sigma, x.device)

    def blur(z: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.conv2d(z, window, groups=x.shape[1])

    with full_f32():
        mu_x, mu_y = blur(x), blur(y)
        mu_xx, mu_yy, mu_xy = mu_x * mu_x, mu_y * mu_y, mu_x * mu_y
        sigma_x = blur(x * x) - mu_xx
        sigma_y = blur(y * y) - mu_yy
        sigma_xy = blur(x * y) - mu_xy
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    ssim_map = ((2 * mu_xy + c1) * (2 * sigma_xy + c2)) / (
        (mu_xx + mu_yy + c1) * (sigma_x + sigma_y + c2)
    )
    return ssim_map.mean(dim=(1, 2, 3))


def _gaussian_window(
    channels: int, kernel_size: int, sigma: float, device: torch.device
) -> torch.Tensor:
    """The ``(C, 1, k, k)`` float32 depthwise weight: the outer product of
    the 1-D gaussian in float64, rounded once, as the JAX package builds
    it."""
    g = _gaussian_1d(kernel_size, sigma)
    window = torch.from_numpy(np.outer(g, g).astype(np.float32)).to(device)
    return window.expand(channels, 1, kernel_size, kernel_size).contiguous()


def _gaussian_1d(kernel_size: int, sigma: float) -> np.ndarray:
    half = (kernel_size - 1) / 2.0
    coords = np.arange(kernel_size) - half
    g = np.exp(-(coords**2) / (2.0 * sigma**2))
    return g / g.sum()


def _ssim_input_check(input: torch.Tensor, target: torch.Tensor, kernel_size: int) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same shape, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if input.dim() != 4:
        raise ValueError(
            "input should have shape (num_images, channels, height, width), "
            f"got {tuple(input.shape)}."
        )
    if min(input.shape[2], input.shape[3]) < kernel_size:
        raise ValueError(
            f"image spatial dims {tuple(input.shape[2:])} must be at least the "
            f"gaussian kernel size {kernel_size}."
        )
