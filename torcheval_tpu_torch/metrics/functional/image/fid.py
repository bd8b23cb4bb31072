"""Fréchet distance between multivariate gaussians, the core of FID (the
port of ``torcheval_tpu/metrics/functional/image/fid.py``).

d²((μ₁,Σ₁), (μ₂,Σ₂)) = |μ₁−μ₂|² + tr(Σ₁ + Σ₂ − 2·(Σ₁Σ₂)^½)

The matrix square root never materializes: tr((Σ₁Σ₂)^½) equals the sum of
square-rooted eigenvalues of the symmetric PSD matrix Σ₁^½ Σ₂ Σ₁^½, so
``torch.linalg.eigh`` and ``torch.linalg.eigvalsh`` (library calls, as
the JAX package leaves its two ``eigh`` to XLA) replace the non-symmetric
``sqrtm``.  float32 throughout, as the JAX package with x64 off, and the
products in full float32 (:func:`~._precision.full_f32`)."""

import torch

from torcheval_tpu_torch.metrics.functional._host_checks import place_inputs
from torcheval_tpu_torch.metrics.functional.image._precision import full_f32


def gaussian_frechet_distance(mu_x, cov_x, mu_y, cov_y) -> torch.Tensor:
    """Fréchet (2-Wasserstein²) distance between two gaussians given by
    mean vectors ``(D,)`` and covariance matrices ``(D, D)``."""
    mu_x, cov_x, mu_y, cov_y = place_inputs(mu_x, cov_x, mu_y, cov_y)
    _frechet_input_check(mu_x, cov_x, mu_y, cov_y)
    return _gaussian_frechet_distance_kernel(mu_x, cov_x, mu_y, cov_y)


def _gaussian_frechet_distance_kernel(
    mu_x: torch.Tensor, cov_x: torch.Tensor, mu_y: torch.Tensor, cov_y: torch.Tensor
) -> torch.Tensor:
    mu_x, cov_x, mu_y, cov_y = (t.to(torch.float32) for t in (mu_x, cov_x, mu_y, cov_y))
    diff = mu_x - mu_y
    with full_f32():
        # Σx^{1/2} by eigendecomposition (Σx symmetric PSD up to noise).
        w, v = torch.linalg.eigh(cov_x)
        sqrt_x = (v * torch.sqrt(torch.clamp(w, min=0.0))) @ v.T
        # eigvals of Σx^{1/2} Σy Σx^{1/2} = eigvals of Σx Σy, but symmetric.
        prod = sqrt_x @ cov_y @ sqrt_x
        prod_w = torch.linalg.eigvalsh((prod + prod.T) / 2.0)
        tr_sqrt = torch.sqrt(torch.clamp(prod_w, min=0.0)).sum()
        return diff @ diff + torch.trace(cov_x) + torch.trace(cov_y) - 2.0 * tr_sqrt


def _frechet_input_check(
    mu_x: torch.Tensor, cov_x: torch.Tensor, mu_y: torch.Tensor, cov_y: torch.Tensor
) -> None:
    d = mu_x.shape[0] if mu_x.dim() == 1 else -1
    if mu_x.dim() != 1 or tuple(mu_y.shape) != (d,):
        raise ValueError(
            "mean vectors should be one-dimensional and equally sized, got "
            f"{tuple(mu_x.shape)} and {tuple(mu_y.shape)}."
        )
    if tuple(cov_x.shape) != (d, d) or tuple(cov_y.shape) != (d, d):
        raise ValueError(
            f"covariances should have shape ({d}, {d}), got "
            f"{tuple(cov_x.shape)} and {tuple(cov_y.shape)}."
        )
