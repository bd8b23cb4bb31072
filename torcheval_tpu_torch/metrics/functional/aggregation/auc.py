"""AUC: trapezoidal area under an arbitrary sampled (x, y) curve (the
port of ``torcheval_tpu/metrics/functional/aggregation/auc.py``).  One
stable sort (when ``reorder``) and a trapezoid sum; multi-task through a
leading dim like the other aggregation metrics."""

import torch

from torcheval_tpu_torch.metrics.functional._host_checks import place_inputs


def auc(x, y, *, reorder: bool = True, num_tasks: int = 1) -> torch.Tensor:
    """Area under the piecewise-linear curve through the ``(x, y)`` points;
    ``reorder`` sorts the points by x first (needed whenever the x samples
    are not already monotonic)."""
    x, y = place_inputs(x, y)
    _auc_input_check(x, y, num_tasks)
    return _auc_compute_kernel(x, y, reorder)


def _auc_compute_kernel(x: torch.Tensor, y: torch.Tensor, reorder: bool) -> torch.Tensor:
    squeeze = x.dim() == 1
    if squeeze:
        x, y = x[None], y[None]
    if reorder:
        # Stable, as jnp.argsort is: tied x keep their order.
        order = torch.argsort(x, dim=-1, stable=True)
        x = torch.gather(x, -1, order)
        y = torch.gather(y, -1, order)
    area = torch.trapezoid(y, x, dim=-1)
    return area[0] if squeeze else area


def _auc_input_check(x: torch.Tensor, y: torch.Tensor, num_tasks: int) -> None:
    if x.shape != y.shape:
        raise ValueError(
            f"`x` and `y` should have the same shape, got {tuple(x.shape)} and "
            f"{tuple(y.shape)}."
        )
    if num_tasks == 1:
        if x.dim() != 1:
            raise ValueError(
                "`x` should be a one-dimensional tensor for num_tasks = 1, "
                f"got shape {tuple(x.shape)}."
            )
    elif x.dim() != 2 or x.shape[0] != num_tasks:
        raise ValueError(
            f"`x` should have shape ({num_tasks}, num_samples) for "
            f"num_tasks = {num_tasks}, got shape {tuple(x.shape)}."
        )
