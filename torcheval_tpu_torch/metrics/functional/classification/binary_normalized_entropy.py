"""Binary normalized entropy (the port of
``torcheval_tpu/metrics/functional/classification/binary_normalized_entropy.py``;
parity with the reference
``torcheval/metrics/functional/classification/binary_normalized_entropy.py``).

NE = (weighted BCE of predictions) / (entropy of the base positive rate),
eps-clamped, with multi-task support through a leading task dimension.
The reference accumulates in float64; this package, like the JAX one,
accumulates in float32, which matches to six significant digits and more
at evaluation-scale workloads."""

from typing import Optional, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.metrics.functional._host_checks import (
    place_inputs,
    value_check,
    value_checks_enabled,
)
from torcheval_tpu_torch.telemetry import events as _telemetry


def _accum_dtype() -> torch.dtype:
    """The dtype of floating counter states: always ``torch.float32``.
    The JAX package takes float64 when ``jax_enable_x64`` is set and
    float32 otherwise; the port has no such switch, so a ``state_dict``
    of the default JAX configuration carries across as it is
    (``convert.state_from_jax``)."""
    return torch.float32


def binary_normalized_entropy(
    input,
    target,
    *,
    weight=None,
    num_tasks: int = 1,
    from_logits: bool = False,
) -> torch.Tensor:
    """Normalized cross entropy against the always-predict-base-rate
    baseline (reference ``binary_normalized_entropy.py:13-72``)."""
    if weight is None:
        input, target = place_inputs(input, target)
    else:
        input, target, weight = place_inputs(input, target, weight)
    cross_entropy, num_positive, num_examples = _binary_normalized_entropy_update(
        input, target, from_logits, num_tasks, weight
    )
    baseline_entropy = _baseline_update(num_positive, num_examples)
    return (cross_entropy / num_examples) / baseline_entropy


def _binary_normalized_entropy_update(
    input: torch.Tensor,
    target: torch.Tensor,
    from_logits: bool,
    num_tasks: int,
    weight: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    _ne_input_check(input, target, from_logits, num_tasks, weight)
    if weight is None:
        return _ne_update_kernel_unweighted(input, target, from_logits)
    return _ne_update_kernel(input, target, weight, from_logits)


def _ne_update_kernel_unweighted(
    input: torch.Tensor, target: torch.Tensor, from_logits: bool
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return _ne_update_kernel(input, target, torch.ones_like(input), from_logits)


def _ne_update_kernel(
    input: torch.Tensor,
    target: torch.Tensor,
    weight: torch.Tensor,
    from_logits: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    dtype = _accum_dtype()
    # A bool or integer target takes the input's float dtype first, as
    # JAX promotes it (torch refuses ``1 - target`` on a bool tensor).
    target = target.to(input.dtype if input.is_floating_point() else dtype)
    if from_logits:
        # log-sum-exp-stable BCE-with-logits: max(x,0) - x*y + log1p(exp(-|x|))
        ce = (
            torch.clamp(input, min=0)
            - input * target
            + torch.log1p(torch.exp(-torch.abs(input)))
        )
    else:
        eps = 1e-12
        clamped = torch.clamp(input, eps, 1 - eps)
        ce = -(target * torch.log(clamped) + (1 - target) * torch.log1p(-clamped))
    cross_entropy = (ce * weight).sum(dim=-1).to(dtype)
    num_examples = torch.sum(weight, dim=-1).to(dtype)
    num_positive = torch.sum(weight * target, dim=-1).to(dtype)
    return cross_entropy, num_positive, num_examples


def _baseline_update(
    num_positive: torch.Tensor, num_examples: torch.Tensor
) -> torch.Tensor:
    """Entropy of always predicting the base positive rate, eps-clamped
    (reference ``binary_normalized_entropy.py:~95-110``)."""
    eps = float(torch.finfo(_accum_dtype()).eps)
    base_pos_rate = torch.clamp(num_positive / num_examples, eps, 1 - eps)
    return -base_pos_rate * torch.log(base_pos_rate) - (
        1 - base_pos_rate
    ) * torch.log1p(-base_pos_rate)


def _ne_input_check(
    input: torch.Tensor,
    target: torch.Tensor,
    from_logits: bool,
    num_tasks: int,
    weight: Optional[torch.Tensor] = None,
) -> None:
    if input.shape != target.shape:
        raise ValueError(
            f"`input` shape ({tuple(input.shape)}) is different from `target` shape "
            f"({tuple(target.shape)})"
        )
    if weight is not None and input.shape != weight.shape:
        raise ValueError(
            f"`weight` shape ({tuple(weight.shape)}) is different from `input` shape "
            f"({tuple(input.shape)})"
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
    if not from_logits and input.numel() and value_checks_enabled():
        if _telemetry.ANNOTATE:
            with _telemetry.span("check.normalized_entropy"):
                return _check_probabilities(input)
        _check_probabilities(input)


def _check_probabilities(input: torch.Tensor) -> None:
    value_check("normalized_entropy", _judge_probabilities, input)


def _judge_probabilities(vals: np.ndarray) -> None:
    input_min, input_max = float(vals[0]), float(vals[1])
    if input_max > 1.0 or input_min < 0.0:
        raise ValueError(
            f"`from_logits`=False, `input` should be probability "
            f"in range [0., 1.], but got `input` ranging from {input_min} "
            f"to {input_max}. Please set `from_logits = True` or convert "
            "`input` into valid probability value."
        )
