"""frequency_at_k (the port of
``torcheval_tpu/metrics/functional/ranking/frequency.py``; parity with the
reference ``torcheval/metrics/functional/ranking/frequency.py``)."""

import torch

from torcheval_tpu_torch.metrics.functional._host_checks import place_inputs


def frequency_at_k(input, k: float) -> torch.Tensor:
    """Binary f32 indicator of frequencies below ``k``
    (reference ``frequency.py:33``)."""
    (input,) = place_inputs(input)
    _frequency_input_check(input, k)
    return (input < k).to(torch.float32)


def _frequency_input_check(input: torch.Tensor, k: float) -> None:
    if input.dim() != 1:
        raise ValueError(
            f"input should be a one-dimensional tensor, got shape {tuple(input.shape)}."
        )
    if k < 0:
        raise ValueError(f"k should not be negative, got {k}.")
