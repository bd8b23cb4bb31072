"""num_collisions (the port of
``torcheval_tpu/metrics/functional/ranking/num_collisions.py``; parity with
the reference ``torcheval/metrics/functional/ranking/num_collisions.py``).

An O(N²) broadcast equality minus self (reference
``num_collisions.py:31-35``); int32 counts, as the JAX package returns."""

import torch

from torcheval_tpu_torch.metrics.functional._host_checks import place_inputs


def num_collisions(input) -> torch.Tensor:
    """Per-id count of the other ids equal to it."""
    (input,) = place_inputs(input)
    _num_collisions_input_check(input)
    return ((input[None, :] == input[:, None]).sum(dim=1) - 1).to(torch.int32)


def _num_collisions_input_check(input: torch.Tensor) -> None:
    if input.dim() != 1:
        raise ValueError(
            f"input should be a one-dimensional tensor, got shape {tuple(input.shape)}."
        )
    if input.is_floating_point() or input.is_complex() or input.dtype == torch.bool:
        raise ValueError(f"input should be an integer tensor, got {input.dtype}.")
