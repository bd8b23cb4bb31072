"""``zeros(length).at[index].add(values)`` with JAX's index semantics.

JAX wraps a negative index once (``index + length``) and drops what is
still outside ``[0, length)``; torch's ``index_add_`` raises on both.
Such indices reach a scatter only when value checks are skipped.
"""

import torch


def at_add(length: int, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``(length,)`` sums of ``values`` by ``index``, in ``values``' dtype,
    as JAX's ``.at[index].add(values)`` computes them: the scatter goes
    into a buffer one wider, whose last slot takes the dropped indices."""
    index = index.to(torch.int64)
    index = torch.where(index < 0, index + length, index)
    index = torch.where((index < 0) | (index >= length), length, index)
    out = torch.zeros(length + 1, dtype=values.dtype, device=values.device)
    return out.index_add_(0, index, values)[:length]
