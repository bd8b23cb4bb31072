"""Shape bucketing for ragged update streams (the port of
``torcheval_tpu/metrics/_bucket.py``).

Padding each batch up to the next power-of-two bucket caps the distinct
batch shapes of a ragged stream at O(log max_batch), and a validity mask
keeps the padded rows out of every count: the counter members' updates
take ``mask=`` and add nothing for a row whose mask is 0.  The JAX
package buckets so that ``jax.jit`` compiles O(log max_batch) programs
instead of one per batch size; the port runs eagerly, and keeps the same
padding so that a bucketed collection computes the same states, bit for
bit, on both.

Padded rows EDGE-REPLICATE the last valid row rather than zero-fill, so
class indices stay in range for the value checks the update paths run.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.telemetry import events as _telemetry

# Floor for bucket sizes: batches below this all share one shape.
DEFAULT_MIN_BUCKET = 128


def bucket_size(
    n: int, *, min_bucket: int = DEFAULT_MIN_BUCKET, multiple_of: int = 1
) -> int:
    """The padded batch size for a raw batch of ``n`` rows: the next
    power of two, floored at ``min_bucket``, then rounded up to a
    multiple of ``multiple_of``."""
    if n < 0:
        raise ValueError(f"batch size must be non-negative, got {n}")
    b = max(int(min_bucket), 1)
    while b < n:
        b *= 2
    if multiple_of > 1:
        b += (-b) % multiple_of
    return b


def bucket_sizes(
    max_batch: int, *, min_bucket: int = DEFAULT_MIN_BUCKET, multiple_of: int = 1
) -> Tuple[int, ...]:
    """Every bucket a stream with batches in ``[0, max_batch]`` can land
    in, smallest first."""
    sizes = []
    b = bucket_size(0, min_bucket=min_bucket, multiple_of=multiple_of)
    top = bucket_size(max_batch, min_bucket=min_bucket, multiple_of=multiple_of)
    while True:
        sizes.append(b)
        if b >= top:
            return tuple(sizes)
        b = bucket_size(b + 1, min_bucket=min_bucket, multiple_of=multiple_of)


def pad_to_bucket(
    *arrays,
    mask: Optional[torch.Tensor] = None,
    min_bucket: int = DEFAULT_MIN_BUCKET,
    multiple_of: int = 1,
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Pad every array's leading (batch) dim up to its bucket; return
    ``(padded_arrays, mask)`` where ``mask`` is int32 ``(bucket,)`` with
    1 for real rows and 0 for padding, on the first array's device.

    Padded rows edge-replicate the last valid row.  An incoming ``mask``
    is padded with zeros and so combined.  All arrays must share the
    leading dim; empty batches pad with zeros."""
    if not arrays:
        raise ValueError("pad_to_bucket needs at least one array")
    arrays = tuple(torch.as_tensor(a) for a in arrays)
    n = arrays[0].shape[0]
    device = arrays[0].device
    for a in arrays[1:]:
        if a.shape[0] != n:
            raise ValueError(
                "pad_to_bucket requires a shared leading dim, got "
                f"{[tuple(a.shape) for a in arrays]}."
            )
    if mask is not None:
        mask = torch.as_tensor(mask, device=device)
        if tuple(mask.shape) != (n,):
            raise ValueError(f"mask must have shape ({n},), got {tuple(mask.shape)}.")
    bucket = bucket_size(n, min_bucket=min_bucket, multiple_of=multiple_of)
    pad = bucket - n
    if _telemetry.ENABLED:
        # Recorded on the pad == 0 path too, so a waste ratio has the
        # full denominator.
        _telemetry.record_bucket_pad(bucket, n, pad)
    valid = (
        mask.to(torch.int32)
        if mask is not None
        else torch.ones(n, dtype=torch.int32, device=device)
    )
    if pad == 0:
        return arrays, valid
    padded = []
    for a in arrays:
        if n == 0:
            fill = torch.zeros((pad,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
        else:
            fill = a[-1:].expand((pad,) + tuple(a.shape[1:]))
        padded.append(torch.cat([a, fill]))
    out_mask = torch.cat([valid, torch.zeros(pad, dtype=torch.int32, device=device)])
    return tuple(padded), out_mask


__all__ = ("DEFAULT_MIN_BUCKET", "bucket_size", "bucket_sizes", "pad_to_bucket")
