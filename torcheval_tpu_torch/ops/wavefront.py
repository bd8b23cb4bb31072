"""Batched token-level edit distance (the port of
``torcheval_tpu/ops/pallas_wavefront.py``).

:func:`edit_distance_tokens` takes two padded ``(n, len)`` id arrays and
returns the ``(n,)`` int32 Levenshtein distances.  The DP is sequential in
``(i, j)``, but every cell on one anti-diagonal ``d = i + j`` depends only
on the diagonals ``d - 1`` and ``d - 2``, so a diagonal is data-parallel.

**Route.**  Tensors on the GPU launch the CUDA kernel
``csrc/wavefront.cu`` or raise; tensors on the CPU run
:func:`_edit_distance_plain`, the same diagonal sweep in torch ops.  That
is all.  Distances are integers, so the two agree bit for bit, and both
agree with the host DP of ``torcheval_tpu_torch/native``
(:func:`_edit_distance_native`, the oracle of the tests; no route reaches
it).

Not carried over from the JAX module: ``wavefront_route``'s three-way
choice, the ``TORCHEVAL_TPU_WAVEFRONT`` flag and the measured-cost lookup
behind it (a falsy flag would send GPU tensors to the plain version, a
switch that hides the kernel), and ``wavefront_plan``, which sizes TPU
tiles and their on-chip memory.  The kernel's own geometry is a warp a
pair, the shorter side on the rows, ``R`` rows a lane (:func:`_strip_rows`)
and bands of 256 rows past that (``csrc/wavefront.cu``); the launch and
its carry scratch are :func:`_wavefront_plan`, from the shapes alone (the
kernel clips each pair's lengths on the card), so a launch reads nothing
back and runs inside the engine's captured graphs.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.ops import _build

# Out-of-matrix poison of the plain version: big enough that min() never
# picks a garbage lane, small enough that += 1 per diagonal cannot wrap.
_BIG = 1 << 30

# The kernel's geometry (csrc/wavefront.cu): warps (pairs in flight) a
# block, rows a lane at most, so a band of 32 x 8 rows; past one band each
# warp keeps two carry rows of max(wa, wb) int32 in a global scratch of
# about _SCRATCH_BYTES, and the warps stride over the pairs.
_WARPS = 4
_MAX_R = 8
_BAND_ROWS = 32 * _MAX_R
_SCRATCH_BYTES = 2**25
_MIN_SCRATCH_WARPS = 4 * 132  # a block for each of the H100's 132 SMs


def _strip_rows(m: int) -> int:
    """Rows a lane (``R``) for a pair whose shorter side has ``m`` tokens:
    the least of 1, 2, 4, 8 whose 32 lanes cover them, 8 past 256 (bands).
    The kernel applies the same rule to each pair."""
    for r in (1, 2, 4):
        if m <= 32 * r:
            return r
    return _MAX_R


def _wavefront_plan(n: int, wa: int, wb: int) -> Tuple[int, int]:
    """``(blocks, scratch_len)`` of a ``wavefront.cu`` launch over ``n``
    pairs of widths ``wa`` and ``wb``: a warp a pair in blocks of
    :data:`_WARPS`.  While the shorter width fits one band, every pair
    gets its own warp and no scratch; past it the warps (at most one a
    pair, at least :data:`_MIN_SCRATCH_WARPS`, else as many as
    :data:`_SCRATCH_BYTES` of carries hold) stride over the pairs, each
    with two carry rows of ``max(wa, wb)`` int32 (``scratch_len``)."""
    if min(wa, wb) <= _BAND_ROWS:
        return -(-n // _WARPS), 0
    row = 2 * max(wa, wb)
    warps = min(n, max(_MIN_SCRATCH_WARPS, _SCRATCH_BYTES // (4 * row)))
    blocks = -(-warps // _WARPS)
    return blocks, blocks * _WARPS * row


def lens_from_ids(ids: torch.Tensor) -> torch.Tensor:
    """Sequence lengths from the negative-id padding convention: tokens
    are ``>= 0``, pads ``< 0`` and trailing (prefix-packed rows, the
    ``metrics/text/_tokens.py`` contract).  A count, so a malformed row
    (a pad between tokens) gives what the JAX package gives."""
    return (ids >= 0).sum(dim=1).to(torch.int32)


def edit_distance_tokens(
    a_ids: torch.Tensor,
    b_ids: torch.Tensor,
    a_lens: Optional[torch.Tensor] = None,
    b_lens: Optional[torch.Tensor] = None,
    *,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Batched token-level Levenshtein distance, ``(n,) int32``.

    ``a_ids`` / ``b_ids`` are ``(n, len)`` integer id tensors (ragged
    batches ride padded, pads negative and trailing); lengths default to
    :func:`lens_from_ids` and are clipped to the widths.  ``mask``
    (``(n,)``, nonzero = live) zeroes pad pairs, so a bucket row past the
    batch adds nothing."""
    if a_ids.dim() != 2 or b_ids.dim() != 2:
        raise ValueError(
            "edit_distance_tokens expects (n, len) id arrays, got "
            f"{tuple(a_ids.shape)} and {tuple(b_ids.shape)}"
        )
    if a_ids.shape[0] != b_ids.shape[0]:
        raise ValueError(
            "edit_distance_tokens expects the same number of sequences, "
            f"got {a_ids.shape[0]} and {b_ids.shape[0]}"
        )
    if a_ids.dtype.is_floating_point or b_ids.dtype.is_floating_point:
        raise TypeError(
            f"edit_distance_tokens takes integer ids, got {a_ids.dtype} and {b_ids.dtype}."
        )
    if a_ids.device != b_ids.device:
        raise ValueError("a_ids and b_ids must be on one device.")
    if a_lens is None:
        a_lens = lens_from_ids(a_ids)
    if b_lens is None:
        b_lens = lens_from_ids(b_ids)
    device = a_ids.device
    a_lens = torch.clamp(torch.as_tensor(a_lens, device=device), 0, a_ids.shape[1])
    b_lens = torch.clamp(torch.as_tensor(b_lens, device=device), 0, b_ids.shape[1])
    if device.type == "cpu":
        dist = _edit_distance_plain(a_ids, b_ids, a_lens, b_lens)
    elif device.type == "cuda":
        dist = _edit_distance_kernel(a_ids, b_ids, a_lens, b_lens)
    else:
        raise ValueError(f"edit_distance_tokens runs on cuda or cpu, not {device}.")
    if mask is not None:
        mask = torch.as_tensor(mask, device=device)
        dist = torch.where(mask != 0, dist, torch.zeros_like(dist))
    return dist


def _edit_distance_kernel(
    a_ids: torch.Tensor, b_ids: torch.Tensor, a_lens: torch.Tensor, b_lens: torch.Tensor
) -> torch.Tensor:
    """Launch ``csrc/wavefront.cu`` on GPU tensors; lengths already
    clipped to the widths."""
    n, wa = a_ids.shape
    wb = b_ids.shape[1]
    device = a_ids.device
    out = torch.empty(n, dtype=torch.int32, device=device)  # the kernel writes every pair
    if n == 0:
        return out
    if n >= 2**31 or max(wa, wb) >= 2**29:
        raise ValueError(
            f"edit_distance_tokens: {n} pairs of widths {wa} and {wb} pass the "
            "kernel's int32 indices."
        )
    a = a_ids.to(torch.int32).contiguous()
    b = b_ids.to(torch.int32).contiguous()
    al = a_lens.to(torch.int32).contiguous()
    bl = b_lens.to(torch.int32).contiguous()
    blocks, scratch_len = _wavefront_plan(n, wa, wb)
    scratch = (
        torch.empty(scratch_len, dtype=torch.int32, device=device) if scratch_len else None
    )
    lib = _build.library()
    with torch.cuda.device(device):
        err = lib.wavefront_launch(
            a.data_ptr(),
            b.data_ptr(),
            al.data_ptr(),
            bl.data_ptr(),
            n,
            wa,
            wb,
            None if scratch is None else scratch.data_ptr(),
            blocks,
            out.data_ptr(),
            _build.stream_handle(device),
        )
    _build.check_launch("wavefront", err)
    _build.count_launch("edit_distance_tokens")
    return out


def _shift_lanes(x: torch.Tensor, fill: int) -> torch.Tensor:
    """One-lane right shift: lane ``i`` gets lane ``i-1``, lane 0 ``fill``."""
    col = torch.full((x.shape[0], 1), fill, dtype=x.dtype, device=x.device)
    return torch.cat([col, x[:, :-1]], dim=1)


def _edit_distance_plain(
    a_ids: torch.Tensor, b_ids: torch.Tensor, a_lens: torch.Tensor, b_lens: torch.Tensor
) -> torch.Tensor:
    """The kernel's distances in plain PyTorch: the diagonal sweep of the
    JAX package's ``_edit_distance_xla``, integer for integer.  Lane ``i``
    of diagonal ``d`` is cell ``(i, d - i)``; the whole bucket advances one
    diagonal a step, to ``La + Lb``, and a one-hot capture takes cell
    ``(a_len, b_len)`` on the step its diagonal is computed."""
    _build.count_plain("edit_distance_tokens")
    n, len_a = a_ids.shape
    len_b = b_ids.shape[1]
    device = a_ids.device
    width = len_a + 1
    a_col = torch.cat(
        [torch.full((n, 1), -1, dtype=torch.int32, device=device), a_ids.to(torch.int32)],
        dim=1,
    )
    b_safe = (
        b_ids.to(torch.int32)
        if len_b
        else torch.zeros((n, 1), dtype=torch.int32, device=device)
    )
    lb_safe = max(len_b, 1)
    lane = torch.arange(width, dtype=torch.int32, device=device)[None, :]
    al = a_lens.to(torch.int32)[:, None]
    bl = b_lens.to(torch.int32)[:, None]
    capture_at = al + bl
    at_len = lane == al
    prev1 = torch.full((n, width), _BIG, dtype=torch.int32, device=device)
    prev2 = prev1
    bb = torch.zeros((n, width), dtype=torch.int32, device=device)
    out = torch.zeros((n, width), dtype=torch.int32, device=device)
    for d in range(len_a + len_b + 1):
        # Roll the reversed-reference window one lane and push b[d-1] into
        # lane 0 (clamped at d = 0: the value lands only in boundary cells).
        col = min(max(d - 1, 0), lb_safe - 1)
        bb = torch.cat([b_safe[:, col : col + 1], bb[:, :-1]], dim=1)
        sub = (a_col != bb).to(torch.int32)
        cur = torch.minimum(
            torch.minimum(_shift_lanes(prev1, _BIG), prev1) + 1,
            _shift_lanes(prev2, _BIG) + sub,
        )
        cur[:, 0] = d
        if d < width:
            cur[:, d] = d
        out = torch.where((capture_at == d) & at_len, cur, out)
        prev2, prev1 = prev1, cur
    return out.sum(dim=1, dtype=torch.int32)


def _edit_distance_native(a_ids, b_ids, a_lens, b_lens) -> np.ndarray:
    """The host DP of ``torcheval_tpu_torch/native`` over the same padded
    arrays (numpy, or tensors copied to the host): the oracle that the
    kernel and the plain version are integer-equal to.  ``(n,) int64``."""
    from torcheval_tpu_torch.native.edit_distance import edit_distance_batch

    a, b, al, bl = (
        x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        for x in (a_ids, b_ids, a_lens, b_lens)
    )
    a_seqs = [a[r, : al[r]].tolist() for r in range(a.shape[0])]
    b_seqs = [b[r, : bl[r]].tolist() for r in range(b.shape[0])]
    return edit_distance_batch(a_seqs, b_seqs)


__all__ = ("edit_distance_tokens", "lens_from_ids")
