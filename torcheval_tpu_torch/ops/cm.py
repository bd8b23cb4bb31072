"""The confusion-matrix count slab (the port of
``torcheval_tpu/ops/pallas_cm.py``).

:func:`confusion_slab` counts ``slab[t, p] = #{i : target_i = t, pred_i =
p}`` for labels already mapped into ``[0, C]`` (``C`` is the callers'
out-of-range sentinel).  For tensors on the GPU it launches the CUDA
kernel ``csrc/cm_slab.cu``; for tensors on the CPU it runs
:func:`_confusion_slab_plain`.  Counts are int32 integers in both, so the
two agree bit for bit.

Dropped from the JAX module, because they exist only for the TPU: the
64-class bucket compaction, the bf16 MXU gather, the triangular-prefix
matmul, the dense overflow branch and ``_cap_for`` (all of them work
around TPU scatters, which serialize), the lane-aligned window with its
tile-padding cell (the port's slab is exactly ``(C+1, C+1)``), and the
f32 accumulator's ``N < 2^24`` (the port counts in int32: ``N < 2^31``).
The TPU's VMEM budget ``W ≤ 1152`` becomes :data:`_MAX_W`, a bound of the
callers' route, not of the kernel.
"""

from __future__ import annotations

import torch

from torcheval_tpu_torch.ops import _build

# The callers' kernel route keeps the slab inside the H100's 50 MB L2
# while the atomics land, at most half of it: 2560^2 x 4 B = 25 MiB.  The
# kernel itself takes any window with W^2 < 2^31.
_MAX_W = 2560
_MAX_N = 2**31  # int32 counts and sample indices


def class_window(num_classes: int) -> int:
    """The slab's side W: labels ``[0, C]``, with ``C`` the sentinel."""
    return num_classes + 1


def confusion_slab(
    target: torch.Tensor, pred: torch.Tensor, *, num_classes: int
) -> torch.Tensor:
    """Exact ``(C+1, C+1)`` int32 count slab of the ``(N,)`` integer label
    vectors, each already mapped into ``[0, C]``.

    Labels outside ``[0, C]`` raise (one read back), unless value checks
    are skipped; the kernel then skips them, so it never writes outside
    the slab.  Requires ``N < 2^31``."""
    from torcheval_tpu_torch.metrics.functional._host_checks import (
        bounds,
        value_checks_enabled,
    )

    _check_slab_args(target, pred, num_classes)
    if value_checks_enabled() and target.numel():
        t_lo, t_hi, p_lo, p_hi = bounds(target, pred)
        if min(t_lo, p_lo) < 0 or max(t_hi, p_hi) > num_classes:
            raise ValueError(
                f"confusion_slab takes labels mapped into [0, {num_classes}], "
                f"got target in [{int(t_lo)}, {int(t_hi)}] and pred in "
                f"[{int(p_lo)}, {int(p_hi)}]."
            )
    return _slab(target, pred, num_classes)


def _check_slab_args(target: torch.Tensor, pred: torch.Tensor, num_classes: int) -> None:
    if target.dim() != 1 or target.shape != pred.shape:
        raise ValueError(
            "target and pred must be (N,) of one shape, got "
            f"{tuple(target.shape)} and {tuple(pred.shape)}."
        )
    if target.dtype.is_floating_point or pred.dtype.is_floating_point:
        raise TypeError(
            f"confusion_slab takes integer labels, got {target.dtype} and {pred.dtype}."
        )
    if target.device != pred.device:
        raise ValueError("target and pred must be on one device.")
    w = class_window(num_classes)
    if w * w >= 2**31:
        raise ValueError(
            f"num_classes={num_classes} needs a {w}x{w} slab, past the int32 "
            "cell index (W^2 < 2^31); use the scatter path."
        )
    if target.shape[0] >= _MAX_N:
        raise ValueError(f"{target.shape[0]} samples; the int32 counts need N < 2^31.")


def _slab(target: torch.Tensor, pred: torch.Tensor, num_classes: int) -> torch.Tensor:
    """:func:`confusion_slab` without the value check, for callers whose
    labels are in ``[0, C]`` by construction (``_wrap_labels`` then a
    clamp at the sentinel)."""
    if target.device.type == "cpu":
        return _confusion_slab_plain(target, pred, num_classes)
    if target.device.type != "cuda":
        raise ValueError(f"confusion_slab runs on cuda or cpu, not {target.device}.")
    w = class_window(num_classes)
    target = target.to(torch.int32).contiguous()
    pred = pred.to(torch.int32).contiguous()
    slab = torch.zeros((w, w), dtype=torch.int32, device=target.device)
    n = target.shape[0]
    if n == 0:
        return slab
    lib = _build.library()
    with torch.cuda.device(target.device):
        err = lib.cm_slab_launch(
            target.data_ptr(),
            pred.data_ptr(),
            n,
            w,
            slab.data_ptr(),
            _build.stream_handle(target.device),
        )
    _build.check_launch("cm_slab", err)
    _build.LAUNCHES["confusion_slab"] += 1
    return slab


def _confusion_slab_plain(
    target: torch.Tensor, pred: torch.Tensor, num_classes: int
) -> torch.Tensor:
    """The kernel's counts in plain PyTorch: one ``bincount`` of the flat
    cell ``t·W + p``.  A label outside ``[0, C]`` goes to one extra cell
    that is dropped, as the kernel skips it."""
    _build.PLAIN_CALLS["confusion_slab"] += 1
    w = class_window(num_classes)
    t, p = target.to(torch.int64), pred.to(torch.int64)
    valid = (t >= 0) & (t < w) & (p >= 0) & (p < w)
    flat = torch.where(valid, t * w + p, w * w)
    counts = torch.bincount(flat, minlength=w * w + 1)
    return counts[: w * w].to(torch.int32).view(w, w)


__all__ = ("class_window", "confusion_slab")
