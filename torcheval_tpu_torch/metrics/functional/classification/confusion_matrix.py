"""Confusion matrix — the port of
``torcheval_tpu/metrics/functional/classification/confusion_matrix.py``
(parity with the reference
``torcheval/metrics/functional/classification/confusion_matrix.py``).

The ``(C, C)`` counts take one of three routes (:func:`_cm_route`),
decided from shapes and flags only, never from the device; the names are
the JAX package's:

* ``"matmul"``: one-hot encodings multiplied with ``torch.matmul``
  (``cm = onehot(target)ᵀ @ onehot(pred)``), for C ≤ 64;
* ``"pallas"``: the count slab of :mod:`torcheval_tpu_torch.ops.cm`, the
  CUDA kernel ``csrc/cm_slab.cu`` on the GPU and its plain version on
  the CPU;
* ``"scatter"``: one ``index_add_`` over the flat cells, elsewhere.

F1, precision and recall derive their per-class count trio from the same
routed slab (:func:`_class_counts`).  All routes count in integers (the
matmul's f32 sums are exact below 2^24 per cell), so they agree bit for
bit.  The JAX backend gates and the ``DISABLE_PALLAS`` checks are
dropped; the TPU-timed bounds that were re-derived are listed in
``PERF.md``.
"""

from functools import partial
from typing import List, Optional

import numpy as np
import torch

from torcheval_tpu_torch.metrics.functional._host_checks import (
    place_inputs,
    value_check,
    value_checks_enabled,
)
from torcheval_tpu_torch.metrics.functional._scatter import at_add
from torcheval_tpu_torch.ops._flags import cm_row_chunk
from torcheval_tpu_torch.ops.cm import _MAX_N, _MAX_W, _slab, class_window
from torcheval_tpu_torch.telemetry import events as _telemetry


def binary_confusion_matrix(
    input,
    target,
    *,
    threshold: float = 0.5,
    normalize: Optional[str] = None,
) -> torch.Tensor:
    """2×2 confusion matrix of thresholded predictions
    (reference ``confusion_matrix.py:14-64``)."""
    _confusion_matrix_param_check(2, normalize)
    input, target = place_inputs(input, target)
    matrix = _binary_confusion_matrix_update(input, target, threshold)
    return _confusion_matrix_compute(matrix, normalize)


def multiclass_confusion_matrix(
    input,
    target,
    num_classes: int,
    *,
    normalize: Optional[str] = None,
) -> torch.Tensor:
    """C×C matrix; entry (i, j) counts true class i predicted as j
    (reference ``confusion_matrix.py:67-147``)."""
    _confusion_matrix_param_check(num_classes, normalize)
    input, target = place_inputs(input, target)
    cm = _confusion_matrix_update(input, target, num_classes)
    return _confusion_matrix_compute(cm, normalize)


def _confusion_matrix_update(
    input: torch.Tensor, target: torch.Tensor, num_classes: int
) -> torch.Tensor:
    _confusion_matrix_update_input_check(input, target, num_classes)
    return _confusion_matrix_update_kernel(
        input, target, num_classes, _cm_route(num_classes, input.shape[0])
    )


def _cm_route(num_classes: int, num_samples: int) -> str:
    """Route of the (C, C) count accumulation, from shapes and flags:
    ``"matmul"`` for C ≤ 64 within :func:`_use_matmul_cm`'s bounds, the
    slab kernel (``"pallas"``) while its window stays within ``_MAX_W``
    and N < 2^31, ``"scatter"`` beyond."""
    if _use_matmul_cm(num_classes, num_samples) and num_classes <= 64:
        return "matmul"
    if class_window(num_classes) <= _MAX_W and num_samples < _MAX_N:
        return "pallas"
    return "scatter"


def _use_matmul_cm(num_classes: int, num_samples: int) -> bool:
    """Whether the one-hot product may count these shapes: f32 sums are
    exact only below 2^24 per cell, and the two (n, C) one-hots bound
    memory (n·C ≤ 2^28).  The C ≤ 512 ceiling is the JAX package's."""
    if num_classes > 512 or num_samples >= 2**24:
        return False
    return num_samples * num_classes <= 2**28


def _matmul_cm(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """(C, C) int32 counts as one-hot products: cm = onehot(target)ᵀ @
    onehot(pred)."""
    return _onehot_cm(target, input, num_classes, mask=mask).to(torch.int32)


def _onehot_cm_block(
    t: torch.Tensor, p: torch.Tensor, width: int, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """``(width, width)`` f32 counts as one product of f32 one-hots.  0 and
    1 are exact in f32 and in TF32, so the product is exact below 2^24
    per cell whatever ``torch.backends.cuda.matmul.allow_tf32`` says.
    ``mask`` zeroes rows of the target one-hot."""
    classes = torch.arange(width, device=t.device)
    oh_t = (t[:, None] == classes[None, :]).to(torch.float32)
    if mask is not None:
        oh_t = oh_t * mask.to(torch.float32)[:, None]
    oh_p = (p[:, None] == classes[None, :]).to(torch.float32)
    return oh_t.T @ oh_p


def _onehot_cm(
    t: torch.Tensor,
    p: torch.Tensor,
    width: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`_onehot_cm_block` over row chunks of at most
    :func:`_cm_row_chunk` rows, summed with exact f32 integer adds: the
    result is bit-identical at any chunking."""
    row_chunk = _cm_row_chunk()
    n = t.shape[0]
    if n <= row_chunk:
        return _onehot_cm_block(t, p, width, mask)
    acc = torch.zeros((width, width), dtype=torch.float32, device=t.device)
    for start in range(0, n, row_chunk):
        rows = slice(start, start + row_chunk)
        m = None if mask is None else mask[rows]
        acc = acc + _onehot_cm_block(t[rows], p[rows], width, m)
    return acc


def _cm_row_chunk() -> int:
    """Row cap of one one-hot block, resolved at call time: the
    ``TORCHEVAL_TPU_TORCH_CM_ROW_CHUNK`` flag when it is set (an explicit
    flag outranks a measurement), else the measured-cost layer's pick when
    it is on and has raced chunk heights, else the flag's default (4096).
    Chunking bounds the live one-hots to 2·chunk·width f32 and never
    changes the counts, which is what makes the height safe to race."""
    chunk = cm_row_chunk()
    from torcheval_tpu_torch import routing_autotune as _autotune

    if _autotune.ENABLED:
        try:
            chunk = int(_autotune.decide("cm_row_chunk", "*", str(chunk)))
        except ValueError:  # a store row that is not an integer
            pass
    return chunk


def _wrap_labels(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    # Numpy-style negative wrap-around, once, so every route counts the
    # same out-of-range labels (reachable under skip_value_checks):
    # [-C, 0) wraps, anything still negative maps to the sentinel C, which
    # every route drops.
    x = torch.where(x < 0, x + num_classes, x)
    return torch.where(x < 0, num_classes, x)


def _confusion_matrix_update_kernel(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    route: str = "scatter",
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    if input.dim() == 2:
        input = torch.argmax(input, dim=1)
    input = _wrap_labels(input, num_classes)
    target = _wrap_labels(target, num_classes)
    if mask is not None and route == "pallas":
        # The slab kernel has no masked-row path; the scatter is
        # bit-identical and adding a 0 is a no-op.
        route = "scatter"
    if route == "matmul":
        return _matmul_cm(input, target, num_classes, mask=mask)
    if route == "pallas":
        slab = _slab(
            target.clamp(max=num_classes), input.clamp(max=num_classes), num_classes
        )
        return slab[:num_classes, :num_classes]
    ones = (
        torch.ones_like(target, dtype=torch.int32)
        if mask is None
        else mask.to(torch.int32)
    )
    c = num_classes
    flat = torch.where(
        (target < c) & (input < c), target.to(torch.int64) * c + input, c * c
    )
    return at_add(c * c, flat, ones).view(c, c)


def _counts_route(input, num_classes, average) -> str:
    """Route of the F1/precision/recall per-class count trio: the micro
    paths need no per-class counts; everything else follows the
    confusion-matrix route for its (N, C) shape."""
    if average == "micro" or num_classes is None:
        return "scatter"
    return _cm_route(num_classes, input.shape[0])


def _class_counts(
    pred: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    route: str,
    mask: Optional[torch.Tensor] = None,
):
    """The per-class ``(num_tp, num_label, num_prediction)`` int32 trio
    shared by F1 / precision / recall, through the confusion matrix's
    route: ONE (C+1, C+1) slab whose sentinel row and column ``C`` keep
    out-of-range labels in the other label's marginal.  Labels wrap as in
    :func:`_wrap_labels`, and correctness is wrapped equality, so
    ``num_tp`` is the diagonal of the metric's own confusion matrix.
    ``pred`` must already be 1-D labels."""
    c = num_classes
    t = _wrap_labels(target, c).clamp(max=c)
    p = _wrap_labels(pred, c).clamp(max=c)
    if mask is not None and route == "pallas":
        route = "scatter"  # no masked-row path in the slab kernel
    if route == "scatter":
        ones = (
            torch.ones_like(t, dtype=torch.int32)
            if mask is None
            else mask.to(torch.int32)
        )
        correct = ((t == p) & (t < c)).to(torch.int32) * ones
        return at_add(c, t, correct), at_add(c, t, ones), at_add(c, p, ones)
    if route == "pallas":
        slab = _slab(t, p, c)
    else:  # matmul over the (C+1)-wide sentinel window
        slab = _onehot_cm(t, p, c + 1, mask=mask)
    num_label = slab[:c, :].sum(dim=1).to(torch.int32)
    num_prediction = slab[:, :c].sum(dim=0).to(torch.int32)
    num_tp = torch.diagonal(slab[:c, :c]).to(torch.int32)
    return num_tp, num_label, num_prediction


def _binary_confusion_matrix_validate(input: torch.Tensor, target: torch.Tensor) -> None:
    _binary_confusion_matrix_input_check(input, target)
    # Out-of-range targets must raise, as torch's scatter_ does in the
    # reference; the port's scatter would drop them.
    if target.numel() and value_checks_enabled():
        if _telemetry.ANNOTATE:
            with _telemetry.span("check.binary_confusion_matrix"):
                return _check_binary_target(target)
        _check_binary_target(target)


def _check_binary_target(target: torch.Tensor) -> None:
    value_check("binary_confusion_matrix", _judge_binary_target, target)


def _judge_binary_target(vals: np.ndarray) -> None:
    t_min, t_max = vals
    if t_min < 0 or t_max >= 2:
        raise ValueError(
            "Got `target` class which is larger than the number of classes, "
            "num_classes: 2 must be strictly greater than max target: "
            f"{int(t_max)}."
        )


def _binary_confusion_matrix_update_kernel(
    input: torch.Tensor,
    target: torch.Tensor,
    threshold: float,
    use_matmul: bool = False,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    pred = torch.where(input < threshold, 0, 1)
    return _confusion_matrix_update_kernel(
        pred,
        target.to(torch.int32),
        2,
        "matmul" if use_matmul else "scatter",
        mask=mask,
    )


def _binary_confusion_matrix_update(
    input: torch.Tensor, target: torch.Tensor, threshold: float
) -> torch.Tensor:
    _binary_confusion_matrix_validate(input, target)
    return _binary_confusion_matrix_update_kernel(
        input, target, threshold, _use_matmul_cm(2, input.shape[0])
    )


def _confusion_matrix_compute(
    confusion_matrix: torch.Tensor, normalize: Optional[str]
) -> torch.Tensor:
    """Normalize over predictions (columns), true labels (rows), or all
    (reference ``confusion_matrix.py:195-207``: ``pred`` → L1 along dim 0,
    ``true`` → along dim 1)."""
    if normalize == "pred":
        return _normalize_cm(confusion_matrix, 0)
    elif normalize == "true":
        return _normalize_cm(confusion_matrix, 1)
    elif normalize == "all":
        return _normalize_cm(confusion_matrix, None)
    return confusion_matrix


def _normalize_cm(cm: torch.Tensor, axis: Optional[int]) -> torch.Tensor:
    cm = cm.to(torch.float32)
    if axis is None:
        return cm / torch.sum(cm)
    # eps-clamped like torch.nn.functional.normalize (zero rows/cols -> 0)
    return cm / torch.clamp_min(torch.sum(cm, dim=axis, keepdim=True), 1e-12)


def _confusion_matrix_param_check(
    num_classes: int, normalize: Optional[str]
) -> None:
    if num_classes < 2:
        raise ValueError("Must be at least two classes for confusion matrix")
    if (normalize is not None) and (normalize not in ["all", "pred", "true", "none"]):
        raise ValueError("normalize must be one of 'all', 'pred', 'true', or 'none'.")


def _confusion_matrix_update_input_check(
    input: torch.Tensor, target: torch.Tensor, num_classes: Optional[int]
) -> None:
    if input.shape[0] != target.shape[0]:
        raise ValueError(
            "The `input` and `target` should have the same first dimension, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if target.dim() != 1:
        raise ValueError(
            f"target should be a one-dimensional tensor, got shape {tuple(target.shape)}."
        )
    if not input.dim() == 1:
        if not (input.dim() == 2 and (input.shape[1] == num_classes)):
            raise ValueError(
                "input should have shape of (num_sample,) or (num_sample, num_classes), "
                f"got {tuple(input.shape)}."
            )
    # Range checks, every bound in one read back, input first.
    if not value_checks_enabled() or target.numel() == 0:
        return
    if _telemetry.ANNOTATE:
        with _telemetry.span("check.confusion_matrix"):
            return _check_class_ranges(input, target, num_classes)
    _check_class_ranges(input, target, num_classes)


def _check_class_ranges(input: torch.Tensor, target: torch.Tensor, num_classes: int) -> None:
    to_check = [("input", input)] if input.dim() == 1 else []
    to_check.append(("target", target))
    names = [name for name, _ in to_check]
    value_check(
        "confusion_matrix",
        partial(_judge_class_ranges, names, num_classes),
        *(v for _, v in to_check),
    )


def _judge_class_ranges(names: List[str], num_classes: int, vals: np.ndarray) -> None:
    for i, name in enumerate(names):
        lo, hi = vals[2 * i], vals[2 * i + 1]
        if name == "input":
            if hi >= num_classes:
                raise ValueError(
                    "Got `input` prediction class which is too large for the number of classes, "
                    f"num_classes: {num_classes} must be strictly greater than max "
                    f"class predicted: {int(hi)}."
                )
            if lo < 0:
                raise ValueError(
                    f"Got negative `input` prediction class {int(lo)}."
                )
        else:
            if hi >= num_classes:
                raise ValueError(
                    "Got `target` class which is larger than the number of classes, "
                    f"num_classes: {num_classes} must be strictly greater than max "
                    f"target: {int(hi)}."
                )
            if lo < 0:
                raise ValueError(f"Got negative `target` class {int(lo)}.")


def _binary_confusion_matrix_input_check(input: torch.Tensor, target: torch.Tensor) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same dimensions, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if target.dim() != 1:
        raise ValueError(
            f"target should be a one-dimensional tensor, got shape {tuple(target.shape)}."
        )
