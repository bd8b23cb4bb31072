"""AUROC — the port of
``torcheval_tpu/metrics/functional/classification/auroc.py`` (parity with
the reference ``torcheval/metrics/functional/classification/auroc.py``).

Two exact routes, chosen from the data alone:

* the sort-free rank-sum route (:mod:`torcheval_tpu_torch.ops.ustat`)
  when one class per row is rare enough that its packed table is small
  (the 1000-class headline: cap 256);
* otherwise a stable sort plus the exact tie-aware AUC scan
  (:func:`torcheval_tpu_torch.ops.auc.binary_auroc_sorted_path`).

Each route runs its CUDA kernel for tensors on the GPU and the kernel's
plain version for tensors on the CPU, so the CPU takes the route the GPU
takes.  ``use_fused`` opts into the approximate fused AUC
(:mod:`torcheval_tpu_torch.ops.fused_auc`), the fbgemm analog.
"""

from typing import Optional

import torch

from torcheval_tpu_torch.metrics.functional._host_checks import place_inputs
from torcheval_tpu_torch.metrics.functional.classification._sort_scan import (
    class_hits,
)
from torcheval_tpu_torch.ops._flags import ustat_disabled
from torcheval_tpu_torch.ops.auc import binary_auroc_sorted_path
from torcheval_tpu_torch.ops.fused_auc import fused_auc
from torcheval_tpu_torch.ops.ustat import (
    _BIG,
    _route_stats,
    binary_auroc_ustat,
    binary_ustat_route,
    multiclass_auroc_ustat,
    ustat_route_cap,
)
from torcheval_tpu_torch.telemetry import events as _telemetry


def binary_auroc(
    input,
    target,
    *,
    num_tasks: int = 1,
    use_fused: Optional[bool] = False,
) -> torch.Tensor:
    """Area under the ROC curve for binary classification, multi-task via a
    leading dim (reference ``auroc.py:17-62``).  Runs where ``input``
    lives; numpy input goes to the GPU."""
    input, target = place_inputs(input, target)
    _binary_auroc_update_input_check(input, target, num_tasks)
    return _binary_auroc_compute(input, target, use_fused)


def multiclass_auroc(
    input,
    target,
    *,
    num_classes: int,
    average: Optional[str] = "macro",
    ustat_cap: Optional[int] = None,
) -> torch.Tensor:
    """One-vs-rest AUROC per class, macro-averaged by default (reference
    ``auroc.py:65-103``).

    ``ustat_cap`` pins the rank-sum route's table capacity (≥ the largest
    per-class count, a multiple of 16) instead of deciding it from the
    data; leave it ``None`` to let the route decide.  A pinned cap is
    checked against the data unless value checks are skipped, in which
    case targets in ``[0, C)``, |score| < 3e38 and the capacity are the
    caller's contract."""
    _multiclass_auroc_param_check(num_classes, average)
    input, target = place_inputs(input, target)
    _multiclass_auroc_update_input_check(input, target, num_classes)
    if ustat_cap is not None:
        _ustat_cap_check(input, target, num_classes, ustat_cap)
    return _multiclass_auroc_compute(
        input, target, num_classes, average, ustat_cap=ustat_cap
    )


def _ustat_cap_check(
    input: torch.Tensor, target: torch.Tensor, num_classes: int, cap: int
) -> None:
    """Validate a user-pinned rank-sum table capacity.  An undersized cap
    would silently DROP the overflowing class's largest scores, so it is
    checked against the measured per-class maximum (one read back),
    unless value checks are skipped."""
    from torcheval_tpu_torch.metrics.functional._host_checks import (
        value_checks_enabled,
    )

    if cap % 16 != 0 or cap < 16:
        raise ValueError(f"ustat_cap must be a positive multiple of 16, got {cap}.")
    if cap * input.shape[0] >= 2**29:
        raise ValueError(
            f"ustat_cap·N = {cap * input.shape[0]} exceeds the exact-int32 "
            "bound 2^29; leave ustat_cap=None for this shape."
        )
    if not value_checks_enabled() or input.numel() == 0:
        return
    lo, hi, max_count, in_range = _route_stats(input, target, num_classes)
    if not in_range:
        raise ValueError(
            f"target values should be in [0, {num_classes}) for the pinned "
            "rank-sum route; leave ustat_cap=None for such inputs."
        )
    if max_count > cap:
        raise ValueError(
            f"ustat_cap={cap} but one class has {int(max_count)} samples; "
            "raise the cap (or leave it None to self-decide)."
        )
    if not (-_BIG < lo and hi < _BIG):
        raise ValueError(
            "the rank-sum formulation requires scores with |score| < 3e38 "
            "(its pad sentinel); leave ustat_cap=None for such inputs."
        )


def _binary_auroc_compute(
    input: torch.Tensor,
    target: torch.Tensor,
    use_fused: Optional[bool] = False,
) -> torch.Tensor:
    if input.shape[-1] == 0:
        # Degenerate (no samples) → 0.5, the convention for a task with no
        # positives or no negatives.
        return torch.full(input.shape[:-1], 0.5, device=input.device)
    if use_fused:
        return fused_auc(input, target)
    # Rank-sum route for rows whose positives or negatives are rare.
    squeeze = input.dim() == 1
    rows = input[None] if squeeze else input
    t_rows = target[None] if squeeze else target
    if _telemetry.ANNOTATE:
        with _telemetry.span("compute.route"):
            ustat_route = binary_ustat_route(rows, t_rows)
    else:
        ustat_route = binary_ustat_route(rows, t_rows)
    if ustat_route is not None:
        side, cap = ustat_route
        auc = binary_auroc_ustat(rows, t_rows.to(torch.int32), cap=cap, table_side=side)
        return auc[0] if squeeze else auc
    return binary_auroc_sorted_path(input, target)


def _multiclass_auroc_compute(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    average: Optional[str] = "macro",
    ustat_cap: Optional[int] = None,
) -> torch.Tensor:
    if input.shape[0] == 0:
        # Degenerate (no samples) → 0.5 per class.
        degenerate = torch.full((num_classes,), 0.5, device=input.device)
        return degenerate.mean() if average == "macro" else degenerate
    # Sort-free rank-sum route: one-vs-rest positives are sparse, so exact
    # AUROC is a pair count against a small per-class table instead of a
    # (C, N) sort.  Decided per call from the data unless ustat_cap pins it.
    # A pinned cap asserts the data preconditions only: with the route
    # switch set it still runs, on the sort path.  The JAX package's
    # backend and Pallas gates have no counterpart, since the port's route
    # never depends on the device.
    if ustat_cap is None:
        if _telemetry.ANNOTATE:
            with _telemetry.span("compute.route"):
                ustat_cap = ustat_route_cap(input, target, num_classes)
        else:
            ustat_cap = ustat_route_cap(input, target, num_classes)
    elif ustat_disabled():
        ustat_cap = None
    if ustat_cap is not None:
        return multiclass_auroc_ustat(
            input, target, num_classes=num_classes, average=average, cap=ustat_cap
        )
    return _multiclass_auroc_sorted(input, target, num_classes, average)


def _multiclass_auroc_sorted(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    average: Optional[str],
) -> torch.Tensor:
    """One-vs-rest AUROC through the sort path — one (C, N) multi-task
    call of the shared sort + AUC scan (the counterpart of
    ``_multiclass_auroc_pallas_kernel``)."""
    aurocs = binary_auroc_sorted_path(input.T, class_hits(target, num_classes))
    return aurocs.mean() if average == "macro" else aurocs


def _group_end_values(values: torch.Tensor, is_last: torch.Tensor) -> torch.Tensor:
    """Replace each position by ``values`` at the end of its tie group.
    ``values`` must be nondecreasing along the last axis; ``is_last`` flags
    the last element of each tie group (a reverse running minimum over a
    sentinel-masked copy)."""
    sentinel = values.shape[-1] + 1
    masked = torch.where(is_last, values, torch.full_like(values, sentinel))
    return torch.cummin(masked.flip(-1), dim=-1).values.flip(-1)


def _binary_auroc_update_input_check(
    input: torch.Tensor,
    target: torch.Tensor,
    num_tasks: int,
) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same shape, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
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


def _multiclass_auroc_param_check(
    num_classes: int,
    average: Optional[str],
) -> None:
    average_options = ("macro", "none", None)
    if average not in average_options:
        raise ValueError(
            f"`average` was not in the allowed value of {average_options}, got {average}."
        )
    if num_classes < 2:
        raise ValueError("`num_classes` has to be at least 2.")


def _multiclass_auroc_update_input_check(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
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
    if not (input.dim() == 2 and input.shape[1] == num_classes):
        raise ValueError(
            "input should have shape of (num_sample, num_classes), "
            f"got {tuple(input.shape)} and num_classes={num_classes}."
        )
