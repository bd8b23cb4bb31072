"""AUPRC (average precision) — the port of
``torcheval_tpu/metrics/functional/classification/auprc.py``.

Step-sum average precision (``sklearn.metrics.average_precision_score``)

    AP = Σ_groups (R_g − R_{g−1}) · P_g

at tie-group ends of the descending score sort; multi-task via a leading
dim like ``binary_auroc``.  Two exact routes, chosen from the data alone:

* the sort-free rank-histogram route (:mod:`torcheval_tpu_torch.ops.ustat`)
  when one side of each row is rare enough that its packed table is small
  (the 1000-class headline data: cap 256, one ``rank_hist_counts`` launch);
* otherwise the stable sort + tie scan (``sorted_tie_cumsums``) in plain
  PyTorch.

The JAX routes' ``N < 2^24`` gate (the TPU histogram's f32 per-bin sums)
is dropped: the port counts in int32, and ``cap·N < 2^29`` binds first.
"""

from typing import Optional

import torch

from torcheval_tpu_torch.metrics.functional._host_checks import place_inputs
from torcheval_tpu_torch.metrics.functional.classification._sort_scan import (
    class_hits,
    sorted_tie_cumsums,
)
from torcheval_tpu_torch.metrics.functional.classification.auroc import (
    _binary_auroc_update_input_check,
    _group_end_values,
    _multiclass_auroc_update_input_check,
    _ustat_cap_check,
)
from torcheval_tpu_torch.metrics.functional.classification.precision_recall_curve import (
    _multilabel_precision_recall_curve_update_input_check as _multilabel_auprc_update_input_check,  # noqa: E501  (same shape contract)
)
from torcheval_tpu_torch.ops._flags import ustat_disabled
from torcheval_tpu_torch.ops.ustat import (
    binary_auprc_ustat,
    binary_ustat_route,
    multiclass_auprc_ustat,
    ustat_route_cap,
)


def binary_auprc(input, target, *, num_tasks: int = 1) -> torch.Tensor:
    """Average precision for binary classification; multi-task via a
    ``(num_tasks, n)`` leading dim.  Rows with no positive labels (or no
    samples) yield 0; sklearn returns NaN with a warning there."""
    input, target = place_inputs(input, target)
    _binary_auroc_update_input_check(input, target, num_tasks)
    if input.shape[-1] == 0:
        return torch.zeros(input.shape[:-1], device=input.device)
    return _binary_auprc_compute(input, target)


def _binary_auprc_compute(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    # Rare-positive route: step-sum AP against the packed positive table
    # instead of a row sort (AP is anchored on the positives, so only
    # that side packs).
    squeeze = input.dim() == 1
    rows = input[None] if squeeze else input
    t_rows = target[None] if squeeze else target
    route = binary_ustat_route(rows, t_rows, need_pos=True)
    if route is not None:
        _, cap = route
        ap = binary_auprc_ustat(rows, t_rows.to(torch.int32), cap=cap)
        return ap[0] if squeeze else ap
    return _binary_auprc_compute_kernel(input, target)


def multiclass_auprc(
    input,
    target,
    *,
    num_classes: int,
    average: Optional[str] = "macro",
    ustat_cap: Optional[int] = None,
) -> torch.Tensor:
    """One-vs-rest average precision with macro/None averaging.

    Classes absent from ``target`` contribute 0 to the macro mean; sklearn
    yields NaN with a warning for such classes.

    ``ustat_cap`` pins the rank-histogram route's table capacity, as
    ``multiclass_auroc``'s does (see its docstring)."""
    _multiclass_auprc_param_check(num_classes, average)
    input, target = place_inputs(input, target)
    _multiclass_auroc_update_input_check(input, target, num_classes)
    if input.shape[0] == 0:
        return (
            torch.zeros((), device=input.device)
            if average == "macro"
            else torch.zeros(num_classes, device=input.device)
        )
    if ustat_cap is not None:
        _ustat_cap_check(input, target, num_classes, ustat_cap)
    return _multiclass_auprc_compute(
        input, target, num_classes, average, ustat_cap=ustat_cap
    )


def _multiclass_auprc_compute(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    average: Optional[str],
    ustat_cap: Optional[int] = None,
) -> torch.Tensor:
    # Sort-free rank-histogram route: sparse one-vs-rest positives make
    # step-sum AP a per-entry count against a small packed table instead
    # of a (C, N) sort.  Decided per call from the data unless ustat_cap
    # pins it; with the route switch set a pinned cap runs the sort path.
    if ustat_cap is None:
        ustat_cap = ustat_route_cap(input, target, num_classes)
    elif ustat_disabled():
        ustat_cap = None
    if ustat_cap is not None:
        return multiclass_auprc_ustat(
            input, target, num_classes=num_classes, average=average, cap=ustat_cap
        )
    return _multiclass_auprc_compute_kernel(input, target, num_classes, average)


def multilabel_auprc(
    input,
    target,
    *,
    num_labels: Optional[int] = None,
    average: Optional[str] = "macro",
) -> torch.Tensor:
    """Per-label average precision over a ``(n, num_labels)`` 0/1 target
    matrix, macro-averaged by default; each label column is an independent
    binary AP."""
    _multilabel_auprc_param_check(num_labels, average)
    input, target = place_inputs(input, target)
    if num_labels is None:
        num_labels = input.shape[1] if input.dim() == 2 else None
    _multilabel_auprc_update_input_check(input, target, num_labels)
    if input.shape[0] == 0:
        return (
            torch.zeros((), device=input.device)
            if average == "macro"
            else torch.zeros(num_labels, device=input.device)
        )
    return _multilabel_auprc_compute(input, target, average)


def _multilabel_auprc_compute_kernel(
    input: torch.Tensor, target: torch.Tensor, average: Optional[str]
) -> torch.Tensor:
    ap = _auprc_rows(input.T, (target == 1).T)
    return ap.mean() if average == "macro" else ap


def _multilabel_auprc_compute(
    input: torch.Tensor, target: torch.Tensor, average: Optional[str]
) -> torch.Tensor:
    # Label columns are usually sparse: the rare-positive regime.  The
    # per-label rows ARE the binary (R, N) case on transposed inputs.
    ap = _binary_auprc_compute(input.T, target.T)
    return ap.mean() if average == "macro" else ap


def _multilabel_auprc_param_check(
    num_labels: Optional[int], average: Optional[str]
) -> None:
    average_options = ("macro", "none", None)
    if average not in average_options:
        raise ValueError(
            f"`average` was not in the allowed value of {average_options}, "
            f"got {average}."
        )
    if num_labels is not None and num_labels < 2:
        raise ValueError("`num_labels` has to be at least 2.")


def _auprc_rows(scores: torch.Tensor, hits: torch.Tensor) -> torch.Tensor:
    """Row-wise AP over ``(R, N)`` scores/hits.  Every element of a tie
    group shares the group-end precision, so AP sums each sorted hit
    weighted by its group-end precision."""
    _, is_last, cum_tp, cum_fp = sorted_tie_cumsums(scores, hits)
    tp_end = _group_end_values(cum_tp, is_last).to(torch.float32)
    fp_end = _group_end_values(cum_fp, is_last).to(torch.float32)
    precision = tp_end / torch.clamp(tp_end + fp_end, min=1.0)
    sorted_hits = torch.diff(
        cum_tp, dim=-1, prepend=torch.zeros_like(cum_tp[..., :1])
    ).to(torch.float32)
    num_pos = cum_tp[..., -1].to(torch.float32)
    ap = (sorted_hits * precision).sum(dim=-1) / torch.clamp(num_pos, min=1.0)
    return torch.where(num_pos == 0, 0.0, ap)


def _binary_auprc_compute_kernel(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    squeeze = input.dim() == 1
    if squeeze:
        input, target = input[None], target[None]
    ap = _auprc_rows(input, target == 1)
    return ap[0] if squeeze else ap


def _multiclass_auprc_compute_kernel(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: int,
    average: Optional[str],
) -> torch.Tensor:
    ap = _auprc_rows(input.T, class_hits(target, num_classes))
    return ap.mean() if average == "macro" else ap


def _multiclass_auprc_param_check(num_classes: int, average: Optional[str]) -> None:
    average_options = ("macro", "none", None)
    if average not in average_options:
        raise ValueError(
            f"`average` was not in the allowed value of {average_options}, "
            f"got {average}."
        )
    if num_classes < 2:
        raise ValueError("`num_classes` has to be at least 2.")
