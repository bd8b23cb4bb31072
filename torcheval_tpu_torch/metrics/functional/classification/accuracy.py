"""Accuracy family — the port of
``torcheval_tpu/metrics/functional/classification/accuracy.py`` (parity
with the reference ``torcheval/metrics/functional/classification/
accuracy.py``): ``binary_accuracy``, ``multiclass_accuracy``,
``multilabel_accuracy`` and ``topk_multilabel_accuracy``, with the same
update/compute split (counters mergeable by addition).

Per-class counters scatter with JAX's ``.at[].add`` index semantics
(:func:`~torcheval_tpu_torch.metrics.functional._scatter.at_add`), and
the top-k label score is gathered with JAX's ``take_along_axis``
semantics, so labels that only skipped value checks let through count as
in the JAX package.  As there, the top-k multilabel update honors ``k``
where the reference hardcodes ``topk(k=2)`` (reference
``accuracy.py:393-395``).
"""

from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.metrics.functional._host_checks import (
    check_index_ranges,
    place_inputs,
)
from torcheval_tpu_torch.metrics.functional._scatter import at_add

# ---------------------------------------------------------------- public API


def binary_accuracy(
    input,
    target,
    *,
    threshold: float = 0.5,
) -> torch.Tensor:
    """Frequency of thresholded ``input`` matching ``target``
    (reference ``accuracy.py:13-45``); both of shape ``(n_samples,)``."""
    input, target = place_inputs(input, target)
    num_correct, num_total = _binary_accuracy_update(input, target, threshold)
    return _accuracy_compute(num_correct, num_total, "micro")


def multiclass_accuracy(
    input,
    target,
    *,
    average: Optional[str] = "micro",
    num_classes: Optional[int] = None,
    k: int = 1,
) -> torch.Tensor:
    """Multiclass accuracy with micro/macro/None averaging and top-k
    support (reference ``accuracy.py:48-103``).  ``input`` is predicted
    labels ``(n,)`` or scores ``(n, C)``; for ``k > 1`` a sample counts as
    correct when fewer than ``k`` classes outscore the target class.
    ``macro`` ignores classes with no true instances; ``None`` returns
    per-class accuracy with NaN for unseen classes."""
    _accuracy_param_check(average, num_classes, k)
    input, target = place_inputs(input, target)
    num_correct, num_total = _multiclass_accuracy_update(
        input, target, average, num_classes, k
    )
    return _accuracy_compute(num_correct, num_total, average)


def multilabel_accuracy(
    input,
    target,
    *,
    threshold: float = 0.5,
    criteria: str = "exact_match",
) -> torch.Tensor:
    """Multilabel accuracy under ``exact_match``, ``hamming``,
    ``overlap``, ``contain`` or ``belong`` (reference
    ``accuracy.py:106-173``)."""
    _multilabel_accuracy_param_check(criteria)
    input, target = place_inputs(input, target)
    num_correct, num_total = _multilabel_accuracy_update(
        input, target, threshold, criteria
    )
    return _accuracy_compute(num_correct, num_total, "micro")


def topk_multilabel_accuracy(
    input,
    target,
    *,
    criteria: str = "exact_match",
    k: int = 2,
) -> torch.Tensor:
    """Multilabel accuracy of the top-k predicted label set (reference
    ``accuracy.py:176-243``, with ``k`` honored)."""
    _topk_multilabel_accuracy_param_check(criteria, k)
    input, target = place_inputs(input, target)
    num_correct, num_total = _topk_multilabel_accuracy_update(
        input, target, criteria, k
    )
    return _accuracy_compute(num_correct, num_total, "micro")


# ------------------------------------------------------------------- kernels


def _label_scores(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """``input[i, target[i]]`` as JAX's ``take_along_axis`` gathers it: a
    negative label wraps once, one still out of range reads NaN."""
    c = input.shape[-1]
    idx = target.to(torch.int64)
    idx = torch.where(idx < 0, idx + c, idx)
    valid = (idx >= 0) & (idx < c)
    got = torch.gather(input, 1, torch.where(valid, idx, 0)[:, None])[:, 0]
    return torch.where(valid, got, torch.nan)


def _multiclass_accuracy_update_kernel(
    input: torch.Tensor,
    target: torch.Tensor,
    average: Optional[str],
    num_classes: Optional[int],
    k: int,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if k == 1:
        if input.dim() == 2:
            input = torch.argmax(input, dim=1)
        correct = (input == target).to(torch.int32)
    else:
        y_score = _label_scores(input, target)
        rank = torch.sum(input > y_score[:, None], dim=-1)
        correct = (rank < k).to(torch.float32)

    if mask is not None:
        # Padded rows add exact zeros to the numerator and to every total.
        correct = correct * mask.to(correct.dtype)
    if average == "micro":
        total = (
            torch.tensor(target.shape[0], dtype=torch.int32, device=target.device)
            if mask is None
            else mask.to(torch.int32).sum(dtype=torch.int32)
        )
        return correct.sum(dtype=correct.dtype), total

    num_correct = at_add(num_classes, target, correct)
    ones = (
        torch.ones_like(target, dtype=torch.int32)
        if mask is None
        else mask.to(torch.int32)
    )
    num_total = at_add(num_classes, target, ones)
    return num_correct, num_total


def _multiclass_accuracy_validate(
    input: torch.Tensor,
    target: torch.Tensor,
    average: Optional[str],
    num_classes: Optional[int],
    k: int,
) -> None:
    """Update validation shared by the functional and class paths."""
    _accuracy_update_input_check(input, target, num_classes, k)
    # Where target is an index (per-class scatter for average != "micro",
    # gather for k > 1), an out-of-range value must raise.
    if average != "micro" or k > 1:
        upper = num_classes if num_classes is not None else input.shape[-1]
        check_index_ranges([(target, "target")], upper)


def _multiclass_accuracy_update(
    input: torch.Tensor,
    target: torch.Tensor,
    average: Optional[str],
    num_classes: Optional[int],
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    _multiclass_accuracy_validate(input, target, average, num_classes, k)
    return _multiclass_accuracy_update_kernel(input, target, average, num_classes, k)


def _accuracy_compute(
    num_correct: torch.Tensor,
    num_total: torch.Tensor,
    average: Optional[str],
) -> torch.Tensor:
    if average == "macro":
        # Mean over classes with true instances (reference masks with
        # boolean indexing, ``accuracy.py:283-285``).
        ratio = torch.where(num_total != 0, num_correct / num_total, torch.nan)
        return torch.nanmean(ratio)
    return num_correct / num_total


def _binary_accuracy_update_kernel(
    input: torch.Tensor,
    target: torch.Tensor,
    threshold: float,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    pred = torch.where(input < threshold, 0, 1)
    correct = (pred == target).to(torch.int32)
    if mask is None:
        n = torch.tensor(target.shape[0], dtype=torch.int32, device=target.device)
        return correct.sum(dtype=torch.int32), n
    m = mask.to(torch.int32)
    return (correct * m).sum(dtype=torch.int32), m.sum(dtype=torch.int32)


def _binary_accuracy_update(
    input: torch.Tensor, target: torch.Tensor, threshold: float = 0.5
) -> Tuple[torch.Tensor, torch.Tensor]:
    _binary_accuracy_update_input_check(input, target)
    return _binary_accuracy_update_kernel(input, target, threshold)


def _multilabel_update(
    input: torch.Tensor,
    target: torch.Tensor,
    criteria: str = "exact_match",
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shared top of the multilabel criteria lattice (reference
    ``accuracy.py:399-432``).  ``mask`` zeroes padded rows' contribution
    to both counters (hamming counts elements, so its total is
    ``mask.sum() * num_labels``)."""
    if mask is None:
        per_row = torch.ones(target.shape[0], dtype=torch.int32, device=target.device)
        n = torch.tensor(target.shape[0], dtype=torch.int32, device=target.device)
    else:
        per_row = mask.to(torch.int32)
        n = per_row.sum(dtype=torch.int32)

    def count(rows: torch.Tensor) -> torch.Tensor:
        return (rows * per_row).sum(dtype=torch.int32)

    if criteria == "exact_match":
        return count(torch.all(input == target, dim=1)), n
    if criteria == "hamming":
        eq = (input == target).to(torch.int32)
        return (eq * per_row[:, None]).sum(dtype=torch.int32), n * target.shape[1]
    if criteria == "overlap":
        hit = torch.any((input == target) & (input == 1), dim=1)
        empty = torch.all((input == 0) & (target == 0), dim=1)
        return count(hit) + count(empty), n
    if criteria == "contain":
        return count(torch.all((input - target) >= 0, dim=1)), n
    # belong
    return count(torch.all((input - target) <= 0, dim=1)), n


def _multilabel_accuracy_update_kernel(
    input: torch.Tensor,
    target: torch.Tensor,
    threshold: float,
    criteria: str,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    input_label = torch.where(input < threshold, 0, 1)
    return _multilabel_update(input_label, target, criteria, mask=mask)


def _multilabel_accuracy_update(
    input: torch.Tensor,
    target: torch.Tensor,
    threshold: float = 0.5,
    criteria: str = "exact_match",
) -> Tuple[torch.Tensor, torch.Tensor]:
    _multilabel_accuracy_update_input_check(input, target)
    return _multilabel_accuracy_update_kernel(input, target, threshold, criteria)


def _topk_multilabel_accuracy_update_kernel(
    input: torch.Tensor,
    target: torch.Tensor,
    criteria: str,
    k: int,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    # A stable descending sort keeps the lower index first among ties, as
    # jax.lax.top_k does (torch.topk promises no order among ties).
    topk_idx = torch.argsort(input, dim=1, descending=True, stable=True)[:, :k]
    input_label = torch.zeros(input.shape, dtype=torch.float32, device=input.device)
    input_label.scatter_(1, topk_idx, 1.0)
    return _multilabel_update(input_label, target, criteria, mask=mask)


def _topk_multilabel_accuracy_update(
    input: torch.Tensor,
    target: torch.Tensor,
    criteria: str = "exact_match",
    k: int = 2,
) -> Tuple[torch.Tensor, torch.Tensor]:
    _topk_multilabel_accuracy_update_input_check(input, target, k)
    return _topk_multilabel_accuracy_update_kernel(input, target, criteria, k)


# ------------------------------------------------------------------- checks


def _accuracy_param_check(
    average: Optional[str],
    num_classes: Optional[int],
    k: int,
) -> None:
    average_options = ("micro", "macro", "none", None)
    if average not in average_options:
        raise ValueError(
            f"`average` was not in the allowed value of {average_options}, got {average}."
        )
    if average != "micro" and (num_classes is None or num_classes <= 0):
        raise ValueError(
            f"num_classes should be a positive number when average={average}."
            f" Got num_classes={num_classes}."
        )
    if type(k) is not int:
        raise TypeError(f"Expected `k` to be an integer, but {type(k)} was provided.")
    if k < 1:
        raise ValueError(
            f"Expected `k` to be an integer greater than 0, but {k} was provided."
        )


def _accuracy_update_input_check(
    input: torch.Tensor,
    target: torch.Tensor,
    num_classes: Optional[int],
    k: int,
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
    if k > 1 and input.dim() != 2:
        raise ValueError(
            "input should have shape (num_sample, num_classes) for k > 1, "
            f"got shape {tuple(input.shape)}."
        )
    if not input.dim() == 1 and not (
        input.dim() == 2 and (num_classes is None or input.shape[1] == num_classes)
    ):
        raise ValueError(
            "input should have shape of (num_sample,) or (num_sample, num_classes), "
            f"got {tuple(input.shape)}."
        )


def _binary_accuracy_update_input_check(
    input: torch.Tensor,
    target: torch.Tensor,
) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same dimensions, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if target.dim() != 1:
        raise ValueError(
            f"target should be a one-dimensional tensor, got shape {tuple(target.shape)}."
        )


def _multilabel_accuracy_param_check(criteria: str) -> None:
    criteria_options = ("exact_match", "hamming", "overlap", "contain", "belong")
    if criteria not in criteria_options:
        raise ValueError(
            f"`criteria` was not in the allowed value of {criteria_options}, got {criteria}."
        )


def _topk_multilabel_accuracy_param_check(criteria: str, k: int) -> None:
    _multilabel_accuracy_param_check(criteria)
    if type(k) is not int:
        raise TypeError(f"Expected `k` to be an integer, but {type(k)} was provided.")
    if k == 1:
        raise ValueError(
            f"Expected `k` to be an integer greater than 1, but {k} was provided. "
            "In such case, please use multilabel_accuracy metric."
        )
    if k < 1:
        raise ValueError(
            f"Expected `k` to be an integer greater than 1, but {k} was provided."
        )


def _multilabel_accuracy_update_input_check(
    input: torch.Tensor,
    target: torch.Tensor,
) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same dimensions, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )


def _topk_multilabel_accuracy_update_input_check(
    input: torch.Tensor,
    target: torch.Tensor,
    k: int,
) -> None:
    if input.shape != target.shape:
        raise ValueError(
            "The `input` and `target` should have the same dimensions, "
            f"got shapes {tuple(input.shape)} and {tuple(target.shape)}."
        )
    if input.dim() != 2:
        raise ValueError(
            "input should have shape (num_sample, num_classes) for k > 1, "
            f"got shape {tuple(input.shape)}."
        )
