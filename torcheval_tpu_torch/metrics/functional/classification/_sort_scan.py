"""Shared descending-sort + tie-group-mask + cumulative-count core used by
the threshold-curve code (the port of
``torcheval_tpu/metrics/functional/classification/_sort_scan.py``).

The JAX package sorts with a variadic ``lax.sort`` that carries the hits
as a payload; here a stable ``torch.sort`` of the negated scores gives the
descending order, and the hits follow through the sort's indices.  The
cumulative counts are int32, the JAX dtype (torch's default would be
int64).
"""

from typing import Tuple

import torch


def sort_desc(scores: torch.Tensor, hits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise stable sort by descending score.  Returns the sorted
    scores and the boolean hits in the same order, both ``scores.shape``.
    Sorting ``-scores`` ascending keeps equal scores in input order.  The
    negation writes a row-contiguous buffer (one pass, also for the
    transposed (N, C) score buffer), so the sort and the AUC scan after it
    read contiguous rows and copy nothing."""
    neg = torch.empty_like(scores, memory_format=torch.contiguous_format)
    torch.neg(scores, out=neg)
    neg_sorted, order = torch.sort(neg, dim=-1, stable=True)
    return -neg_sorted, torch.gather(hits.to(torch.bool), -1, order)


def sorted_tie_cumsums(
    scores: torch.Tensor, hits: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Row-wise threshold scan over ``(R, N)`` score/hit pairs.

    Returns ``(thresholds, is_last, cum_tp, cum_fp)``, all ``(R, N)``:
    the descending-sorted scores, a flag on the last element of each tie
    group, and the int32 cumulative true/false-positive counts.  ``hits``
    follow the JAX payload cast: nonzero after truncation to int8."""
    thresholds, sorted_hits = sort_desc(scores, hits.to(torch.int8))
    is_last = torch.cat(
        [
            torch.diff(thresholds, dim=-1) != 0,
            torch.ones(
                (*thresholds.shape[:-1], 1), dtype=torch.bool, device=scores.device
            ),
        ],
        dim=-1,
    )
    cum_tp = torch.cumsum(sorted_hits, dim=-1, dtype=torch.int32)
    cum_fp = torch.cumsum(~sorted_hits, dim=-1, dtype=torch.int32)
    return thresholds, is_last, cum_tp, cum_fp


def class_hits(target: torch.Tensor, num_classes: int) -> torch.Tensor:
    """One-vs-rest hit matrix ``(C, N)``: row ``c`` flags ``target == c``."""
    classes = torch.arange(num_classes, device=target.device)
    return target[None, :] == classes[:, None]
