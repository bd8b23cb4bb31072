"""Rank-sketch states of the exact-rank curve metrics (the port of
``torcheval_tpu/metrics/_rank_state.py``).

``BinaryAUROC`` / ``BinaryAUPRC`` / ``MulticlassAUROC`` built with
``sketch=True`` (or under ``TORCHEVAL_TPU_TORCH_RANK_SKETCH=1``) swap their
sample buffers for the fixed-size rank sketch of
:mod:`torcheval_tpu_torch.ops.rank_sketch`: a ``threshold`` edge vector and
four int32 count arrays over ``(rows, bins)``, the binned-AUC family's
state names and shapes, so a binary member folds into the collection
kernel's ``"binned"`` kind (``csrc/mega.cu``).  An update is one
:func:`~torcheval_tpu_torch.metrics._fuse.accumulate` (on the card one
``binned_count.cu`` launch, then four adds); a merge is integer addition,
the same in every order; compute is the binned trapezoid / step sum
within ``rank_error_bound(bins)``.

This module holds what the metric files share: the update kernels, state
installation, the accumulate, the geometry-checked merge and the
``"rank"`` payload.  The classes stay in their own files and branch on
``self._sketch_mode``.
"""

from typing import Iterable, Optional, Tuple

import torch

from torcheval_tpu_torch.metrics._fuse import accumulate
from torcheval_tpu_torch.metrics._merge import merge_add
from torcheval_tpu_torch.metrics.functional.classification._sort_scan import class_hits
from torcheval_tpu_torch.ops.rank_sketch import (
    DEFAULT_BINS,
    rank_counts_rows,
    rank_error_bound,
    uniform_edges,
)

RANK_COUNTS = ("num_tp", "num_fp", "num_pos", "num_total")

Counts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

# Process-level census of sketch-mode constructions: how many members, at
# which bin counts (the JAX package's telemetry reads it beside the
# collection kernel's verdict).
_CENSUS: dict = {"constructed": 0, "bins": {}}


def sketch_census() -> dict:
    """How many sketch-mode members this process built, at which bin
    counts, and the worst documented rank error among them; an empty dict
    when none was built."""
    if not _CENSUS["constructed"]:
        return {}
    return {
        "members_constructed": _CENSUS["constructed"],
        "bins": dict(sorted(_CENSUS["bins"].items())),
        "predicted_eps_max": max(rank_error_bound(b) for b in _CENSUS["bins"]),
    }


def _rank_binary_kernel(
    input: torch.Tensor,
    target: torch.Tensor,
    threshold: torch.Tensor,
    mask=None,
) -> Counts:
    if input.dim() == 1:
        input, target = input[None], target[None]
    return rank_counts_rows(input, target == 1, threshold, mask=mask)


def _rank_multiclass_kernel(
    input: torch.Tensor,
    target: torch.Tensor,
    threshold: torch.Tensor,
    num_classes: int,
    mask=None,
) -> Counts:
    # One-vs-rest rows: the (N, C) scores read as a (C, N) view in place,
    # beside the (C, N) class hits.
    return rank_counts_rows(
        input.T, class_hits(target, num_classes), threshold, mask=mask
    )


def install_rank_states(metric, num_rows: int, bins: Optional[int]) -> None:
    """Install the sketch-mode states on ``metric``: ``threshold`` (the
    ``bins`` uniform edges) and the four zeroed int32 count arrays, and
    mark it mask-aware (a sketch update folds ``mask=`` exactly, so sketch
    members join ``bucket=`` / ``slices=`` collections)."""
    bins = DEFAULT_BINS if bins is None else int(bins)
    threshold = uniform_edges(bins)
    _CENSUS["constructed"] += 1
    _CENSUS["bins"][bins] = _CENSUS["bins"].get(bins, 0) + 1
    metric._sketch_bins = bins
    metric._supports_mask = True
    metric._fixed_states = ("threshold",)
    metric._add_state("threshold", threshold)
    metric._add_state("num_tp", torch.zeros((num_rows, bins), dtype=torch.int32))
    metric._add_state("num_fp", torch.zeros((num_rows, bins), dtype=torch.int32))
    metric._add_state("num_pos", torch.zeros(num_rows, dtype=torch.int32))
    metric._add_state("num_total", torch.zeros(num_rows, dtype=torch.int32))


def rank_accumulate(metric, kernel, input, target, statics=(), mask=None) -> None:
    """One update: the kernel's counts added into the four states."""
    metric.num_tp, metric.num_fp, metric.num_pos, metric.num_total = accumulate(
        kernel,
        (metric.num_tp, metric.num_fp, metric.num_pos, metric.num_total),
        input,
        target,
        metric.threshold,
        statics=statics,
        mask=mask,
    )


def rank_merge_state(metric, metrics: Iterable) -> None:
    """Integer-add merge after a geometry check: every operand must be a
    sketch-mode metric over the same edge vector.  Addition is associative
    and exact, so every merge order gives the same counts."""
    metrics = list(metrics)
    for m in metrics:
        if not getattr(m, "_sketch_mode", False):
            raise ValueError(
                "cannot merge a sketch-mode metric with a sample-buffer "
                f"metric ({type(m).__name__} constructed without sketch=True)"
            )
        if m.threshold.shape != metric.threshold.shape:
            raise ValueError(
                "sketch merge requires identical edge geometry: "
                f"{m.threshold.shape[0]} bins vs {metric.threshold.shape[0]}"
            )
    merge_add(metric, metrics, *RANK_COUNTS)


def rank_sketch_state(metric, metric_kind: str, kind: str, **options):
    """``Metric.sketch_state`` of a sketch-mode metric: its counts are the
    mergeable summary, so ``"rank"`` (and ``"exact"``, lossless here: no
    buffer is more exact than the counts) wrap them in a
    :class:`~torcheval_tpu_torch.metrics._sketch.RankSketch` of numpy
    arrays; no other kind applies."""
    from torcheval_tpu_torch.metrics._sketch import RankSketch

    if kind not in ("rank", "exact"):
        raise ValueError(
            f"sketch-mode {type(metric).__name__} supports only "
            f"kind='rank' (its state is already a rank sketch); got {kind!r}"
        )
    if options:
        raise ValueError(
            f"kind='rank' on a sketch-mode metric takes no options; "
            f"got {sorted(options)} (bins are fixed at construction)"
        )
    return RankSketch(
        metric_kind=metric_kind,
        edges=metric.threshold.cpu().numpy(),
        num_tp=metric.num_tp.cpu().numpy(),
        num_fp=metric.num_fp.cpu().numpy(),
        num_pos=metric.num_pos.cpu().numpy(),
        num_total=metric.num_total.cpu().numpy(),
        average=getattr(metric, "average", None),
        device=metric.device,
    )


def predicted_epsilon(metric) -> float:
    """The documented rank-error bound of one sketch-mode metric."""
    return rank_error_bound(metric._sketch_bins)
