"""Mergeable sketch states: O(bins) merge payloads for sample-buffer
metrics (the port of ``torcheval_tpu/metrics/_sketch.py``).

A buffer metric (AUROC, AUPRC) carries every sample, so a sync of its
states grows with the stream.  A *sketch* is a fixed-size summary that
**merges by a commutative, associative operation** and whose compute error
is **bounded by the sketch's size alone**.  Five kinds, from
``Metric.sketch_state(kind=...)``:

``"exact"`` — :class:`ExactSketch`
    The whole prepared metric; lossless, payload O(samples).  The only
    kind the base class supports.
``"reservoir"`` — :class:`ReservoirSketch`
    Bottom-k sampling of (score, target) pairs by a seeded uniform key;
    a merge keeps the k smallest keys, the same sample in every merge
    order.  AUROC over the kept sample has standard error
    **O(1/sqrt(capacity))**.
``"histogram"`` — :class:`HistogramSketch`
    Per-class binned score counts over [0, 1]; merge adds.  AUROC / AP
    error **O(1/bins)**.
``"count"`` — :class:`CountSketchState`
    A signed count sketch (depth x width hashed counters) of the binned
    score counts, one sheet per class; a bin's count errs by at most
    **n / sqrt(width)** with probability 1 - 2^-depth.
``"rank"`` — :class:`RankSketch`
    The rank-sketch counts (``ops/rank_sketch.py``): per-edge ``score >=
    edge`` counts over ``(rows, bins)``, merge by integer addition, the
    same bits in every order, rank error **<= 1/(bins-1)**.  The native
    payload of a ``sketch=True`` metric, and buildable from sample
    buffers with the same binning.

Payloads are numpy arrays only, pickled as the JAX package's; the random
streams are the JAX package's (``default_rng((seed, salt))`` for reservoir
keys, the seeded multiply-shift family of the count sketch), so a port
sketch and a JAX sketch built from the same numpy data hold the same
arrays.  ``compute()`` runs the port's own functional on ``device`` (the
source metric's; a sketch made with ``from_samples`` and no ``device``
takes the GPU, as a metric does); ``merge_into`` writes torch tensors on
the metric's device.  ``ExactSketch`` and ``ReservoirSketch`` restore into
a live metric (``Metric.merge_sketch``); the bin-domain kinds are terminal.
"""

from __future__ import annotations

import copy
from typing import Any, Iterable, Optional

import numpy as np
import torch


def _device(device) -> torch.device:
    from torcheval_tpu_torch.metrics.metric import canonicalize_device

    return canonicalize_device(device)


def _auc_from_histogram(pos: np.ndarray, neg: np.ndarray) -> float:
    """AUROC from per-bin positive / negative counts (ascending score
    order): each positive beats every negative in a lower bin and ties
    (0.5) the negatives of its own bin."""
    p, n = float(pos.sum()), float(neg.sum())
    if p == 0.0 or n == 0.0:
        return 0.0
    neg_below = np.concatenate(([0.0], np.cumsum(neg)[:-1]))
    wins = float((pos * neg_below).sum()) + 0.5 * float((pos * neg).sum())
    return wins / (p * n)


def _ap_from_histogram(pos: np.ndarray, neg: np.ndarray) -> float:
    """Average precision from per-bin counts: bins in descending score
    order, recall delta x precision a bin."""
    p = float(pos.sum())
    if p == 0.0:
        return 0.0
    pos_d, neg_d = pos[::-1].astype(np.float64), neg[::-1].astype(np.float64)
    tp = np.cumsum(pos_d)
    fp = np.cumsum(neg_d)
    denom = np.maximum(tp + fp, 1e-12)
    precision = tp / denom
    return float((pos_d * precision).sum() / p)


def _compute_from_samples(metric_kind: str, scores, targets, device) -> Any:
    from torcheval_tpu_torch.metrics.functional.classification.auprc import (
        _binary_auprc_compute,
    )
    from torcheval_tpu_torch.metrics.functional.classification.auroc import (
        _binary_auroc_compute,
    )

    dev = _device(device)
    scores = torch.as_tensor(np.asarray(scores), device=dev)
    targets = torch.as_tensor(np.asarray(targets), device=dev)
    if metric_kind == "binary_auroc":
        return _binary_auroc_compute(scores, targets, False)
    if metric_kind == "binary_auprc":
        return _binary_auprc_compute(scores, targets)
    raise ValueError(f"unknown sketched metric kind {metric_kind!r}")


def _compute_from_bins(metric_kind: str, pos: np.ndarray, neg: np.ndarray, device):
    if metric_kind == "binary_auroc":
        value = _auc_from_histogram(pos, neg)
    elif metric_kind == "binary_auprc":
        value = _ap_from_histogram(pos, neg)
    else:
        raise ValueError(f"unknown sketched metric kind {metric_kind!r}")
    return torch.tensor(value, dtype=torch.float32, device=_device(device))


class Sketch:
    """What every sketch kind implements; the module docstring has the
    merge, size and error contract."""

    kind: str = ""
    metric_kind: str = ""
    device: Any = None

    def merge(self, other: "Sketch") -> "Sketch":
        raise NotImplementedError

    def nbytes(self) -> int:
        raise NotImplementedError

    def compute(self) -> Any:
        raise NotImplementedError

    def merge_into(self, metric: Any) -> None:
        """Restore this (merged) sketch into a live metric, where the
        sketch's domain allows it."""
        raise NotImplementedError(
            f"{type(self).__name__} is bin-domain: its samples are gone, "
            "so it cannot repopulate a buffer metric. Read the fleet "
            "value from sketch.compute() instead."
        )

    def _check_mergeable(self, other: "Sketch") -> None:
        if type(other) is not type(self):
            raise TypeError(
                f"cannot merge {type(other).__name__} into {type(self).__name__}"
            )
        if other.metric_kind != self.metric_kind:
            raise ValueError(
                f"cannot merge a {other.metric_kind!r} sketch into a "
                f"{self.metric_kind!r} sketch"
            )


class ExactSketch(Sketch):
    """The identity sketch: the whole prepared metric rides the wire.
    Merge is ``merge_state`` in arrival order, so a merge in rank order is
    bit-equal to the flat gather.  Payload O(samples)."""

    kind = "exact"

    def __init__(self, metric: Any) -> None:
        self.metric = metric

    @classmethod
    def from_metric(cls, metric: Any) -> "ExactSketch":
        metric._prepare_for_merge_state()
        return cls(copy.deepcopy(metric))

    def merge(self, other: "Sketch") -> "ExactSketch":
        if not isinstance(other, ExactSketch):
            raise TypeError(f"cannot merge {type(other).__name__} into ExactSketch")
        self.metric.merge_state([other.metric])
        return self

    def nbytes(self) -> int:
        return state_nbytes(self.metric)

    def compute(self) -> Any:
        return self.metric.compute()

    def merge_into(self, metric: Any) -> None:
        metric.merge_state([self.metric])


class ReservoirSketch(Sketch):
    """A mergeable uniform sample of (score, target) pairs, bottom-k by a
    seeded key from ``default_rng((seed, salt))``; ``salt`` must differ a
    producing rank (the flat sync passes the rank).  Merge keeps the
    ``capacity`` smallest keys: any merge order keeps the same sample."""

    kind = "reservoir"

    def __init__(
        self,
        metric_kind: str,
        capacity: int,
        keys: np.ndarray,
        scores: np.ndarray,
        targets: np.ndarray,
        total_seen: int,
        device=None,
    ) -> None:
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.metric_kind = metric_kind
        self.capacity = int(capacity)
        self.keys = keys
        self.scores = scores
        self.targets = targets
        self.total_seen = int(total_seen)
        self.device = device

    @classmethod
    def from_samples(
        cls,
        metric_kind: str,
        scores: np.ndarray,
        targets: np.ndarray,
        *,
        capacity: int = 4096,
        seed: int = 0,
        salt: int = 0,
        device=None,
    ) -> "ReservoirSketch":
        scores = np.asarray(scores, dtype=np.float32).reshape(-1)
        targets = np.asarray(targets, dtype=np.float32).reshape(-1)
        rng = np.random.default_rng((int(seed), int(salt)))
        keys = rng.random(scores.shape[0])
        sketch = cls(
            metric_kind, capacity, keys, scores, targets,
            total_seen=scores.shape[0], device=device,
        )
        sketch._shrink()
        return sketch

    def _shrink(self) -> None:
        # Always sorted by key, so every merge order leaves the same arrays
        # in the same order and compute is the same bits.
        order = np.argsort(self.keys, kind="stable")[: self.capacity]
        self.keys = self.keys[order]
        self.scores = self.scores[order]
        self.targets = self.targets[order]

    def merge(self, other: "Sketch") -> "ReservoirSketch":
        self._check_mergeable(other)
        self.capacity = min(self.capacity, other.capacity)
        self.keys = np.concatenate([self.keys, other.keys])
        self.scores = np.concatenate([self.scores, other.scores])
        self.targets = np.concatenate([self.targets, other.targets])
        self.total_seen += other.total_seen
        self._shrink()
        return self

    def nbytes(self) -> int:
        return int(self.keys.nbytes + self.scores.nbytes + self.targets.nbytes)

    def compute(self) -> Any:
        return _compute_from_samples(self.metric_kind, self.scores, self.targets, self.device)

    def merge_into(self, metric: Any) -> None:
        # Sample domain: the metric's buffers become the kept sample.
        metric.inputs = [torch.as_tensor(self.scores.copy(), device=metric.device)]
        metric.targets = [torch.as_tensor(self.targets.copy(), device=metric.device)]


class HistogramSketch(Sketch):
    """Binned score counts over [0, 1] (scores clipped), one vector a
    class; merge adds.  AUROC / AP error O(1/bins)."""

    kind = "histogram"

    def __init__(self, metric_kind: str, pos: np.ndarray, neg: np.ndarray, device=None) -> None:
        self.metric_kind = metric_kind
        self.pos = pos
        self.neg = neg
        self.device = device

    @classmethod
    def from_samples(
        cls,
        metric_kind: str,
        scores: np.ndarray,
        targets: np.ndarray,
        *,
        bins: int = 1024,
        device=None,
    ) -> "HistogramSketch":
        if bins < 2:
            raise ValueError(f"bins must be >= 2, got {bins}")
        scores = np.asarray(scores, dtype=np.float64).reshape(-1)
        targets = np.asarray(targets).reshape(-1)
        idx = np.clip((scores * bins).astype(np.int64), 0, bins - 1)
        is_pos = targets > 0.5
        pos = np.bincount(idx[is_pos], minlength=bins).astype(np.int64)
        neg = np.bincount(idx[~is_pos], minlength=bins).astype(np.int64)
        return cls(metric_kind, pos, neg, device=device)

    def merge(self, other: "Sketch") -> "HistogramSketch":
        self._check_mergeable(other)
        if other.pos.shape != self.pos.shape:
            raise ValueError(
                f"bin-count mismatch: {self.pos.shape[0]} vs {other.pos.shape[0]}"
            )
        self.pos = self.pos + other.pos
        self.neg = self.neg + other.neg
        return self

    def nbytes(self) -> int:
        return int(self.pos.nbytes + self.neg.nbytes)

    def compute(self) -> Any:
        return _compute_from_bins(self.metric_kind, self.pos, self.neg, self.device)


class CountSketchState(Sketch):
    """A signed count sketch of the binned score counts: two depth x width
    sheets (one a class); each of the ``bins`` cells hashes to one column a
    row with a +-1 sign (multiply-shift hashing seeded from ``seed``, so
    every rank builds the same family and merge is addition).  A cell's
    count is the median of its depth signed readings."""

    kind = "count"
    _MASK = (1 << 61) - 1

    def __init__(
        self,
        metric_kind: str,
        pos: np.ndarray,
        neg: np.ndarray,
        bins: int,
        seed: int,
        device=None,
    ) -> None:
        self.metric_kind = metric_kind
        self.pos = pos  # (depth, width) signed counts
        self.neg = neg
        self.bins = int(bins)
        self.seed = int(seed)
        self.device = device

    @classmethod
    def _hash_family(cls, depth: int, bins: int, width: int, seed: int) -> tuple:
        rng = np.random.default_rng(int(seed))
        a = rng.integers(1, cls._MASK, size=(depth, 1), dtype=np.int64) | 1
        b = rng.integers(0, cls._MASK, size=(depth, 1), dtype=np.int64)
        cells = np.arange(bins, dtype=np.int64)[None, :]
        h = (a * cells + b) & cls._MASK
        cols = (h % width).astype(np.int64)  # (depth, bins)
        signs = (((h >> 32) & 1) * 2 - 1).astype(np.int64)  # (depth, bins)
        return cols, signs

    @classmethod
    def from_samples(
        cls,
        metric_kind: str,
        scores: np.ndarray,
        targets: np.ndarray,
        *,
        width: int = 1024,
        depth: int = 5,
        bins: int = 8192,
        seed: int = 0,
        device=None,
    ) -> "CountSketchState":
        if width < 1 or depth < 1:
            raise ValueError(f"width/depth must be >= 1, got {width}/{depth}")
        scores = np.asarray(scores, dtype=np.float64).reshape(-1)
        targets = np.asarray(targets).reshape(-1)
        idx = np.clip((scores * bins).astype(np.int64), 0, bins - 1)
        is_pos = targets > 0.5
        pos_counts = np.bincount(idx[is_pos], minlength=bins)
        neg_counts = np.bincount(idx[~is_pos], minlength=bins)
        cols, signs = cls._hash_family(depth, bins, width, seed)
        pos = np.zeros((depth, width), dtype=np.int64)
        neg = np.zeros((depth, width), dtype=np.int64)
        for r in range(depth):
            np.add.at(pos[r], cols[r], signs[r] * pos_counts)
            np.add.at(neg[r], cols[r], signs[r] * neg_counts)
        return cls(metric_kind, pos, neg, bins, seed, device=device)

    def merge(self, other: "Sketch") -> "CountSketchState":
        self._check_mergeable(other)
        if (
            other.pos.shape != self.pos.shape
            or other.bins != self.bins
            or other.seed != self.seed
        ):
            raise ValueError(
                "count-sketch geometry mismatch: both sides must share "
                "width/depth/bins/seed"
            )
        self.pos = self.pos + other.pos
        self.neg = self.neg + other.neg
        return self

    def nbytes(self) -> int:
        return int(self.pos.nbytes + self.neg.nbytes)

    def _recover(self, mat: np.ndarray) -> np.ndarray:
        depth, width = mat.shape
        cols, signs = self._hash_family(depth, self.bins, width, self.seed)
        readings = signs * np.take_along_axis(mat, cols, axis=1)
        return np.maximum(np.median(readings, axis=0), 0.0)

    def compute(self) -> Any:
        return _compute_from_bins(
            self.metric_kind, self._recover(self.pos), self._recover(self.neg), self.device
        )


class RankSketch(Sketch):
    """Mergeable rank-sketch counts: the binned sufficient statistics as a
    payload.  ``num_tp`` / ``num_fp`` are ``(rows, bins)`` per-edge counts
    of ``score >= edge``, ``num_pos`` / ``num_total`` per row, over the
    shared ``edges``.  Merge is elementwise integer addition after a
    geometry check, so every merge order gives the same counts and the
    same compute; the estimate errs by at most ``1/(bins-1)``."""

    kind = "rank"

    def __init__(
        self,
        metric_kind: str,
        edges: np.ndarray,
        num_tp: np.ndarray,
        num_fp: np.ndarray,
        num_pos: np.ndarray,
        num_total: np.ndarray,
        average: Optional[str] = None,
        device=None,
    ) -> None:
        self.metric_kind = metric_kind
        self.edges = np.asarray(edges, dtype=np.float32)
        self.num_tp = np.asarray(num_tp, dtype=np.int64)
        self.num_fp = np.asarray(num_fp, dtype=np.int64)
        self.num_pos = np.asarray(num_pos, dtype=np.int64)
        self.num_total = np.asarray(num_total, dtype=np.int64)
        self.average = average
        self.device = device

    @classmethod
    def from_samples(
        cls,
        metric_kind: str,
        scores: np.ndarray,
        targets: np.ndarray,
        *,
        bins: int = 512,
        device=None,
    ) -> "RankSketch":
        """Bin a flat sample buffer into rank counts with the arithmetic of
        the update (``searchsorted`` over the f32 uniform edges, suffix
        sums), so a buffer-mode rank sketch and a ``sketch=True`` metric
        over the same stream agree bit for bit."""
        from torcheval_tpu_torch.ops.rank_sketch import uniform_edges

        edges = uniform_edges(bins).numpy()
        scores = np.asarray(scores, dtype=np.float32).reshape(-1)
        targets = np.asarray(targets).reshape(-1)
        idx = np.searchsorted(edges, scores, side="right")
        is_pos = targets > 0.5
        cells = np.bincount(idx, minlength=bins + 1).astype(np.int64)
        tp_cells = np.bincount(idx[is_pos], minlength=bins + 1).astype(np.int64)
        num_ge = np.cumsum(cells[::-1])[::-1][1:]
        num_tp = np.cumsum(tp_cells[::-1])[::-1][1:]
        return cls(
            metric_kind,
            edges,
            num_tp[None, :],
            (num_ge - num_tp)[None, :],
            np.asarray([int(is_pos.sum())]),
            np.asarray([scores.shape[0]]),
            device=device,
        )

    def merge(self, other: "Sketch") -> "RankSketch":
        self._check_mergeable(other)
        if (
            other.edges.shape != self.edges.shape
            or other.num_tp.shape != self.num_tp.shape
        ):
            raise ValueError(
                "rank-sketch geometry mismatch: both sides must share the "
                f"edge vector and row count ({self.num_tp.shape} vs "
                f"{other.num_tp.shape})"
            )
        self.num_tp = self.num_tp + other.num_tp
        self.num_fp = self.num_fp + other.num_fp
        self.num_pos = self.num_pos + other.num_pos
        self.num_total = self.num_total + other.num_total
        return self

    def nbytes(self) -> int:
        return int(
            self.edges.nbytes
            + self.num_tp.nbytes
            + self.num_fp.nbytes
            + self.num_pos.nbytes
            + self.num_total.nbytes
        )

    def compute(self) -> Any:
        from torcheval_tpu_torch.metrics.functional.classification.binned_auc import (
            _binned_auprc_from_counts,
            _binned_auroc_from_counts,
        )

        dev = _device(self.device)
        args = tuple(
            torch.as_tensor(a.astype(np.int32), device=dev)
            for a in (self.num_tp, self.num_fp, self.num_pos, self.num_total)
        )
        if self.metric_kind in ("binary_auroc", "multiclass_auroc"):
            score = _binned_auroc_from_counts(*args)
        elif self.metric_kind == "binary_auprc":
            score = _binned_auprc_from_counts(*args)
        else:
            raise ValueError(f"unknown rank-sketched metric kind {self.metric_kind!r}")
        if self.metric_kind == "multiclass_auroc":
            return score.mean() if self.average == "macro" else score
        return score[0] if score.shape[0] == 1 else score


def state_nbytes(metric: Any) -> int:
    """Wire-size proxy for a metric: the bytes of its state arrays, counted
    as the JAX package counts its numpy copies."""

    def nbytes(v) -> int:
        if isinstance(v, torch.Tensor):
            return int(v.numel() * v.element_size())
        return int(np.asarray(v).nbytes)

    total = 0
    for value in metric.state_dict().values():
        if isinstance(value, (list, tuple)):
            total += sum(nbytes(v) for v in value)
        elif isinstance(value, dict):
            total += sum(nbytes(v) for v in value.values())
        else:
            total += nbytes(value)
    return total


_SAMPLE_KINDS = ("exact", "reservoir", "histogram", "count", "rank")


def sketch_from_buffers(
    metric: Any,
    metric_kind: str,
    kind: str,
    *,
    capacity: int = 4096,
    bins: int = 1024,
    width: int = 1024,
    depth: int = 5,
    seed: int = 0,
    salt: int = 0,
) -> Sketch:
    """A sketch of a buffer metric's ``inputs`` / ``targets`` lists, the
    implementation behind ``BinaryAUROC`` / ``BinaryAUPRC.sketch_state``.
    The sketch computes on the metric's device."""
    if kind not in _SAMPLE_KINDS:
        raise ValueError(f"sketch kind must be one of {_SAMPLE_KINDS}, got {kind!r}")
    if kind == "exact":
        return ExactSketch.from_metric(metric)
    if getattr(metric, "num_tasks", 1) != 1:
        raise ValueError(
            "compressed sketches support num_tasks=1 only; "
            "use kind='exact' for multi-task buffers"
        )
    if metric.inputs:
        scores = np.concatenate([v.reshape(-1).cpu().numpy() for v in metric.inputs])
        targets = np.concatenate([v.reshape(-1).cpu().numpy() for v in metric.targets])
    else:
        scores = np.zeros(0, dtype=np.float32)
        targets = np.zeros(0, dtype=np.float32)
    device = metric.device
    if kind == "reservoir":
        return ReservoirSketch.from_samples(
            metric_kind, scores, targets,
            capacity=capacity, seed=seed, salt=salt, device=device,
        )
    if kind == "histogram":
        return HistogramSketch.from_samples(
            metric_kind, scores, targets, bins=bins, device=device
        )
    if kind == "rank":
        # bins defaults to 1024 here; pass bins=512 (the sketch=True
        # default) for bit parity with a sketch-mode metric.
        return RankSketch.from_samples(metric_kind, scores, targets, bins=bins, device=device)
    return CountSketchState.from_samples(
        metric_kind, scores, targets,
        width=width, depth=depth, seed=seed, device=device,
    )


def merge_sketches(base: Sketch, others: Iterable[Optional[Sketch]]) -> Sketch:
    """Fold ``others`` (``None`` skipped: excised ranks) into ``base``."""
    for other in others:
        if other is not None:
            base.merge(other)
    return base
