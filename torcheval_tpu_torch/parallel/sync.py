"""Metric-state sync over a mesh of ranks (the port of
``torcheval_tpu/parallel/sync.py``).

Each rank reduces its own shard of the batch to sufficient statistics and
one collective over the mesh merges them; the collective mirrors each
state's ``merge_state`` (counters ``"sum"``, extrema ``"max"`` /
``"min"``, buffers ``"concat"``).  :func:`mesh_merge_states` is the raw
per-leaf merge, :func:`make_synced_update` wraps a functional update in
it, and the ``sharded_*_histogram`` functions are the O(num_bins)-wire
binned curve metrics.  The JAX functions run inside ``shard_map`` under an
ambient mesh axis; torch has none, so every function here takes the
port's :class:`~torcheval_tpu_torch.parallel.mesh.Mesh` explicitly and
is called by every rank with its own shard (``parallel/mesh.py``).  The
collectives fold the ranks' tensors in rank order, so every rank holds
the same bits, run after run.

The histograms' local stage, per route:
* 0/1 targets, unweighted: ``ops/binned.py::binned_counts``
  (``csrc/binned_count.cu`` on the GPU);
* 0/1 targets, weighted: ``ops/binned.py::binned_weighted_counts``
  (``csrc/binned_wcount.cu`` on the GPU), always;
* soft targets (``pos += w·t``, which only a scatter carries; binary
  only): the scatter histogram of :func:`_local_binned_counts`, on any
  device.  A semantic route, chosen by the targets' values, not a
  fallback from a kernel.
The binary functions tell the first two from the third by reading the
targets (:func:`_binary_hist_gate`).  Under ``skip_value_checks`` they
read no values, so, as JAX's gate, they take the scatter, which is right
for any targets: there only ``assume_01_targets=True`` keeps the kernels.
The scatter's f32 ``index_add_`` adds in arrival order on the GPU, so its
bits, unlike the kernels', may change from run to run.
Over the bisected grid of :func:`_grid_np` the three agree: ``#(s ≥ t_j)``
equals the reversed cumulative counts of the scatter's
``clip(int(s·num_bins))`` bins for every f32 score.

Dropped as TPU artifacts:
* the bf16 weight split (``split3``, ``split_safe_weights``,
  ``_split_safe_thresholds``); ``assume_split_safe_weights`` is accepted
  and ignored, so callers carry across;
* ``_weighted_kernel_route``'s weight gate and ``_hist_route``'s measured
  TPU regimes (the binned-counts dispatch): the GPU takes the kernels
  always, and the weighted multiclass scatter
  (``_build_mc_hist_wscatter_local``) has no route left;
* the tracer downgrades and ``warn_route_downgrade`` (PyTorch runs
  eagerly; ``assume_01_targets=`` still pins the gate);
* ``shard_map``, ``compiled_spmd``, ``spmd_cache_info`` and
  ``spmd_cache_clear`` (a jit cache);
* ``_timed_dispatch``'s perfscope pricing (perfscope is not ported yet,
  ROADMAP queue 1 item 4).
"""

from __future__ import annotations

import random
import time
from functools import lru_cache
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torcheval_tpu_torch.metrics.functional._host_checks import (
    to_host,
    value_checks_enabled,
)
from torcheval_tpu_torch.metrics.functional.classification._sort_scan import class_hits
from torcheval_tpu_torch.ops.binned import binned_counts, binned_weighted_counts
from torcheval_tpu_torch.parallel.mesh import AxisSpec, Mesh, _check_full_axis
from torcheval_tpu_torch.resilience import faults as _faults
from torcheval_tpu_torch.telemetry import events as _telemetry

Reduction = Union[str, Any]  # 'sum' | 'max' | 'min' | 'mean' | 'concat' | tree


# ----------------------------------------------------------- state merges


def _flatten(tree: Any, how: Any, leaves: List, ops: List) -> Callable:
    """Collect ``tree``'s tensor leaves and each one's reduction (``how``
    is one name or a prefix tree of names); return the rebuilder."""
    if isinstance(tree, dict):
        keys = list(tree)
        subs = [_flatten(tree[k], how if isinstance(how, str) else how[k], leaves, ops)
                for k in keys]
        return lambda it: type(tree)((k, f(it)) for k, f in zip(keys, subs))
    if isinstance(tree, (list, tuple)):
        hows = [how] * len(tree) if isinstance(how, str) else list(how)
        if len(hows) != len(tree):
            raise ValueError(f"reductions {how!r} do not match the states' structure")
        subs = [_flatten(v, h, leaves, ops) for v, h in zip(tree, hows)]
        return lambda it: type(tree)(f(it) for f in subs)
    if not isinstance(how, str):
        raise ValueError(f"reductions {how!r} do not match the states' structure")
    leaves.append(torch.as_tensor(tree))
    ops.append(how)
    return lambda it: next(it)


def mesh_merge_states(
    states: Any, axis: AxisSpec = "dp", reductions: Reduction = "sum", *, mesh: Mesh
):
    """Merge every rank's partial ``states`` across ``axis`` of ``mesh``:
    any tree of dicts, lists and tuples of tensors; ``reductions`` is one
    reduction name for every leaf, or a tree (prefix) of names matching
    ``states``.  The analog of ``Metric.merge_state``: addition for
    counters, max / min for extrema, concatenation (dim 0, rank order)
    for sample buffers.  All leaves travel in ONE collective."""
    leaves: List[torch.Tensor] = []
    ops: List[str] = []
    rebuild = _flatten(states, reductions, leaves, ops)
    return rebuild(iter(mesh.all_reduce_many(leaves, ops, axis)))


def make_synced_update(
    kernel: Callable[..., Any],
    mesh: Mesh,
    axis: AxisSpec = "dp",
    reductions: Reduction = "sum",
    in_specs: Optional[Sequence[Any]] = None,
    retry: Optional[Any] = None,
) -> Callable[..., Any]:
    """Wrap a functional sufficient-statistic kernel (``kernel(*batch) ->
    states``, e.g. a ``_*_update`` function of the port) into an update
    that every rank calls with its own shard of the batch: the rank runs
    ``kernel`` on its shard, and the partial states merge across the mesh
    with :func:`mesh_merge_states`; every rank gets the merged states.

    ``in_specs`` is accepted and ignored: each rank passes its own shard of
    a sharded input and the whole of a replicated one, so the specs carry
    nothing here.

    ``retry`` (a :class:`torcheval_tpu_torch.resilience.RetryPolicy`)
    re-runs a failed attempt with backoff, raising
    :class:`~torcheval_tpu_torch.resilience.CollectiveTimeoutError` on
    exhaustion.  An attempt is the rank's kernel, the fault site
    ``sync.dispatch``, then the collective: a rank that fails before the
    collective retries into the same round its peers wait in.  Each failed
    attempt emits a ``retry`` telemetry event when the bus is on, and each
    call a ``sync`` event: its host wall clock and the merged states'
    bytes."""
    _check_full_axis(mesh, axis)
    op = f"synced_update:{getattr(kernel, '__name__', str(kernel))}"

    def attempt_call(*batch):
        states = kernel(*batch)
        if _faults.ENABLED:
            _faults.fire("sync.dispatch", op=op)
        return mesh_merge_states(states, axis, reductions, mesh=mesh)

    if retry is not None:
        from torcheval_tpu_torch.resilience.retry import retry_call

        rng = random.Random(retry.seed)

        def dispatch(*batch):
            return retry_call(op, lambda: attempt_call(*batch), retry, rng=rng)

    else:
        dispatch = attempt_call

    def synced(*batch):
        if not _telemetry.ENABLED:
            return dispatch(*batch)
        t0 = time.monotonic()
        out = dispatch(*batch)
        # The merged states are the collective's payload (every rank ends
        # up holding them), as the JAX package counts it.
        leaves: List[torch.Tensor] = []
        _flatten(out, "sum", leaves, [])
        payload = sum(leaf.numel() * leaf.element_size() for leaf in leaves)
        _telemetry.record_sync(op, time.monotonic() - t0, payload)
        return out

    return synced


# ------------------------------------------------------- the threshold grid


@lru_cache(maxsize=64)
def _grid_np(num_bins: int) -> np.ndarray:
    """The threshold grid that reproduces the scatter formulation's bins
    bit for bit: ``t_j`` is the smallest f32 ``x ≥ 0`` with ``f32(x ·
    num_bins) ≥ j``, so ``#(s ≥ t_j)`` equals the reversed-cumulative
    per-bin counts of ``clip(int(s · num_bins), 0, num_bins − 1)`` for
    every f32 score (a naive ``j / num_bins`` grid moves 1-2 samples a bin
    at representable bin edges).  Found by 32-step bisection on the f32
    bit pattern (f32 multiply is monotone), on the host, cached per
    ``num_bins``: the port's own copy of the JAX package's."""
    j = np.arange(num_bins, dtype=np.float32)
    nb = np.float32(num_bins)
    lo = np.zeros(num_bins, np.uint32)  # 0.0: satisfies only j = 0
    hi = np.full(num_bins, np.float32(1.0).view(np.uint32), np.uint32)
    for _ in range(32):
        mid = (lo + hi) // 2
        ok = mid.view(np.float32) * nb >= j
        hi = np.where(ok, mid, hi)
        lo = np.where(ok, lo, mid + 1)
    t = hi.view(np.float32)
    assert (t * nb >= j).all()
    t.setflags(write=False)
    return t


# ------------------------------------------------------------- epilogues


def _binned_roc_area(cum_tp: torch.Tensor, cum_fp: torch.Tensor) -> torch.Tensor:
    """Trapezoid ROC area from descending-threshold cumulative counts
    (with the (0, 0) origin prepended); degenerate rows give 0.5.  One
    definition serves every route, so weighted(ones) ≡ unweighted holds
    bit for bit."""
    factor = cum_tp[..., -1] * cum_fp[..., -1]
    dx = cum_fp[..., 1:] - cum_fp[..., :-1]
    area = 0.5 * (dx * (cum_tp[..., 1:] + cum_tp[..., :-1])).sum(-1)
    return torch.where(factor == 0, torch.full_like(area, 0.5), area / factor)


def _binned_step_ap(
    delta_tp: torch.Tensor, cum_tp: torch.Tensor, cum_all: torch.Tensor
) -> torch.Tensor:
    """Step-rule AP from descending-threshold per-bin TP increments and
    cumulative TP / predicted-positive counts; no positives gives 0.  The
    0/0 guards do not clamp small weighted counts: AP is invariant to the
    weights' scale."""
    one = torch.ones_like(cum_all)
    precision = torch.where(cum_all > 0, cum_tp / torch.where(cum_all > 0, cum_all, one), one)
    total_pos = cum_tp[-1]
    ap = (delta_tp * precision).sum() / torch.where(total_pos > 0, total_pos, one[-1])
    return torch.where(total_pos == 0, torch.zeros_like(ap), ap)


def _mc_roc_from_counts(num_tp: torch.Tensor, num_fp: torch.Tensor, average):
    """Merged per-threshold class counts → descending-threshold cumulative
    curves → per-class binned ROC areas → the macro mean, or per class
    for any other ``average``."""
    zero = torch.zeros((num_tp.shape[0], 1), dtype=torch.float32, device=num_tp.device)
    cum_tp = torch.cat([zero, num_tp.flip(-1)], dim=-1)
    cum_fp = torch.cat([zero, num_fp.flip(-1)], dim=-1)
    aurocs = _binned_roc_area(cum_tp, cum_fp)
    return aurocs.mean() if average == "macro" else aurocs


# ------------------------------------------------------------ value checks


def _raise_if_scores_out_of_unit(lo: float, hi: float) -> None:
    if lo < 0 or hi > 1:
        raise ValueError(
            "The values in `scores` should be in the range of [0, 1] for "
            f"histogram-binned curve metrics, got min {lo} max {hi} "
            "(apply a sigmoid/softmax first, or use the exact metrics on "
            "the gathered buffers)."
        )


def _world_stats(
    mesh: Mesh, axis: AxisSpec, scores: torch.Tensor, targets: Optional[torch.Tensor]
) -> Tuple[float, float, int, int]:
    """``(min score, max score, #targets not 0/1, #samples)`` over the
    whole mesh: one read back of this rank's four numbers, then one
    collective, so every rank sees the same and takes the same route."""
    n = scores.numel()
    if n:
        # In the scores' own dtype (bool has no min/max): only the two
        # scalars are widened.
        lo, hi = torch.aminmax(scores if scores.dtype != torch.bool else scores.to(torch.uint8))
        lo, hi = lo.to(torch.float64), hi.to(torch.float64)
        non01 = (
            torch.zeros((), device=scores.device)
            if targets is None
            else ((targets != 0) & (targets != 1)).sum()
        )
        local = torch.stack([lo, hi, non01.to(torch.float64)])
        (stats,) = to_host(local)
    else:
        stats = np.array([np.inf, -np.inf, 0.0])
    _check_full_axis(mesh, axis)
    world = mesh.group.all_gather_object((stats, n))
    return (
        min(float(s[0]) for s, _ in world),
        max(float(s[1]) for s, _ in world),
        int(sum(s[2] for s, _ in world)),
        sum(k for _, k in world),
    )


def _check_scores_in_unit_interval(scores: torch.Tensor, mesh: Mesh, axis: AxisSpec) -> None:
    """Raise on every rank when any rank's histogram-binned scores fall
    outside [0, 1]: silent clipping would distort the curve if logits
    were passed by mistake.  Skipped under ``skip_value_checks``."""
    if not value_checks_enabled():
        return
    lo, hi, _, n = _world_stats(mesh, axis, scores, None)
    if n:
        _raise_if_scores_out_of_unit(lo, hi)


def _binary_hist_gate(
    scores: torch.Tensor, targets: torch.Tensor, mesh: Mesh, axis: AxisSpec
) -> bool:
    """Score-range validation and the exact-0/1-target test in one read
    back: True routes to the kernels, False to the scatter (soft targets;
    or ``skip_value_checks`` and empty input, where the values are not
    read, so a CUDA call with 0/1 targets launches no kernel there)."""
    if not value_checks_enabled():
        return False
    lo, hi, non01, n = _world_stats(mesh, axis, scores, targets)
    if n == 0:
        return False
    _raise_if_scores_out_of_unit(lo, hi)
    return non01 == 0


# ------------------------------------------------------- local stages


def _local_binned_counts(s, t, w, num_bins: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's positive and total weighted histograms over the [0, 1]
    score grid: the scatter formulation, ``pos += w·t`` per bin."""
    idx = torch.clamp((s.to(torch.float32) * num_bins).to(torch.int32), 0, num_bins - 1)
    wt = w.to(torch.float32)
    pos = torch.zeros(num_bins, dtype=torch.float32, device=s.device)
    pos.index_add_(0, idx, wt * t.to(torch.float32))
    tot = torch.zeros(num_bins, dtype=torch.float32, device=s.device)
    tot.index_add_(0, idx, wt)
    return pos, tot


def _counts_local(s, hits, weights, num_bins: int):
    """Per-threshold ``(tp, fp)`` of ``(R, N)`` rows: the integer counts,
    or the weighted sums when ``weights`` is given."""
    grid = torch.tensor(_grid_np(num_bins), device=s.device)
    # f32 first: the bisected grid reproduces the scatter's bins for f32
    # scores only.
    s = s.to(torch.float32)
    if weights is None:
        return binned_counts(s, hits, grid)[:2]
    return binned_weighted_counts(s, hits, weights.to(s.device), grid)[:2]


def _run_sharded_binary(
    kind: str,
    num_bins: int,
    mesh: Mesh,
    axis: AxisSpec,
    scores,
    targets,
    weights,
    assume_01_targets: Optional[bool],
):
    """Shape check, route and merge for the 1-D histogram metrics."""
    if scores.dim() != 1 or targets.dim() != 1:
        raise ValueError(
            f"scores and targets should be 1-D, got {tuple(scores.shape)} / "
            f"{tuple(targets.shape)}."
        )
    if assume_01_targets is None:
        assume_01_targets = _binary_hist_gate(scores, targets, mesh, axis)
    else:
        _check_scores_in_unit_interval(scores, mesh, axis)
    if assume_01_targets:
        tp, fp = _counts_local(scores[None], (targets != 0)[None], weights, num_bins)
        tp, fp = tp[0], fp[0]
        if kind == "auroc":
            tp, fp = (x.to(torch.float32) for x in mesh.all_reduce_many([tp, fp], ["sum", "sum"], axis))
            zero = torch.zeros(1, dtype=torch.float32, device=tp.device)
            return _binned_roc_area(torch.cat([zero, tp.flip(0)]), torch.cat([zero, fp.flip(0)]))
        tp, tp_fp = mesh.all_reduce_many([tp, tp + fp], ["sum", "sum"], axis)
        cum_tp = tp.to(torch.float32).flip(0)
        cum_all = tp_fp.to(torch.float32).flip(0)
        delta_tp = torch.diff(cum_tp, prepend=torch.zeros(1, device=cum_tp.device))
        return _binned_step_ap(delta_tp, cum_tp, cum_all)
    if weights is None:
        weights = torch.ones_like(scores, dtype=torch.float32)
    pos, tot = _local_binned_counts(scores, targets, weights.to(scores.device), num_bins)
    pos, tot = mesh.all_reduce_many([pos, tot], ["sum", "sum"], axis)
    if kind == "auroc":
        zero = torch.zeros(1, dtype=torch.float32, device=pos.device)
        cum_tp = torch.cat([zero, torch.cumsum(pos.flip(0), 0)])
        cum_fp = torch.cat([zero, torch.cumsum((tot - pos).flip(0), 0)])
        return _binned_roc_area(cum_tp, cum_fp)
    delta_tp = pos.flip(0)
    return _binned_step_ap(delta_tp, torch.cumsum(delta_tp, 0), torch.cumsum(tot.flip(0), 0))


# ------------------------------------------------------ public histograms


def sharded_auroc_histogram(
    scores: torch.Tensor,
    targets: torch.Tensor,
    mesh: Mesh,
    axis: AxisSpec = "dp",
    num_bins: int = 8192,
    weights: Optional[torch.Tensor] = None,
    assume_01_targets: Optional[bool] = None,
    assume_split_safe_weights: Optional[bool] = None,
) -> torch.Tensor:
    """Binary AUROC over a mesh with O(num_bins) communication.  Each rank
    bins its shard of the scores (validated in [0, 1]) at ``num_bins``
    thresholds, ONE all-reduce merges the ``2 × num_bins`` counts, and
    every rank integrates the binned ROC curve.  Exact for scores already
    on the bin grid, ``O(1/num_bins)`` off otherwise.

    ``assume_01_targets``: ``None`` checks that the targets are exactly 0/1
    (with the score range, in one read back) and routes to the kernels if
    so, else to the scatter, whose fractional positives (``pos += w·t``)
    soft targets need; ``True`` / ``False`` pin the route and skip the
    target check.  Under ``skip_value_checks`` the targets are not read, so
    ``None`` takes the scatter (deterministic on the CPU only); pass
    ``True`` there to keep the kernels.  Weighted calls routed to the
    kernels take the weighted one: f32 sums within 1e-6 of their plain
    version, and bit for bit the unweighted result under unit weights.  ``weights`` is this rank's
    ``(n,)`` shard.  ``assume_split_safe_weights`` is ignored (a TPU
    gate)."""
    return _run_sharded_binary(
        "auroc", num_bins, mesh, axis, scores, targets, weights, assume_01_targets
    )


def sharded_auprc_histogram(
    scores: torch.Tensor,
    targets: torch.Tensor,
    mesh: Mesh,
    axis: AxisSpec = "dp",
    num_bins: int = 8192,
    weights: Optional[torch.Tensor] = None,
    assume_01_targets: Optional[bool] = None,
    assume_split_safe_weights: Optional[bool] = None,
) -> torch.Tensor:
    """Binary average precision over a mesh with O(num_bins)
    communication: the histograms of :func:`sharded_auroc_histogram`, then
    the step-rule ``AP = Σ_bins ΔR_bin · P_bin`` over descending-threshold
    bins.  No positives gives 0; invariant to the scale of ``weights``."""
    return _run_sharded_binary(
        "auprc", num_bins, mesh, axis, scores, targets, weights, assume_01_targets
    )


def sharded_multiclass_auroc_histogram(
    scores: torch.Tensor,
    targets: torch.Tensor,
    mesh: Mesh,
    axis: AxisSpec = "dp",
    num_bins: int = 2048,
    average: Optional[str] = "macro",
    weights: Optional[torch.Tensor] = None,
    assume_split_safe_weights: Optional[bool] = None,
) -> torch.Tensor:
    """One-vs-rest multiclass AUROC over a mesh with O(C × num_bins)
    communication.  Each rank counts its ``(n, C)`` shard of the scores
    (validated in [0, 1]) as ``(C, n)`` class rows, read in place, at
    ``num_bins`` thresholds (``binned_counts``, or ``binned_weighted_counts``
    with per-sample ``weights``), ONE all-reduce merges the ``(C, 2 ×
    num_bins)`` statistics, and every rank integrates the binned ROC curves
    of all classes.  ``average="macro"`` gives their mean, anything else
    the per-class values."""
    if scores.dim() != 2 or targets.dim() != 1:
        raise ValueError(
            "scores should be (N, C) and targets (N,), got "
            f"{tuple(scores.shape)} / {tuple(targets.shape)}."
        )
    _check_scores_in_unit_interval(scores, mesh, axis)
    num_classes = scores.shape[1]
    tp, fp = _counts_local(scores.T, class_hits(targets, num_classes), weights, num_bins)
    tp, fp = mesh.all_reduce_many([tp, fp], ["sum", "sum"], axis)
    return _mc_roc_from_counts(tp.to(torch.float32), fp.to(torch.float32), average)


__all__ = (
    "make_synced_update",
    "mesh_merge_states",
    "sharded_auprc_histogram",
    "sharded_auroc_histogram",
    "sharded_multiclass_auroc_histogram",
)
