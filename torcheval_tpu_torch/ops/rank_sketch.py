r"""Mergeable rank-sketch counts: the sort-free state tier (the port of
``torcheval_tpu/ops/rank_sketch.py``).

The exact AUROC / AUPRC family buffers every sample and sorts the buffer
at compute.  A **rank sketch** replaces that state with a fixed-size one,
updated in one pass over the batch and merged by integer addition.  Two
geometries share the counting:

* **Uniform edges** (scores in [0, 1], the curve metrics): ``bins`` edges
  from :func:`uniform_edges`; the state is the per-edge ``score >= edge``
  count, bit for bit the binned family's sufficient statistics
  (``num_tp`` / ``num_fp`` / ``num_pos`` / ``num_total``), so a
  sketch-mode binary member rides the collection kernel's ``"binned"``
  kind (``ops/_mega_plan.py``, ``csrc/mega.cu``).
* **Dyadic ladder** (non-negative values without a bound, the monitor's
  latency digest): ``levels`` levels of ``bins`` sub-bins; level 0 covers
  ``[0, base)``, level l >= 1 covers ``[base 2^(l-1), base 2^l)``, so the
  relative value error is at most ``1/bins`` above ``base``.

Rank queries at the edges are exact; an arbitrary value's rank errs by at
most the mass of its bin, ``1/(bins-1)`` of the stream for a Lipschitz
score CDF (:func:`rank_error_bound`).

Formulations of :func:`rank_counts_rows` (int32 counts, equal bit for bit
on every route, NaN included):

* ``"kernel"``: a CUDA tensor goes through
  ``binned_auc._binned_counts_rows``, so it launches
  ``csrc/binned_count.cu``.  Past the kernel's bound (N >= 2^31) that
  function takes the binned family's declared ``"sort"`` route; a CUDA
  tensor never reaches the plain version below.
* ``"bincount"``: a CPU tensor runs :func:`_rank_counts_bincount`, the
  JAX package's one-pass formulation: ``searchsorted(edges, s,
  right=True)``, a masked ``bincount`` into ``bins + 1`` cells, and a
  suffix sum.

A NaN score counts at every edge on both routes (the binned kernel's slot
rule, and ``jnp.searchsorted``'s total order, which puts NaN past the top
edge).  A masked sample counts at no edge: the kernel route sees a
``-inf`` score, the plain route puts it in cell 0; both give the same
counts.

The ladder (:func:`ladder_edges`, :func:`ladder_fill`,
:func:`ladder_counts`, :func:`ladder_quantiles`) is plain torch, as the
JAX package leaves it to XLA; every op in it is safe inside a CUDA graph
capture (no read back).

Dropped from the JAX module: the TPU backend gate and the Pallas switch in
the route choice (the device decides), and ``jax.jit``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.ops import _build
from torcheval_tpu_torch.ops.binned import _MAX_N

# The binned-AUC helpers (_binned_counts_rows, _create_threshold_tensor)
# are imported inside the functions that use them: ops is a lower layer
# than metrics.functional, and the sketch shares the binned family's edge
# constructor and kernel route on purpose.

# Default uniform-edge resolution: the most thresholds the collection
# kernel plans (_mega_plan._MAX_THRESHOLDS), giving a rank error of 1/511.
DEFAULT_BINS = 512

Counts = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def uniform_edges(bins: int, device=None) -> torch.Tensor:
    """``bins`` ascending uniform edges over [0, 1] (f32), on ``device``
    (default the CPU).  The binned family's threshold constructor, so edge
    ``j`` equals threshold ``j`` bit for bit: the ``jnp.linspace`` grid.
    A fresh tensor: the constructor's cached grid is never handed out."""
    from torcheval_tpu_torch.metrics.functional.classification.binned_precision_recall_curve import (  # noqa: E501
        _create_threshold_tensor,
    )

    if bins < 2:
        raise ValueError(f"sketch bins must be >= 2, got {bins}")
    return _create_threshold_tensor(int(bins), torch.device(device or "cpu")).clone()


def rank_error_bound(bins: int) -> float:
    """The documented rank error of the uniform-edge sketch: exact at the
    edges, at most the bin width ``1/(bins-1)`` elsewhere (and so for the
    AUROC / AUPRC estimates built on the edge counts)."""
    return 1.0 / (bins - 1)


def _select_rank_route(num_samples: int, edges: torch.Tensor) -> str:
    """The formulation for one update, from the device the edges live on:
    ``"kernel"`` for CUDA tensors below the kernel's bound, the binned
    family's declared ``"sort"`` route past it, ``"bincount"`` for CPU
    tensors.  Shapes and the device only; never the data."""
    if edges.device.type == "cuda":
        return "kernel" if num_samples < _MAX_N else "sort"
    if edges.device.type == "cpu":
        return "bincount"
    raise ValueError(f"the rank sketch runs on cuda or cpu, not {edges.device}.")


def rank_counts_rows(
    scores: torch.Tensor,
    hits: torch.Tensor,
    edges: torch.Tensor,
    route: Optional[str] = None,
    mask: Optional[torch.Tensor] = None,
) -> Counts:
    """Per-edge ``score >= edge`` counts over ``(R, N)`` score / hit rows:
    ``(num_tp (R, B), num_fp (R, B), num_pos (R,), num_total (R,))`` as
    int32, equal bit for bit on every route.

    ``mask`` (shape ``(N,)``) excludes padded samples exactly: a masked
    score counts at no edge, its hit is zeroed, and ``num_total`` is
    ``mask.sum()``.  A CUDA tensor launches ``binned_count.cu`` (or, past
    2^31 samples, takes the binned family's sort) and never the plain
    version; asking for ``route="bincount"`` on one raises."""
    if route is None:
        route = _select_rank_route(scores.shape[-1], edges)
    if route == "bincount":
        if scores.device.type != "cpu":
            raise ValueError(
                "the bincount formulation is the rank sketch's plain version and "
                f"runs on CPU tensors only, not {scores.device}."
            )
        return _rank_counts_bincount(scores, hits, edges, mask=mask)
    if route not in ("kernel", "sort"):
        raise ValueError(f"unknown rank-sketch route {route!r}")
    from torcheval_tpu_torch.metrics.functional.classification.binned_auc import (
        _binned_counts_rows,
    )

    return _binned_counts_rows(scores, hits, edges, mask=mask)


def _rank_counts_bincount(
    scores: torch.Tensor,
    hits: torch.Tensor,
    edges: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Counts:
    """The plain version: ``idx_i = #{j : edges_j <= s_i}`` by
    ``searchsorted`` (NaN set to ``bins`` explicitly, past the top edge, as
    the kernel's slot rule and ``jnp.searchsorted`` put it), a per-row
    ``bincount`` into ``bins + 1`` cells (a masked sample in cell 0, below
    every edge), and a suffix sum: ``#{i : s_i >= edges_j} = sum_{k > j}
    cell_k``."""
    _build.count_plain("rank_counts")
    num_rows, n = scores.shape
    bins = edges.shape[0]
    s = scores.to(torch.float32).contiguous()
    idx = torch.searchsorted(edges.to(torch.float32).contiguous(), s, right=True)
    idx = torch.where(torch.isnan(s), bins, idx)
    hits_b = hits.to(torch.bool)
    if mask is not None:
        valid = mask.to(torch.bool)
        idx = torch.where(valid[None, :], idx, 0)
        hits_b = hits_b & valid[None, :]
    cells_n = num_rows * (bins + 1)
    flat = (idx + torch.arange(num_rows, device=s.device)[:, None] * (bins + 1)).reshape(-1)
    cells = torch.bincount(flat, minlength=cells_n).view(num_rows, bins + 1)
    tp_cells = torch.bincount(flat[hits_b.reshape(-1)], minlength=cells_n).view(
        num_rows, bins + 1
    )
    num_ge = cells.flip(-1).cumsum(-1).flip(-1)[:, 1:]
    num_tp = tp_cells.flip(-1).cumsum(-1).flip(-1)[:, 1:]
    num_pos = hits_b.sum(-1, dtype=torch.int32)
    if mask is None:
        num_total = torch.full((num_rows,), n, dtype=torch.int32, device=s.device)
    else:
        num_total = torch.zeros(num_rows, dtype=torch.int32, device=s.device) + valid.sum(
            dtype=torch.int32
        )
    return (
        num_tp.to(torch.int32),
        (num_ge - num_tp).to(torch.int32),
        num_pos,
        num_total,
    )


# --------------------------------------------------------------- ladder
def ladder_edges(base: float, levels: int, bins: int, device=None) -> torch.Tensor:
    """The flattened ascending left edges of the dyadic ladder:
    ``levels x bins`` f32 edges, level 0 slicing ``[0, base)`` uniformly
    and level l >= 1 slicing ``[base 2^(l-1), base 2^l)``.  Each scalar is
    rounded to f32 before it multiplies, as JAX's weakly typed Python
    float does, so the edges are the JAX package's bit for bit."""
    if levels < 1:
        raise ValueError(f"ladder levels must be >= 1, got {levels}")
    if bins < 2:
        raise ValueError(f"ladder bins must be >= 2, got {bins}")
    if base <= 0.0:
        raise ValueError(f"ladder base must be positive, got {base}")
    sub = np.arange(bins, dtype=np.float32) / np.float32(bins)
    rows = [np.float32(base) * sub]
    for lvl in range(1, levels):
        lo = np.float32(base * (2.0 ** (lvl - 1)))
        rows.append(lo * (np.float32(1.0) + sub))
    edges = np.concatenate(rows).astype(np.float32)
    return torch.from_numpy(edges).to(torch.device(device or "cpu"))


def ladder_fill(counts: torch.Tensor, levels: int) -> torch.Tensor:
    """Per-level fill counters: the ``(levels,)`` sums of the flattened
    ``(levels * bins,)`` per-bin counts."""
    return counts.reshape(levels, -1).sum(-1, dtype=counts.dtype)


def ladder_counts(
    values: torch.Tensor,
    edges: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-bin occupancy of one batch of non-negative values: each value's
    bin is ``searchsorted(edges, v, right=True) - 1`` clipped into the
    ladder (values past the top edge, and NaN, land in the last bin,
    negative ones in the first), then one integer ``index_add_``."""
    values = values.reshape(-1).to(torch.float32)
    k = edges.shape[0]
    idx = torch.searchsorted(edges, values, right=True)
    idx = torch.where(torch.isnan(values), k, idx)
    idx = torch.clamp(idx - 1, 0, k - 1)
    if mask is None:
        weights = torch.ones_like(idx, dtype=torch.int32)
    else:
        weights = mask.reshape(-1).to(torch.int32)
    return torch.zeros(k, dtype=torch.int32, device=values.device).index_add_(0, idx, weights)


def ladder_quantiles(
    counts: torch.Tensor, edges: torch.Tensor, qs: Tuple[float, ...]
) -> torch.Tensor:
    """Quantile reads off the ladder: the inclusive int32 cumsum is the
    CDF, each quantile's target rank is ``ceil(q * total)`` in f32, and the
    read is its bin's left edge (never interpolated, so every merge order
    gives the same value)."""
    cdf = torch.cumsum(counts.to(torch.int32), 0, dtype=torch.int32)
    total = torch.clamp(cdf[-1], min=1).to(torch.float32)
    q = torch.tensor(qs, dtype=torch.float32, device=counts.device)
    target = torch.ceil(q * total).to(torch.int32)
    pos = torch.searchsorted(cdf, target, right=False)
    pos = torch.clamp(pos, 0, edges.shape[0] - 1)
    return edges[pos]


__all__ = [
    "DEFAULT_BINS",
    "ladder_counts",
    "ladder_edges",
    "ladder_fill",
    "ladder_quantiles",
    "rank_counts_rows",
    "rank_error_bound",
    "uniform_edges",
]
