"""Exact sharded AUROC / AUPRC over a mesh of ranks (the port of
``torcheval_tpu/parallel/exact.py``).

The histogram metrics of :mod:`.sync` trade exactness for O(num_bins)
wire; this module gives the two exact families.  As everywhere in the
port's ``parallel`` package, a :class:`~.mesh.Mesh` is a world of ranks
and every function here is called by every rank with its own
``shard_batch`` block (``parallel/mesh.py``); every rank returns the same
bits.

**gather-exact** (``sharded_binary_auroc_exact``,
``sharded_binary_auprc_exact``, ``sharded_multitask_auroc_exact``,
``sharded_multitask_auprc_exact``, ``sharded_multiclass_auroc_exact``):
one all-gather of the blocks and their shapes reassembles them in rank
order along the sample axis (axis 0 of 1-D and ``(N, C)`` inputs, axis 1
of ``(T, N)`` ones), and every rank runs the port's single-device
compute on the whole.  The whole is the same bytes on every rank, so every rank takes
the same route (decided inside that compute, as the single-device
functional decides it), and the result is bit for bit the single-device
functional's on the concatenated input.  O(N) wire.

**ustat-exact** (``sharded_binary_auroc_ustat``,
``sharded_binary_auprc_ustat``, ``sharded_multiclass_auroc_ustat``):
exact AUROC is the normalized Mann-Whitney U statistic

    U = Σ_{neg j} [ #pos > s_j  +  ½ · #pos == s_j ],
    AUROC = U / (#pos · #neg),

so only the minority class (binary AUROC), the positives (AP) or each
class's positives (multiclass) travel: each rank packs its own into a
sorted run of ``cap`` entries (infinite pads), the runs are gathered (or
passed round a ring), each rank counts the exact pairs of its own
samples against them, and one sum over the mesh merges the partial U.
Pair counts are exact integers; the sums are in the scores' own float
dtype (float32 at least).

Every eager decision the JAX package takes on its global array (the cap
autotune, the finite check, the cap overflow check, the kernel gate, the
batch's shape and evenness) is here ONE read back of this rank's
statistics and ONE small all-reduce (:func:`_world_stats`; the
gather-exact family's blocks carry their shapes in their one gather):
every rank then decides the same, and a check of the data or of a
block's shape that fails raises the same ``ValueError`` on every rank
after that collective, so no rank waits on a peer that raised.  (A rank
whose block is malformed joins the collective with an empty one.)

``comm`` picks the schedule of the ustat family: ``"gather"`` (one
concatenating all-reduce of the runs), ``"ring"`` (each rank sends the
run it holds to rank + 1 and receives from rank − 1, P − 1 times, the
last run counted in place; point-to-point sends, so the group must
``supports_p2p``, and a world of one sends nothing), or ``"auto"`` (the
ring only when the gathered pack would pass ``_RING_PACK_BYTES``).  Both
schedules count the same integers, so they give the same AUROC bits.

The multiclass ustat counts its pairs in one of two formulations:
* the rank-sum kernel: one stacked ``ops/ustat.py::rank_sum_counts``
  call a rank (a ring step) against the gathered table, its queries the
  ``(C, n_local)`` transpose of the block read in place:
  ``csrc/rank_sum.cu`` on the GPU, its plain version on the CPU.  The
  route's name is ``"pallas"``, the JAX package's, so that
  :func:`eager_ustat_pin`'s output carries across;
* batched ``torch.searchsorted``, where :func:`_mc_ustat_kernel_ok`
  declines on the data: ``TORCHEVAL_TPU_TORCH_DISABLE_USTAT``, float64
  scores, the int32 bound, or scores at or past the ±3e38 pad; or where
  the pack drops scores (an overflowing cap, under ``skip_value_checks``).
  The scores' bounds are read in the call's one read back whatever the
  value checks, so the gate reads them under ``skip_value_checks`` too
  (the JAX package skips that read there and takes searchsorted).
The binary families count with ``torch.searchsorted``, as the JAX package
leaves them to XLA: they launch no kernel.  Nothing here catches a kernel
or build error: a CUDA block launches the kernel or raises.

Dropped as JAX or TPU artifacts: ``shard_map``, ``compiled_spmd`` /
``_compiled``, ``check_vma`` and ``jax_enable_x64`` in the statics (the
sums follow the scores' dtype), the tracer branches and
``warn_route_downgrade`` (PyTorch runs eagerly), ``_interpret`` (CPU
tensors take the plain version), the TPU backend gates, the Mosaic width
envelope (``_MAX_CAP``, ``_ring_buys_envelope``: ``comm="auto"`` resolves
from the pack size alone, as the JAX package does off the TPU),
``_MIN_SPLIT`` and the ``min_nz`` statistic (no bf16 split), and the
two-lane f32 class count (an integer here).
"""

from __future__ import annotations

import secrets
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.distributed import CollectiveGroup, reduce_gathered
from torcheval_tpu_torch.metrics.functional._host_checks import (
    place_inputs,
    to_host,
    value_checks_enabled,
)
from torcheval_tpu_torch.metrics.functional.classification.auprc import (
    _binary_auprc_compute,
)
from torcheval_tpu_torch.metrics.functional.classification.auroc import (
    _binary_auroc_compute,
    _multiclass_auroc_compute,
    _multiclass_auroc_param_check,
)
from torcheval_tpu_torch.ops._flags import ustat_disabled
from torcheval_tpu_torch.ops.ustat import _BIG, _FW, _index_counts, rank_sum_counts
from torcheval_tpu_torch.parallel.mesh import AxisSpec, Mesh, _axis_size

_COMMS = ("auto", "gather", "ring")
_KERNELS = ("auto", "pallas", "searchsorted")

# Above this gathered-pack size comm="auto" takes the ring, whose peak
# memory is one rank's pack.  Kept from the JAX package, where it was
# sized for a TPU v5e's 16 GB; ring and gather give the same AUROC bits,
# so it moves memory, never a result.
_RING_PACK_BYTES = 1 << 30


def _pad_to(x: int, m: int) -> int:
    return -(-x // m) * m


# ------------------------------------------------------------ scaffolding


def _resolve_multi_axis_comm(comm: str, axis: AxisSpec) -> str:
    """THE tuple-axis schedule policy, shared by every ustat function and
    :func:`eager_ustat_pin`: samples sharded jointly over several axes
    keep every collective but have no ring.  Returns the resolved
    ``comm``; raises for an explicit ring request."""
    if isinstance(axis, str):
        return comm
    if comm == "ring":
        raise ValueError(
            "comm='ring' needs a single mesh axis (a ring has no multi-axis "
            "form); use comm='gather' or a 1-D mesh axis for the sample "
            "dimension."
        )
    return "gather"


def _check_comm(comm: str, axis: AxisSpec) -> str:
    if comm not in _COMMS:
        raise ValueError(f"comm should be 'auto', 'gather' or 'ring', got {comm!r}.")
    return _resolve_multi_axis_comm(comm, axis)


def _sharded_axis(mesh: Mesh, axis: AxisSpec) -> int:
    """The ranks along ``axis`` (their collectives run in
    ``mesh.axis_group(axis)``)."""
    return _axis_size(mesh, axis)


def _check_1d_block(s_shape: tuple, t_shape: tuple) -> Optional[str]:
    """What is wrong with a 1-D family's block of these shapes, or ``None``."""
    if len(s_shape) != 1 or s_shape != t_shape:
        return f"scores and targets should be 1-D of equal length, got {s_shape} / {t_shape}."
    return None


def _check_task_block(s_shape: tuple, t_shape: tuple) -> Optional[str]:
    """:func:`_check_1d_block` for ``(num_tasks, n)`` blocks."""
    if len(s_shape) != 2 or s_shape != t_shape:
        return (
            "scores and targets should be (num_tasks, N) of equal shape, "
            f"got {s_shape} / {t_shape}."
        )
    return None


def _class_block_check(num_classes: int) -> Callable[[tuple, tuple], Optional[str]]:
    """:func:`_check_1d_block` for ``(n, num_classes)`` scores and ``(n,)``
    targets."""

    def check(s_shape: tuple, t_shape: tuple) -> Optional[str]:
        if len(s_shape) != 2 or len(t_shape) != 1 or s_shape[0] != t_shape[0]:
            return f"scores should be (N, C) and targets (N,), got {s_shape} / {t_shape}."
        if s_shape[1] != num_classes:
            return f"scores should have {num_classes} columns, got {s_shape}."
        return None

    return check


_SHAPE_DIMS = 4  # sizes of each tensor that a block's shape row carries


def _shape_row(scores: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``(1, 2 + 2·_SHAPE_DIMS)`` int64: each tensor's rank and first
    sizes, the row in which a block's shape rides the call's collective."""
    row = []
    for x in (scores, targets):
        sizes = list(x.shape[:_SHAPE_DIMS])
        row += [x.dim(), *sizes, *[0] * (_SHAPE_DIMS - len(sizes))]
    return torch.tensor([row], dtype=torch.int64)


def _joinable(
    check: Callable[[tuple, tuple], Optional[str]],
    scores: torch.Tensor,
    targets: torch.Tensor,
    empty: Tuple[int, ...] = (0,),
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(shape row, scores, targets)``: a block that ``check`` refuses is
    replaced by an empty one of shape ``empty``, so that this rank still
    joins the call's collective and raises after it, with its peers
    (:func:`_raise_on_bad_blocks`)."""
    row = _shape_row(scores, targets)
    if check(tuple(scores.shape), tuple(targets.shape)) is not None:
        scores, targets = scores.new_zeros(empty), targets.new_zeros(0)
    return row, scores, targets


def _raise_on_bad_blocks(
    rows: np.ndarray,
    check: Callable[[tuple, tuple], Optional[str]],
    sample_dim: int,
    axis: AxisSpec,
    size: int,
) -> None:
    """After the call's collective, from every rank's shape row, so the
    same on every rank: the first malformed block in rank order, blocks
    of different widths, or of different lengths raise one ``ValueError``."""
    k = 1 + _SHAPE_DIMS
    shapes = [
        tuple(tuple(row[i + 1 : i + 1 + min(row[i], _SHAPE_DIMS)]) for i in (0, k))
        for row in np.asarray(rows).tolist()
    ]
    for s_shape, t_shape in shapes:
        message = check(s_shape, t_shape)
        if message is not None:
            raise ValueError(message)
    if len({s[:sample_dim] + s[sample_dim + 1 :] for s, _ in shapes}) > 1:
        raise ValueError(
            f"the ranks' blocks differ in shape off the sample axis: {[s for s, _ in shapes]}."
        )
    lengths = [s[sample_dim] for s, _ in shapes]
    if min(lengths) != max(lengths):
        raise ValueError(
            f"the sample count must divide evenly over mesh axis {axis!r} of size "
            f"{size}: the ranks' blocks hold {min(lengths)} to {max(lengths)} samples "
            "(pad the batch or use a divisible shard size)."
        )


def _work_dtype(dtype: torch.dtype) -> torch.dtype:
    """Scores are compared in their own float dtype (float32 at least), so
    float64 inputs keep their full ordering resolution."""
    return dtype if dtype in (torch.float32, torch.float64) else torch.float32


class _Stats(NamedTuple):
    """What every rank of a call knows after :func:`_world_stats`."""

    lo: float  # the smallest score of the world (NaN if any is; +inf if none)
    hi: float  # the largest
    shapes: np.ndarray  # every rank's shape row (:func:`_shape_row`), in rank order
    sums: np.ndarray  # the ranks' ``sums`` added (int64)
    maxes: np.ndarray  # the ranks' ``maxes``, elementwise largest (int64)
    tag: str  # one name for this call's ring messages, the same on every rank


def _world_stats(
    mesh: Mesh,
    axis: AxisSpec,
    shapes: torch.Tensor,
    scores: torch.Tensor,
    sums: torch.Tensor,
    maxes: torch.Tensor,
) -> _Stats:
    """This rank's score bounds, ``sums`` and ``maxes`` (integer tensors),
    read back ONCE, then ONE all-reduce over the mesh, the block's shape
    row riding along.  So does a random number from each rank, the
    largest of which names the call's ring messages."""
    if scores.numel():
        bounds = torch.stack(torch.aminmax(scores)).to(torch.float64)
    else:
        bounds = torch.tensor([np.inf, -np.inf], dtype=torch.float64)
    b, s, m = to_host(bounds, sums.to(torch.int64), maxes.to(torch.int64), site="exact_stats")
    lo, hi, rows, total, largest = mesh.all_reduce_many(
        [
            torch.from_numpy(b[:1].copy()),
            torch.from_numpy(b[1:].copy()),
            shapes,
            torch.from_numpy(s.copy()),
            torch.tensor([*m.tolist(), secrets.randbits(62)], dtype=torch.int64),
        ],
        ["min", "max", "concat", "sum", "max"],
        axis,
    )
    largest = largest.numpy()
    return _Stats(
        lo=float(lo[0]),
        hi=float(hi[0]),
        shapes=rows.numpy(),
        sums=total.numpy(),
        maxes=largest[:-1],
        tag=f"parallel.exact/{int(largest[-1])}",
    )


def _resolve_ustat_cap(
    requested: Optional[int],
    n_local: int,
    most: int,
    param: str,
    noun: str,
) -> int:
    """Shared cap policy of the ustat functions: ``None`` packs the whole
    block (the multiclass function autotunes instead); an explicit cap
    below the block's length is held against ``most``, the largest count
    of such samples any rank's block holds (from :func:`_world_stats`),
    unless value checks are skipped: then an overflowing block drops some
    of them, as documented on each function."""
    cap = min(requested, n_local) if requested is not None else n_local
    if requested is not None and cap < n_local and value_checks_enabled() and most > cap:
        raise ValueError(
            f"{param}={requested} but a shard holds {most} {noun};"
            " raise the cap (or pass None to disable packing)."
        )
    return cap


def _check_finite_scores(stats: _Stats, n_total: int, fn_name: str) -> None:
    """The ustat families pack runs with infinite pads, so an infinite
    score would be indistinguishable from padding: raise instead of
    returning a wrong AUROC.  Skipped under ``skip_value_checks``; the
    gather-exact functions take non-finite scores."""
    if value_checks_enabled() and n_total:
        _raise_if_not_finite(stats.lo, stats.hi, fn_name)


def _raise_if_not_finite(lo: float, hi: float, fn_name: str) -> None:
    if not (np.isfinite(lo) and np.isfinite(hi)):
        raise ValueError(
            f"{fn_name} requires finite scores (its packed-run padding "
            "uses +/-inf sentinels); use the gather-exact variant for "
            "inputs that may contain inf/nan."
        )


def _choose_ustat_comm(num_rows: int, cap: int, size: int) -> str:
    """Resolve ``comm="auto"`` from the pack's shape alone: the ring when
    the gathered ``(num_rows, P·cap)`` f32 pack would pass
    ``_RING_PACK_BYTES``, the gather (one collective) otherwise."""
    pack_bytes = 4 * num_rows * _pad_to(cap, _FW) * size
    return "ring" if pack_bytes > _RING_PACK_BYTES else "gather"


def _resolve_comm(
    comm: str, group: CollectiveGroup, num_rows: int, cap: int, size: int
) -> str:
    if comm == "auto":
        comm = _choose_ustat_comm(num_rows, cap, size)
    if comm == "ring" and size > 1 and not group.supports_p2p:
        raise ValueError(
            f"comm='ring' sends each rank's pack to the next rank, and the group "
            f"{type(group).__name__} has no point-to-point channel "
            "(supports_p2p is False); pass comm='gather'."
        )
    return comm


def _gather(mesh: Mesh, axis: AxisSpec, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (one
    all-reduce)."""
    (out,) = mesh.all_reduce_many([x.movedim(dim, 0)], ["concat"], axis)
    return out.movedim(0, dim).contiguous()


def _ring(
    group: CollectiveGroup,
    tag: str,
    payload: Tuple[torch.Tensor, ...],
    step: Callable[[Tuple[torch.Tensor, ...]], Tuple[torch.Tensor, ...]],
) -> Tuple[torch.Tensor, ...]:
    """``payload = step(payload)`` for this rank's own payload, then for
    each of the P − 1 payloads that arrive from rank − 1; each is sent on
    to rank + 1 after its step, and the last stays (the sum over the mesh
    that follows does not care where a count lies).  Returns the last
    payload after its step."""
    size, rank = group.world_size, group.rank
    device = payload[0].device
    for i in range(size - 1):
        payload = step(payload)
        group.send_object(list(payload), (rank + 1) % size, f"{tag}/{i}")
        received = group.recv_object((rank - 1) % size, f"{tag}/{i}")
        payload = tuple(x.to(device) for x in received)
    return step(payload)


# ------------------------------------------------------ gather-exact family


def _gather_exact(
    mesh: Mesh,
    axis: AxisSpec,
    sample_dim: int,
    check: Callable[[tuple, tuple], Optional[str]],
    scores: torch.Tensor,
    targets: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shard-order concatenation of every rank's block along
    ``sample_dim``, the same bytes on every rank: ONE all-gather, the
    blocks' shape rows riding with them, so a malformed block or blocks
    of unequal shapes raise on every rank before anything is joined."""
    size = _sharded_axis(mesh, axis)
    parts = mesh.axis_group(axis).all_gather_object([_shape_row(scores, targets), scores, targets])
    _raise_on_bad_blocks(torch.cat([p[0] for p in parts]).numpy(), check, sample_dim, axis, size)
    return tuple(
        reduce_gathered([p[i].movedim(sample_dim, 0) for p in parts], "concat", scores.device)
        .movedim(0, sample_dim)
        .contiguous()
        for i in (1, 2)
    )


def _auprc_of_whole(s_all: torch.Tensor, t_all: torch.Tensor) -> torch.Tensor:
    """``binary_auprc``'s compute on the gathered whole, rows or one row."""
    if s_all.shape[-1] == 0:
        return torch.zeros(s_all.shape[:-1], device=s_all.device)
    return _binary_auprc_compute(s_all, t_all)


def sharded_binary_auroc_exact(
    scores, targets, mesh: Mesh, axis: AxisSpec = "dp"
) -> torch.Tensor:
    """Bit-exact AUROC of the mesh's samples: every rank's block gathered
    in rank order, then the single-device compute, so the result equals
    ``binary_auroc(concat(blocks))`` bit for bit, non-finite scores
    included.  The reference meets this contract by pickling raw buffers
    to one rank (reference ``functional/classification/auroc.py:111-142``,
    ``toolkit.py:247-255``); O(N) wire."""
    scores, targets = place_inputs(scores, targets)
    return _binary_auroc_compute(*_gather_exact(mesh, axis, 0, _check_1d_block, scores, targets))


def sharded_binary_auprc_exact(
    scores, targets, mesh: Mesh, axis: AxisSpec = "dp"
) -> torch.Tensor:
    """Bit-exact average precision of the mesh's samples (the scheme of
    :func:`sharded_binary_auroc_exact`): ``binary_auprc(concat(blocks))``
    bit for bit."""
    scores, targets = place_inputs(scores, targets)
    return _auprc_of_whole(*_gather_exact(mesh, axis, 0, _check_1d_block, scores, targets))


def sharded_multitask_auroc_exact(
    scores, targets, mesh: Mesh, axis: AxisSpec = "dp"
) -> torch.Tensor:
    """Bit-exact AUROC of ``(num_tasks, N)`` inputs sharded over the sample
    axis (axis 1): ``binary_auroc(concat(blocks), num_tasks=T)`` bit for
    bit."""
    scores, targets = place_inputs(scores, targets)
    return _binary_auroc_compute(*_gather_exact(mesh, axis, 1, _check_task_block, scores, targets))


def sharded_multitask_auprc_exact(
    scores, targets, mesh: Mesh, axis: AxisSpec = "dp"
) -> torch.Tensor:
    """Bit-exact average precision of ``(num_tasks, N)`` inputs sharded
    over the sample axis: ``binary_auprc(concat(blocks), num_tasks=T)`` bit
    for bit."""
    scores, targets = place_inputs(scores, targets)
    return _auprc_of_whole(*_gather_exact(mesh, axis, 1, _check_task_block, scores, targets))


def sharded_multiclass_auroc_exact(
    scores,
    targets,
    mesh: Mesh,
    axis: AxisSpec = "dp",
    *,
    num_classes: int,
    average: Optional[str] = "macro",
) -> torch.Tensor:
    """Bit-exact one-vs-rest multiclass AUROC of the mesh's samples:
    ``multiclass_auroc(concat(blocks), ...)`` bit for bit, whichever route
    that compute takes on the whole.  O(N·C) wire, the exactness ceiling;
    prefer :func:`sharded_multiclass_auroc_ustat` (~O(N) wire) or the
    histogram (O(C·bins) wire) where the wire is the cost."""
    _multiclass_auroc_param_check(num_classes, average)
    scores, targets = place_inputs(scores, targets)
    s_all, t_all = _gather_exact(
        mesh, axis, 0, _class_block_check(num_classes), scores, targets
    )
    return _multiclass_auroc_compute(s_all, t_all, num_classes, average)


# ---------------------------------------------------- binary ustat family


def sharded_binary_auroc_ustat(
    scores,
    targets,
    mesh: Mesh,
    axis: AxisSpec = "dp",
    *,
    max_minority_count_per_shard: Optional[int] = None,
    comm: str = "auto",
) -> torch.Tensor:
    """Exact AUROC of the mesh's samples, shipping ONLY the minority class.

    Every rank packs its samples of the globally rarer class (positives
    iff they are at most half, from the all-reduced positive count) into
    an ascending run of ``cap`` entries (``+inf`` pads); the runs are
    gathered (or passed round the ring), and each rank counts, for each of
    its samples of the other class, the exact number of run entries below
    and equal to it by two ``torch.searchsorted``; one sum over the mesh
    merges the partial U.  ``max_minority_count_per_shard`` caps the run
    (O(P·cap) wire in the rare-class regime); ``None`` packs the whole
    block (O(N) wire).  An explicit cap is checked against the largest
    minority count of any block (raising on every rank), unless value
    checks are skipped: then an overflowing block drops its largest
    minority scores.

    Scores must be finite (skippable via ``skip_value_checks``; use the
    gather-exact function for other inputs).  ``comm="ring"`` gives the
    gather's bits (additive integer counts) at one run's peak memory."""
    scores, targets = place_inputs(scores, targets)
    size = _sharded_axis(mesh, axis)
    comm = _check_comm(comm, axis)
    shapes, scores, targets = _joinable(_check_1d_block, scores, targets)
    s = scores.to(_work_dtype(scores.dtype)).contiguous()
    acc = s.dtype
    pos_mask = targets != 0
    n_local = s.shape[0]
    pos_local = pos_mask.sum()
    stats = _world_stats(
        mesh, axis, shapes, s, pos_local[None], torch.stack([pos_local, n_local - pos_local])
    )
    _raise_on_bad_blocks(stats.shapes, _check_1d_block, 0, axis, size)
    n_total = n_local * size
    _check_finite_scores(stats, n_total, "sharded_binary_auroc_ustat")
    n_pos = int(stats.sums[0])
    n_neg = n_total - n_pos
    pick_pos = 2 * n_pos <= n_total  # the minority: positives iff at most half
    cap = _resolve_ustat_cap(
        max_minority_count_per_shard,
        n_local,
        int(stats.maxes[0 if pick_pos else 1]),
        "max_minority_count_per_shard",
        "minority-class samples",
    )
    comm = _resolve_comm(comm, mesh.axis_group(axis), 1, cap, size)

    chosen = pos_mask if pick_pos else ~pos_mask
    # +inf pads sort past every real score, so the slice keeps every
    # minority score unless the block overflows the cap (checked above),
    # and they count in neither lo nor hi of a finite query.
    run = torch.sort(torch.where(chosen, s, torch.inf)).values[:cap]
    if comm == "ring":
        lo = torch.zeros(n_local, dtype=torch.int64, device=s.device)
        hi = torch.zeros_like(lo)

        def count(payload):
            nonlocal lo, hi
            (chunk,) = payload
            lo = lo + torch.searchsorted(chunk, s)
            hi = hi + torch.searchsorted(chunk, s, right=True)
            return payload

        _ring(mesh.axis_group(axis), stats.tag, (run,), count)
    else:
        gathered = torch.sort(_gather(mesh, axis, run)).values
        lo = torch.searchsorted(gathered, s)
        hi = torch.searchsorted(gathered, s, right=True)
    # The integers are the same on both schedules; one rounding to acc.
    lo, hi = lo.to(acc), hi.to(acc)
    n_chosen = torch.tensor(n_pos if pick_pos else n_neg, dtype=acc, device=s.device)
    # chosen = pos: U = Σ_neg #pos > q = n_chosen − hi; chosen = neg:
    # U = Σ_pos #neg < q = lo.  Either way + ½·ties.
    base = n_chosen - hi if pick_pos else lo
    contrib = torch.where(chosen, 0.0, base + 0.5 * (hi - lo))
    (u,) = mesh.all_reduce_many([contrib.sum(dtype=acc)], ["sum"], axis)
    factor = torch.tensor(n_pos, dtype=acc, device=s.device) * torch.tensor(
        n_neg, dtype=acc, device=s.device
    )
    return torch.where(factor == 0, 0.5, u / factor).to(torch.float32)


def sharded_binary_auprc_ustat(
    scores,
    targets,
    mesh: Mesh,
    axis: AxisSpec = "dp",
    *,
    max_positive_count_per_shard: Optional[int] = None,
    comm: str = "auto",
) -> torch.Tensor:
    """Exact average precision of the mesh's samples, shipping ONLY the
    positives.

    Step-sum AP (``binary_auprc``'s) is a sum over positive entries ``v``
    of ``TP(≥v) / (TP(≥v) + FP(≥v))``, divided by the positive count.
    Every rank packs its positives into an ascending run (``+inf`` pads);
    the runs are gathered, ``TP(≥v) = n_pos − #{positives < v}`` by one
    search of the multiset against itself, each rank counts its own
    negatives ``≥ v`` for every gathered ``v``, and one sum over the mesh
    merges the exact ``FP`` vector.  ``max_positive_count_per_shard``:
    like the binary AUROC's cap (checked on every rank unless value checks
    are skipped; then an overflowing block drops its largest positives).
    Scores must be finite.

    ``comm="ring"``: the gathered positives are the QUERY set here, so
    each run travels with its partial ``(#positives < v, FP(≥v))``
    counts, every rank adds its own to the visiting entries, and one sum
    over the mesh merges the runs' precision sums.  The integers are the
    gather's; only the float sum's order differs (~1e-7)."""
    scores, targets = place_inputs(scores, targets)
    size = _sharded_axis(mesh, axis)
    comm = _check_comm(comm, axis)
    shapes, scores, targets = _joinable(_check_1d_block, scores, targets)
    s = scores.to(_work_dtype(scores.dtype)).contiguous()
    acc = s.dtype
    pos_mask = targets == 1  # the single-device kernel's hit definition
    n_local = s.shape[0]
    pos_local = pos_mask.sum()
    stats = _world_stats(mesh, axis, shapes, s, pos_local[None], pos_local[None])
    _raise_on_bad_blocks(stats.shapes, _check_1d_block, 0, axis, size)
    n_total = n_local * size
    _check_finite_scores(stats, n_total, "sharded_binary_auprc_ustat")
    n_pos = int(stats.sums[0])
    cap = _resolve_ustat_cap(
        max_positive_count_per_shard,
        n_local,
        int(stats.maxes[0]),
        "max_positive_count_per_shard",
        "positive samples",
    )
    comm = _resolve_comm(comm, mesh.axis_group(axis), 1, cap, size)

    run = torch.sort(torch.where(pos_mask, s, torch.inf)).values[:cap]
    neg_sorted = torch.sort(torch.where(pos_mask, torch.inf, s)).values
    n_neg_local = n_local - pos_local
    if comm == "ring":

        def count(payload):
            entries, lo_a, fp_a = payload
            lo_a = lo_a + torch.searchsorted(run, entries)
            fp_a = fp_a + (n_neg_local - torch.searchsorted(neg_sorted, entries))
            return entries, lo_a, fp_a

        zeros = torch.zeros(run.shape, dtype=torch.int64, device=s.device)
        entries, lo_self, fp_i = _ring(mesh.axis_group(axis), stats.tag, (run, zeros, zeros), count)
        tp = (n_pos - lo_self).to(acc)
        fp = fp_i.to(acc)
        precision = torch.where(torch.isfinite(entries), tp / torch.clamp(tp + fp, min=1.0), 0.0)
        (prec_sum,) = mesh.all_reduce_many([precision.sum(dtype=acc)], ["sum"], axis)
    else:
        gathered = torch.sort(_gather(mesh, axis, run)).values
        tp = (n_pos - torch.searchsorted(gathered, gathered)).to(acc)
        (fp,) = mesh.all_reduce_many(
            [n_neg_local - torch.searchsorted(neg_sorted, gathered)], ["sum"], axis
        )
        fp = fp.to(acc)
        precision = torch.where(torch.isfinite(gathered), tp / torch.clamp(tp + fp, min=1.0), 0.0)
        prec_sum = precision.sum(dtype=acc)
    n_posf = torch.tensor(n_pos, dtype=acc, device=s.device)
    ap = prec_sum / torch.clamp(n_posf, min=1.0)
    return torch.where(n_posf == 0, 0.0, ap).to(torch.float32)


# ------------------------------------------------ multiclass ustat family


class _McPlan(NamedTuple):
    """The multiclass ustat's decision, the same on every rank."""

    cap: int
    comm: str
    kernel: bool  # the rank-sum formulation, else searchsorted


def _autotune_cap(most: int, n_local: int) -> int:
    """The largest count of one class in any block, rounded up to a
    multiple of 64 (a few stable shapes; it never overflows), at most the
    block."""
    return min(n_local, _pad_to(max(most, 1), 64))


def _mc_ustat_kernel_ok(
    lo: float, hi: float, dtype: torch.dtype, n_total: int, cap: int, size: int, schedule: str
) -> bool:
    """The gate of the rank-sum formulation (vs batched searchsorted):
    the route switch unset, float32 scores (the kernel compares f32) of a
    non-empty world strictly inside the ±3e38 pads, and the int32 bound
    on the global rank sums, which are ≤ N·cap_tot: ``cap_tot · N <
    2^29`` keeps every term of the U identity exact.  ``cap_tot`` is the
    table's whole width: P runs of ``cap``, or on the ring P chunks of
    ``_pad_to(cap, 16)``.  From the data and the flag alone, never the
    device; shared by the function and :func:`eager_ustat_pin`, so the
    two cannot drift apart."""
    if ustat_disabled() or dtype != torch.float32 or n_total == 0:
        return False
    cap_tot = (_pad_to(cap, _FW) if schedule == "ring" else cap) * size
    if cap_tot * n_total >= 2**29:
        return False
    return -_BIG < lo and hi < _BIG


def _class_counts(targets: torch.Tensor, num_classes: int, blocks: int = 1) -> torch.Tensor:
    """int32 ``(blocks, C)`` per-class sample counts of ``targets`` split
    into ``blocks`` equal blocks; a target outside ``[0, C)`` belongs to
    no class (as in the JAX package's one-vs-rest masks)."""
    t = targets.to(torch.int64).reshape(blocks, -1)
    key = torch.where((t >= 0) & (t < num_classes), t, num_classes)
    key = key + (num_classes + 1) * torch.arange(blocks, device=t.device)[:, None]
    counts = _index_counts(key.reshape(-1), blocks * (num_classes + 1))
    return counts.view(blocks, num_classes + 1)[:, :num_classes]


def _mc_ustat_plan(
    scores: torch.Tensor,
    targets: torch.Tensor,
    mesh: Mesh,
    axis: AxisSpec,
    num_classes: int,
    max_class_count_per_shard: Optional[int],
    comm: str,
    kernel: str,
) -> Tuple[_McPlan, _Stats]:
    """The multiclass ustat's checks and decisions from this rank's block
    plus ONE all-reduce: ``(plan, stats)``.  Raises the same error on
    every rank."""
    size = _sharded_axis(mesh, axis)
    check = _class_block_check(num_classes)
    shapes, scores, targets = _joinable(check, scores, targets, (0, num_classes))
    n_local = scores.shape[0]
    counts = _class_counts(targets, num_classes)[0]
    stats = _world_stats(mesh, axis, shapes, scores, counts, counts.max()[None])
    _raise_on_bad_blocks(stats.shapes, check, 0, axis, size)
    n_total = n_local * size
    if value_checks_enabled() and n_total:
        _raise_if_not_finite(stats.lo, stats.hi, "sharded_multiclass_auroc_ustat")
    most = int(stats.maxes[0])
    if max_class_count_per_shard is None:
        cap = _autotune_cap(most, n_local)
    else:
        cap = _resolve_ustat_cap(
            max_class_count_per_shard,
            n_local,
            most,
            "max_class_count_per_shard",
            "samples of one class",
        )
    comm = _resolve_comm(comm, mesh.axis_group(axis), num_classes, cap, size)
    if kernel == "auto":
        # The one read back holds the scores' domain whatever the value
        # checks, so the gate reads it.  The U identity needs every
        # positive in the table: a pack that drops some (an overflowing
        # cap under skip_value_checks) counts with searchsorted.
        use = most <= cap and _mc_ustat_kernel_ok(
            stats.lo, stats.hi, scores.dtype, n_total, cap, size, comm
        )
    else:
        use = kernel == "pallas"
    return _McPlan(cap, comm, use), stats


def sharded_multiclass_auroc_ustat(
    scores,
    targets,
    mesh: Mesh,
    axis: AxisSpec = "dp",
    *,
    num_classes: int,
    average: Optional[str] = "macro",
    max_class_count_per_shard: Optional[int] = None,
    comm: str = "auto",
    _kernel: str = "auto",
) -> torch.Tensor:
    """Exact one-vs-rest multiclass AUROC with O(C · cap · P) wire (~O(N)
    for balanced classes, against O(N·C) for the gather-exact function).

    Each rank packs the scores of its class-``c`` samples into row ``c``
    of a ``(C, cap)`` pack (largest first, ``-inf`` pads), the packs are
    gathered along the columns (or passed round the ring), each rank
    counts its own samples' exact pairs against every class's positives,
    and one sum over the mesh merges them.

    ``max_class_count_per_shard=None`` (the default) autotunes: the cap
    is the largest count of one class in any block, from the call's one
    all-reduce, rounded up to a multiple of 64.  An explicit cap is
    checked against that count on every rank, unless value checks are
    skipped: then an overflowing class keeps its ``cap`` largest scores.
    Scores must be finite (skippable; use the gather-exact function for
    other inputs).

    Local counting: the rank-sum kernel (``rank_sum.cu`` on the GPU) where
    :func:`_mc_ustat_kernel_ok` passes, else batched ``torch.searchsorted``
    (see the module docstring).  ``_kernel`` (``"auto"`` / ``"pallas"``,
    the rank-sum kernel / ``"searchsorted"``) pins a formulation: a test
    and benchmark hook, as :func:`eager_ustat_pin` returns it.

    ``comm``: ``"gather"`` materializes the ``(C, P·cap)`` table on every
    rank and counts once; ``"ring"`` holds one ``(C, cap)`` chunk at a
    time and counts P times, one chunk each; ``"auto"`` takes the ring
    only past ``_RING_PACK_BYTES``.  The pair counts are additive over
    disjoint chunks, so both give the same bits."""
    _multiclass_auroc_param_check(num_classes, average)
    comm = _check_comm(comm, axis)
    if _kernel not in _KERNELS:
        raise ValueError(f"_kernel should be one of {_KERNELS}, got {_kernel!r}.")
    scores, targets = place_inputs(scores, targets)
    s = scores.to(_work_dtype(scores.dtype))
    plan, stats = _mc_ustat_plan(
        s, targets, mesh, axis, num_classes, max_class_count_per_shard, comm, _kernel
    )
    size = _axis_size(mesh, axis)
    n_total = s.shape[0] * size
    n_pos = torch.from_numpy(stats.sums).to(s.device)
    packed = _pack_class_runs(s, targets, num_classes, plan.cap)
    if plan.kernel:
        if plan.comm == "ring":
            rows = _ustat_kernel_table(packed)  # sortedness survives the rotation
            cap_tot = rows.shape[-1] * size
            k = torch.zeros(2 * num_classes, dtype=torch.int32, device=s.device)

            def count(payload):
                nonlocal k
                (chunk,) = payload
                k = k + _stacked_rank_sums(s, chunk)
                return payload

            _ring(mesh.axis_group(axis), stats.tag, (rows,), count)
        else:
            rows = _ustat_kernel_table(_gather(mesh, axis, packed, dim=1))
            cap_tot = rows.shape[-1]
            k = _stacked_rank_sums(s, rows)
        (k,) = mesh.all_reduce_many([k], ["sum"], axis)
        aurocs = _auroc_from_pod_rank_sums(k, num_classes, n_pos, n_total, cap_tot)
    else:
        queries = s.T.contiguous()
        if plan.comm == "ring":
            above = torch.zeros(queries.shape, dtype=torch.int64, device=s.device)
            ties = torch.zeros_like(above)

            def count(payload):
                nonlocal above, ties
                d_above, d_ties = _searchsorted_above_ties(payload[0], queries)
                above, ties = above + d_above, ties + d_ties
                return payload

            # Sorted once: sortedness survives the rotation.
            _ring(mesh.axis_group(axis), stats.tag, (torch.sort(packed, dim=-1).values,), count)
        else:
            rows = torch.sort(_gather(mesh, axis, packed, dim=1), dim=-1).values
            above, ties = _searchsorted_above_ties(rows, queries)
        is_class = targets[None, :] == torch.arange(num_classes, device=s.device)[:, None]
        aurocs = _auroc_from_u(is_class, above, ties, n_pos, n_total, mesh, axis, s.dtype)
    return aurocs.mean() if average == "macro" else aurocs


def _pack_class_runs(
    s: torch.Tensor, targets: torch.Tensor, num_classes: int, cap: int
) -> torch.Tensor:
    """``(C, cap)``: row ``c`` holds the scores of this block's class-``c``
    samples, largest first, ``-inf`` pads; a class past ``cap`` keeps its
    ``cap`` largest (the JAX package's descending sort and slice).  Built
    without a ``(C, n)`` sort: two stable argsorts of the block's own-class
    scores give every sample its slot, and one scatter places them."""
    n = s.shape[0]
    t = targets.to(torch.int64)
    valid = (t >= 0) & (t < num_classes)
    key = torch.where(valid, t, num_classes)
    own = s.gather(1, torch.where(valid, t, 0)[:, None])[:, 0]
    order = torch.argsort(own, descending=True, stable=True)
    order = order[torch.argsort(key[order], stable=True)]
    k = key[order]
    counts = _index_counts(k, num_classes + 1)
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(n, device=s.device) - starts[k]
    # Row C and column cap catch the samples of no class and the overflow.
    pack = torch.full((num_classes + 1, cap + 1), -torch.inf, dtype=s.dtype, device=s.device)
    pack[k, slot.clamp(max=cap)] = own[order]
    return pack[:num_classes, :cap]


def _ustat_kernel_table(packed: torch.Tensor) -> torch.Tensor:
    """Ascending rows with ``+3e38`` pads (the rank-sum kernel's table
    contract), the width padded to a multiple of 16: extra pad columns are
    inert, since the identity's ``cap_tot`` counts every pad.  Shared by
    the gathered table and each ring chunk."""
    rows = torch.sort(torch.where(torch.isinf(packed), _BIG, packed), dim=-1).values
    pad = (-rows.shape[-1]) % _FW
    if pad:
        rows = torch.nn.functional.pad(rows, (0, pad), value=_BIG)
    return rows


def _stacked_rank_sums(s: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """int32 ``(2C,)``: ``K_A`` (non-strict) over ``K_B`` (the strict pass,
    ``−q`` against ``−rows`` reversed) of this block's ``(C, n)``
    transposed scores against ``rows``, in ONE ``rank_sum_counts``
    launch."""
    return rank_sum_counts(s.T, torch.cat([rows, -rows.flip(-1)]), negate=True)


def _auroc_from_pod_rank_sums(
    k: torch.Tensor, c: int, n_pos: torch.Tensor, n_total: int, cap_tot: int
) -> torch.Tensor:
    """The pod U identity: with ``K_A`` / ``K_B`` the mesh-summed strict /
    non-strict rank sums of ALL samples against the global per-class table
    (width ``cap_tot``, every pad included),

        2·U_c = 2·n_c·N − K_A − N·cap_tot + K_B − n_c²

    (the single-device identity of ``ops/ustat.py``; the sum over the
    mesh makes the query multiset global).  In int64 from the int32 sums
    (the JAX package's int32 wraps in the middle terms at N = 2^16; only
    the final 2U < 2^30 has to fit), then the same single f32 cast and
    f32 division; degenerate classes give 0.5."""
    k = k.to(torch.int64)
    k_a, k_b = k[:c], k[c:]
    two_u = 2 * n_pos * n_total - k_a - n_total * cap_tot + k_b - n_pos * n_pos
    n_posf = n_pos.to(torch.float32)
    factor = n_posf * (float(np.float32(n_total)) - n_posf)
    return torch.where(factor == 0, 0.5, two_u.to(torch.float32) / (2.0 * factor))


def _searchsorted_above_ties(
    rows: torch.Tensor, queries: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (class, query) exact ``(#entries > q, #entries == q)`` against
    ascending rows with ``-inf`` pads (pads are never above a query, and
    land on both sides of the tie difference)."""
    lo = torch.searchsorted(rows, queries)
    hi = torch.searchsorted(rows, queries, right=True)
    return rows.shape[-1] - hi, hi - lo


def _auroc_from_u(
    is_class: torch.Tensor,
    above: torch.Tensor,
    ties: torch.Tensor,
    n_pos: torch.Tensor,
    n_total: int,
    mesh: Mesh,
    axis: AxisSpec,
    acc: torch.dtype,
) -> torch.Tensor:
    """The searchsorted epilogue of both schedules: mask same-class
    queries, sum the U contributions over the mesh in ``acc`` (the
    scores' dtype), divide by the pair count; degenerate classes give
    0.5.  ``above`` / ``ties`` are exact integers and take their one
    rounding here."""
    contrib = torch.where(is_class, 0.0, above.to(acc) + 0.5 * ties.to(acc))
    (u,) = mesh.all_reduce_many([contrib.sum(dim=1, dtype=acc)], ["sum"], axis)
    n_posf = n_pos.to(acc)
    factor = n_posf * (n_total - n_posf)
    return torch.where(factor == 0, 0.5, u / factor).to(torch.float32)


def eager_ustat_pin(
    scores,
    targets,
    num_classes: int,
    world: int,
    comm: str = "auto",
    axis: AxisSpec = "dp",
) -> Tuple[int, str]:
    """The multiclass ustat's ``(cap, kernel)`` decision from the WHOLE
    arrays, with no collective: the targets are split into ``world``
    equal blocks, the cap is autotuned from their largest class count and
    the kernel gate reads the whole scores, as
    :func:`sharded_multiclass_auroc_ustat` decides from its blocks and one
    all-reduce.  Returns ``(cap, kernel)`` with ``kernel`` ``"pallas"``
    (the rank-sum kernel) or ``"searchsorted"``: pass them as
    ``max_class_count_per_shard=`` and ``_kernel=``.  ``comm`` and
    ``axis`` must be the pinned call's (a tuple axis has no ring)."""
    comm = _check_comm(comm, axis)
    scores, targets = place_inputs(scores, targets)
    s = scores.to(_work_dtype(scores.dtype))
    n = s.shape[0]
    if n:
        bounds, most = to_host(
            torch.stack(torch.aminmax(s)).to(torch.float64),
            _class_counts(targets, num_classes, world).max(),
            site="exact_route",
        )
        lo, hi, most = float(bounds[0]), float(bounds[1]), int(most)
    else:
        lo, hi, most = np.inf, -np.inf, 0
    cap = _autotune_cap(most, n // world)
    if comm == "auto":
        comm = _choose_ustat_comm(num_classes, cap, world)
    ok = _mc_ustat_kernel_ok(lo, hi, s.dtype, n, cap, world, comm)
    return cap, ("pallas" if ok else "searchsorted")


__all__ = (
    "eager_ustat_pin",
    "sharded_binary_auprc_exact",
    "sharded_binary_auprc_ustat",
    "sharded_binary_auroc_exact",
    "sharded_binary_auroc_ustat",
    "sharded_multiclass_auroc_exact",
    "sharded_multiclass_auroc_ustat",
    "sharded_multitask_auprc_exact",
    "sharded_multitask_auroc_exact",
)
