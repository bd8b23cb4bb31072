"""Exact AUROC as a rank-sum (Mann-Whitney U) count, and exact average
precision from a rank histogram: the sort-free routes for the one-vs-rest
and rare-class regimes (the port of ``torcheval_tpu/ops/pallas_ustat.py``).

One-vs-rest positives are sparse: class ``c`` owns ``n_c ≈ N/C`` samples,
and its exact AUROC is a pair count against the tiny packed table ``P_c``
of its positive scores.  Summing ranks over all N queries (positives
included) removes the need to mask, since over ordered same-class pairs
``Σ[a>b] + ½Σ[a=b] = n²/2``, so

    2·U_c = 2·n_c·N − K_A − N·cap + K_B − n_c²
    AUROC_c = U_c / (n_c · (N − n_c))

where ``K_A = Σ_q #{table ≤ q}`` over ``P_c`` padded with +BIG, and
``K_B = Σ_q #{table' ≤ −q}`` against the negated, re-sorted table (pads
−BIG).  Both are exact integer counts from :func:`rank_sum_counts`: the
CUDA kernel ``csrc/rank_sum.cu`` for tensors on the GPU, the plain
PyTorch :func:`_rank_sum_counts_plain` for tensors on the CPU.

Step-sum AP is ``(1/n_c) Σ_{table entries v} TP(≥ t_v) / #{q ≥ t_v}``:
the ascending table gives ``TP`` by position, and ONE histogram of each
query's table bin (:func:`rank_hist_counts`: ``csrc/rank_hist.cu`` on the
GPU, :func:`_rank_hist_counts_plain` on the CPU) gives the denominators
by suffix sums (:func:`_ap_from_hist`).

Dropped from the JAX module, because they exist only for the TPU's MXU
gather and the Mosaic compiler: the exact bf16 three-way split
(``_split3_bf16``, ``_trunc_bf16_f32``, ``_gather_split3``), its
subnormal gate ``_MIN_SPLIT`` (the Hopper kernel compares f32 values
directly, so it has no blind spot near zero) and the compiler's operand
bound (``_MOSAIC_OPERAND_BOUND``, ``_MAX_CAP``, ``_mosaic_tile``).  The
int32 exactness bound ``cap·N < 2^29`` and the route's win region
(:func:`_win_cap`) are kept exactly.  The route is decided from the data
and ``TORCHEVAL_TPU_TORCH_DISABLE_USTAT`` alone, never from the device.
The JAX histogram's ``N < 2^24`` (its f32 per-bin sums) is dropped: the
port counts in int32 (``N < 2^31``), and the route's ``cap·N < 2^29``
binds first.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.ops import _build
from torcheval_tpu_torch.ops._flags import ustat_disabled

_FW = 16  # table capacities are multiples of this
_BIG = 3.0e38  # pad sentinel; the route guarantees |score| < _BIG


def rank_sum_counts(
    queries: torch.Tensor, tables: torch.Tensor, *, negate: bool = False
) -> torch.Tensor:
    """``K[r] = Σ_q #{tables[r] ≤ queries[r, q]}`` as exact int32.

    ``queries`` is ``(Rq, N)`` f32 with any strides (the (N, C) score
    buffer's transpose is read in place); ``tables`` is ``(R, cap)`` f32,
    ascending per row, ``cap`` a multiple of 16.  With ``negate`` the call
    is the stacked two-pass form: ``tables`` has ``R = 2·Rq`` rows, and
    rows ``Rq + r`` count against ``−queries[r]``, so the scores are read
    once for both passes.  Requires ``cap·N < 2^31``."""
    rq, n = _check_rank_sum_args(queries, tables, negate)
    if queries.device.type == "cpu":
        return _rank_sum_counts_plain(queries, tables, negate=negate)
    if queries.device.type != "cuda":
        raise ValueError(f"rank_sum_counts runs on cuda or cpu, not {queries.device}.")
    cap = tables.shape[1]
    tables = tables.contiguous()
    out = torch.zeros(tables.shape[0], dtype=torch.int32, device=queries.device)
    if rq == 0 or n == 0:
        return out
    lib = _build.library()
    with torch.cuda.device(queries.device):
        err = lib.rank_sum_counts_launch(
            queries.data_ptr(),
            queries.stride(0),
            queries.stride(1),
            rq,
            n,
            tables.data_ptr(),
            cap,
            int(negate),
            out.data_ptr(),
            _build.stream_handle(queries.device),
        )
    _build.check_launch("rank_sum", err)
    _build.LAUNCHES["rank_sum_counts"] += 1
    return out


def _check_rank_sum_args(
    queries: torch.Tensor, tables: torch.Tensor, negate: bool
) -> Tuple[int, int]:
    if queries.dim() != 2 or tables.dim() != 2:
        raise ValueError("queries and tables must be 2-D.")
    if queries.dtype != torch.float32 or tables.dtype != torch.float32:
        raise TypeError(
            f"rank_sum_counts takes float32, got {queries.dtype} and {tables.dtype}."
        )
    if queries.device != tables.device:
        raise ValueError("queries and tables must be on one device.")
    rq, n = queries.shape
    r, cap = tables.shape
    if r != (2 * rq if negate else rq):
        raise ValueError(
            f"tables has {r} rows; expected {2 * rq if negate else rq} for "
            f"{rq} query rows (negate={negate})."
        )
    if cap % _FW != 0 or cap == 0:
        raise ValueError(f"table capacity {cap} must be a positive multiple of {_FW}")
    if cap * n >= 2**31:
        raise ValueError(f"cap·N = {cap * n} overflows the int32 counts (< 2^31).")
    return rq, n


def _rank_sum_counts_plain(
    queries: torch.Tensor, tables: torch.Tensor, *, negate: bool = False
) -> torch.Tensor:
    """The kernel's counts in plain PyTorch, by one joint row sort: each
    row's table entries are placed before its queries, so a stable sort
    keeps every table entry ahead of the queries equal to it, and a
    query's count is the number of table entries sorted before it.  Exact
    for NaN-free queries (the routes exclude NaN)."""
    _build.PLAIN_CALLS["rank_sum_counts"] += 1
    if negate:
        queries = torch.cat([queries, -queries])
    cap = tables.shape[1]
    joint = torch.cat([tables, queries], dim=1)
    is_table = torch.sort(joint, dim=1, stable=True).indices < cap
    before = torch.cumsum(is_table, dim=1, dtype=torch.int64)
    return torch.where(is_table, 0, before).sum(dim=1).to(torch.int32)


def rank_hist_counts(queries: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """``hist[r, v] = #{q in row r : bin(q) = v}`` as exact int32, where
    ``bin(q)`` is the largest table index with ``t ≤ q``; queries below
    every entry, and NaN queries, fall in no bin.  ``suffix_cumsum(hist)[v]``
    is then the per-entry ``#{q ≥ t_v}``, the denominators of the step-sum
    AP.  ``queries`` is ``(R, N)`` f32 with any strides (the (N, C) score
    buffer's transpose is read in place); ``tables`` is ``(R, cap)`` f32,
    ascending per row, ``cap`` a multiple of 16.  Requires ``N < 2^31``."""
    r, n = _check_rank_hist_args(queries, tables)
    if queries.device.type == "cpu":
        return _rank_hist_counts_plain(queries, tables)
    if queries.device.type != "cuda":
        raise ValueError(f"rank_hist_counts runs on cuda or cpu, not {queries.device}.")
    cap = tables.shape[1]
    tables = tables.contiguous()
    hist = torch.zeros((r, cap), dtype=torch.int32, device=queries.device)
    if r == 0 or n == 0:
        return hist
    lib = _build.library()
    with torch.cuda.device(queries.device):
        err = lib.rank_hist_counts_launch(
            queries.data_ptr(),
            queries.stride(0),
            queries.stride(1),
            r,
            n,
            tables.data_ptr(),
            cap,
            hist.data_ptr(),
            _build.stream_handle(queries.device),
        )
    _build.check_launch("rank_hist", err)
    _build.LAUNCHES["rank_hist_counts"] += 1
    return hist


def _check_rank_hist_args(queries: torch.Tensor, tables: torch.Tensor) -> Tuple[int, int]:
    if queries.dim() != 2 or tables.dim() != 2:
        raise ValueError("queries and tables must be 2-D.")
    if queries.dtype != torch.float32 or tables.dtype != torch.float32:
        raise TypeError(
            f"rank_hist_counts takes float32, got {queries.dtype} and {tables.dtype}."
        )
    if queries.device != tables.device:
        raise ValueError("queries and tables must be on one device.")
    r, n = queries.shape
    if tables.shape[0] != r:
        raise ValueError(f"tables has {tables.shape[0]} rows; expected {r}.")
    cap = tables.shape[1]
    if cap % _FW != 0 or cap == 0:
        raise ValueError(f"table capacity {cap} must be a positive multiple of {_FW}")
    if n >= 2**31:
        raise ValueError(f"rank_hist_counts requires N < 2^31 (int32 counts), got {n}.")
    return r, n


def _rank_hist_counts_plain(queries: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """The kernel's histogram in plain PyTorch: ``searchsorted(right=True)
    − 1`` gives each query's bin, and one int32 count of ``row·cap + bin``
    over the in-range, non-NaN queries gives the histogram."""
    _build.PLAIN_CALLS["rank_hist_counts"] += 1
    r, cap = tables.shape
    bins = torch.searchsorted(tables.contiguous(), queries.contiguous(), right=True) - 1
    valid = (bins >= 0) & ~torch.isnan(queries)
    rows = torch.arange(r, device=queries.device)[:, None]
    flat = torch.where(valid, rows * cap + bins, r * cap)
    return _index_counts(flat.reshape(-1), r * cap + 1)[: r * cap].view(r, cap)


def _suffix_cumsum(x: torch.Tensor) -> torch.Tensor:
    """int32 ``Σ_{k ≥ j} x[..., k]`` along the last axis."""
    return torch.cumsum(x.flip(-1), dim=-1, dtype=torch.int32).flip(-1)


def _index_counts(index: torch.Tensor, length: int) -> torch.Tensor:
    """int32 occurrence counts of in-range indices (a bincount that never
    waits for the device to size its output)."""
    counts = torch.zeros(length, dtype=torch.int32, device=index.device)
    return counts.index_add_(0, index, torch.ones_like(index, dtype=torch.int32))


def _pack_positive_tables(
    s: torch.Tensor, target: torch.Tensor, num_classes: int, cap: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class ascending tables of own-class scores, without any (C, N)
    sort: per-class counts, a stable N-element argsort of the targets for
    occupancy slots, one own-score gather, one scatter into the (C, cap)
    pack (+BIG pads) and a small (C, cap) row sort.  Targets must lie in
    ``[0, num_classes)``; a class past ``cap`` samples loses the overflow
    (the JAX scatter drops it too).  Returns ``(counts (C,), table)``."""
    n = s.shape[0]
    t = target.to(torch.int64)
    counts = _index_counts(t, num_classes)
    order = torch.argsort(t, stable=True)
    sorted_t = t[order]
    starts = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    occ = torch.arange(n, dtype=torch.int32, device=s.device) - starts[sorted_t]
    own = torch.gather(s, 1, t[:, None])[:, 0]
    # Column `cap` catches what the JAX scatter would drop, then goes.
    pack = torch.full((num_classes, cap + 1), _BIG, dtype=torch.float32, device=s.device)
    pack[sorted_t, occ.clamp(max=cap).to(torch.int64)] = own[order]
    return counts, torch.sort(pack[:, :cap], dim=1).values


def _pack_row_tables(
    scores: torch.Tensor, hits: torch.Tensor, cap: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row ascending tables of the hit-flagged scores, without any
    (R, N) sort: a row-wise cumsum gives each hit its slot, one scatter
    places them (the rest land in a dropped column), and a small (R, cap)
    row sort orders the pack (+BIG pads last).  Returns
    ``(counts (R,), table (R, cap))``."""
    r, n = scores.shape
    counts = torch.sum(hits, dim=1, dtype=torch.int32)
    occ = torch.cumsum(hits, dim=1, dtype=torch.int32) - 1
    col = torch.where(hits, occ, cap).clamp(max=cap).to(torch.int64)
    rows = torch.arange(r, device=scores.device)[:, None].expand(r, n)
    pack = torch.full((r, cap + 1), _BIG, dtype=torch.float32, device=scores.device)
    pack[rows, col] = scores
    return counts, torch.sort(pack[:, :cap], dim=1).values


def _auroc_from_rank_sums(
    queries: torch.Tensor, table: torch.Tensor, counts: torch.Tensor
) -> torch.Tensor:
    """The exactness-critical U-statistic core shared by the multiclass and
    binary routes: ONE stacked :func:`rank_sum_counts` call for both passes
    (the strict pass counts ``−q`` against ``−table`` reversed, which is
    ascending, since f32 negation is exact), then :func:`_auroc_from_counts`.
    Raises past the int32 exactness bound ``cap·N < 2^29``."""
    n = queries.shape[1]
    cap = table.shape[1]
    if cap * n >= 2**29:
        raise ValueError(
            f"cap·N = {cap * n} exceeds the exact-int32 bound 2^29; "
            "use the sort path for this shape"
        )
    tables = torch.cat([table, -table.flip(1)])
    k = rank_sum_counts(queries, tables, negate=True)
    return _auroc_from_counts(k, counts, n, cap)


def _auroc_from_counts(
    k: torch.Tensor, counts: torch.Tensor, n: int, cap: int
) -> torch.Tensor:
    """``2U = 2nN − K_A − N·cap + K_B − n²`` in int32, in the JAX order, and
    ``U/(n(N−n))`` with the degenerate-row 0.5 convention; ``k`` stacks
    ``K_A`` over ``K_B``."""
    r = counts.shape[0]
    k_a, k_b = k[:r], k[r:]
    two_u = 2 * counts * n - k_a - n * cap + k_b - counts * counts
    c = counts.to(torch.float32)
    factor = c * float(np.float32(n)) - c * c
    return torch.where(factor == 0, 0.5, two_u.to(torch.float32) / (2.0 * factor))


def multiclass_auroc_ustat(
    scores: torch.Tensor,
    target: torch.Tensor,
    *,
    num_classes: int,
    average: Optional[str],
    cap: int,
) -> torch.Tensor:
    """Exact one-vs-rest AUROC from ``(N, C)`` scores without the big sort.
    ``cap`` must be ≥ the largest per-class count (the route computes it),
    targets must lie in ``[0, C)`` and scores must satisfy |s| < 3.0e38."""
    s = scores.to(torch.float32)
    counts, table = _pack_positive_tables(s, target, num_classes, cap)
    auroc = _auroc_from_rank_sums(s.T, table, counts)
    return auroc.mean() if average == "macro" else auroc


def binary_auroc_ustat(
    scores: torch.Tensor,
    target: torch.Tensor,
    *,
    cap: int,
    table_side: str = "pos",
) -> torch.Tensor:
    """Exact per-row binary AUROC from ``(R, N)`` scores / 0-1 targets
    without the row sort (the rare-class regime).  ``table_side="neg"``
    packs the negatives and returns ``1 − U/(n·m)``, the mirror identity,
    for rare-negative data."""
    s = scores.to(torch.float32)
    hits = (target != 0) if table_side == "pos" else (target == 0)
    counts, table = _pack_row_tables(s, hits, cap)
    u_frac = _auroc_from_rank_sums(s, table, counts)
    # Degenerate rows are 0.5, which the mirror identity maps to itself.
    return u_frac if table_side == "pos" else 1.0 - u_frac


def _ap_from_hist(
    table: torch.Tensor, counts: torch.Tensor, hist: torch.Tensor
) -> torch.Tensor:
    """Step-sum AP rows from a per-entry rank histogram: ``num_ge`` by
    suffix sums, ``TP`` by position in the ascending table (the first index
    of each tie group handles ties), summed precisions divided by the
    positive count (``auprc.py:_auprc_rows`` semantics; zero positives →
    0)."""
    r, cap = table.shape
    num_ge = _suffix_cumsum(hist)
    idx = torch.arange(cap, dtype=torch.int32, device=table.device)[None, :]
    is_new = torch.cat(
        [
            torch.ones((r, 1), dtype=torch.bool, device=table.device),
            table[:, 1:] != table[:, :-1],
        ],
        dim=1,
    )
    first_idx = torch.cummax(torch.where(is_new, idx, -1), dim=1).values
    tp = counts[:, None] - first_idx
    real = idx < counts[:, None]
    precision = torch.where(
        real,
        tp.to(torch.float32) / torch.clamp(num_ge, min=1).to(torch.float32),
        0.0,
    )
    ap = precision.sum(dim=1) / torch.clamp(counts, min=1).to(torch.float32)
    return torch.where(counts == 0, 0.0, ap)


def multiclass_auprc_ustat(
    scores: torch.Tensor,
    target: torch.Tensor,
    *,
    num_classes: int,
    average: Optional[str],
    cap: int,
) -> torch.Tensor:
    """Exact one-vs-rest average precision from ``(N, C)`` scores without
    the big sort: the packed positive tables give ``TP`` by position and
    ONE :func:`rank_hist_counts` launch gives the ``#{q ≥ t_v}``
    denominators.  Same preconditions as :func:`multiclass_auroc_ustat`."""
    s = scores.to(torch.float32)
    counts, table = _pack_positive_tables(s, target, num_classes, cap)
    hist = rank_hist_counts(s.T, table)
    ap = _ap_from_hist(table, counts, hist)
    return ap.mean() if average == "macro" else ap


def binary_auprc_ustat(
    scores: torch.Tensor, target: torch.Tensor, *, cap: int
) -> torch.Tensor:
    """Exact per-row step-sum average precision from ``(R, N)`` scores /
    0-1 targets without the row sort (the rare-positive regime; AP is
    anchored on the positives, so only they pack).  Same preconditions as
    :func:`multiclass_auprc_ustat`."""
    s = scores.to(torch.float32)
    counts, table = _pack_row_tables(s, target == 1, cap)
    hist = rank_hist_counts(s, table)
    return _ap_from_hist(table, counts, hist)


def _win_cap(most: float, n: int) -> Optional[int]:
    """Bucket a measured max class count to the static table capacity iff
    the (cap, N) point sits in the route's win region (kept exactly from
    the JAX package): cap a power of two ≥ 16, at most 512 and at most
    N/128, N ≥ 2^15, and cap·N < 2^29 so the int32 rank sums stay exact.
    ONE definition serves the binary and multiclass routes."""
    cap = _FW
    while cap < most:
        cap *= 2
    if cap > 512 or n < 2**15 or cap > n // 128 or cap * n >= 2**29:
        return None
    return cap


def _route_stats(
    scores: torch.Tensor, target: torch.Tensor, num_classes: int
) -> List[float]:
    """``[min, max, largest per-class count, targets in range]`` with ONE
    read back from the device.  The range flag is the port's own: a target
    outside ``[0, C)`` keeps the sort path, whose one-vs-rest hits ignore
    it, as the JAX package does on every backend but the TPU."""
    t = target.to(torch.int64)
    in_range = (t.min() >= 0) & (t.max() < num_classes)
    counts = _index_counts(t.clamp(0, num_classes - 1), num_classes)
    return torch.stack(
        [
            scores.min().to(torch.float32),
            scores.max().to(torch.float32),
            counts.max().to(torch.float32),
            in_range.to(torch.float32),
        ]
    ).tolist()


def ustat_route_cap(
    scores: torch.Tensor, target: torch.Tensor, num_classes: int
) -> Optional[int]:
    """Call-time route decision for the multiclass rank-sum path: the
    static table capacity, or None to keep the sort path (route switch
    set, non-finite or huge scores, targets out of range, class-skewed
    data, and beyond the int32 count bounds; see :func:`_win_cap`)."""
    n = scores.shape[0]
    if n == 0 or _win_cap(1, n) is None:
        return None  # no cap can pass at this N: skip the device read
    if ustat_disabled():
        return None
    lo, hi, max_count, in_range = _route_stats(scores, target, num_classes)
    if not in_range or not (lo > -_BIG and hi < _BIG):
        return None
    return _win_cap(max_count, n)


def _binary_route_stats(scores: torch.Tensor, target: torch.Tensor) -> List[float]:
    """Score bounds, the count of targets outside {0, 1}, and the per-row
    positive and negative count maxima, with ONE read back."""
    pos = torch.sum(target != 0, dim=-1, dtype=torch.int32)
    neg = scores.shape[-1] - pos
    non01 = torch.sum((target != 0) & (target != 1), dtype=torch.int32)
    return torch.stack(
        [
            scores.min().to(torch.float32),
            scores.max().to(torch.float32),
            non01.to(torch.float32),
            pos.max().to(torch.float32),
            neg.max().to(torch.float32),
        ]
    ).tolist()


def binary_ustat_route(
    scores: torch.Tensor, target: torch.Tensor, *, need_pos: bool = False
) -> Optional[Tuple[str, int]]:
    """Call-time route decision for the binary (R, N) rank-sum path:
    ``(table_side, cap)`` or None.  Shares :func:`_win_cap`'s win region
    and additionally requires exactly-0/1 targets; with ``need_pos`` (AP)
    only the positive side packs."""
    if scores.dim() != 2:
        return None
    n = scores.shape[1]
    if _win_cap(1, n) is None or ustat_disabled():
        return None
    lo, hi, non01, max_pos, max_neg = _binary_route_stats(scores, target)
    if not (lo > -_BIG and hi < _BIG) or non01 != 0.0:
        return None
    for side, most in (("pos", max_pos), ("neg", max_neg)):
        if need_pos and side != "pos":
            continue
        cap = _win_cap(most, n)
        if cap is not None:
            return side, cap
    return None


__all__: Tuple[str, ...] = (
    "rank_sum_counts",
    "rank_hist_counts",
    "multiclass_auroc_ustat",
    "multiclass_auprc_ustat",
    "binary_auroc_ustat",
    "binary_auprc_ustat",
    "binary_ustat_route",
    "ustat_route_cap",
)
