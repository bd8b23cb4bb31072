"""The schedule of the rank kernels (``csrc/rank_sum.cu``,
``csrc/rank_hist.cu`` over ``csrc/query_ring.cuh``), checked on the CPU.

The kernels cannot run here; their launch plan (``ops/ustat.py::_rank_plan``,
what the wrappers pass to the kernels) and their schedule can.  A numpy
model walks the plan as the kernels do: each block its row group's tiles,
each tile staged into a ring of four buffers by 16-byte copies (zero-filled
past the view) or 4-byte copies, each warp 8 slots of a tile with their
searches in flight, unguarded at the route's capacities.  The model checks
that every (row, query) is read from the right address and counted exactly
once, by the block, warp, lane and slot the kernel gives it, and that its
counts equal the plain versions and the JAX kernels in interpret mode.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.ops import pallas_ustat as jx
from torcheval_tpu_torch.ops import ustat

_BIG = 3.0e38
_STALE = 7.0e37  # what a ring cell holds before any copy reaches it


def _queries(layout, rng, rq, n):
    """``(flat, offset, stride_row, stride_col)`` of ``(rq, n)`` queries on
    a 1/4 grid, and the torch view of them:
    "columns": the (N, C) buffer read as (C, N) (G = 32);
    "offset": ``buf[:, 1:]`` of an (N, rq + 1) buffer (a base 4 bytes past
    alignment); "narrow": ``buf[:, :rq]`` of an (N, rq + 1) buffer;
    "rows": contiguous rows (G = 1); "gather": one column of an (N, 5)
    buffer, a single row at stride 5."""
    width = {"offset": rq + 1, "narrow": rq + 1, "gather": 5}.get(layout, rq)
    if layout == "rows":
        flat = (rng.integers(-9, 9, rq * n) / 4).astype(np.float32)
        view = (0, n, 1)
    else:
        flat = (rng.integers(-9, 9, n * width) / 4).astype(np.float32)
        view = {"offset": (1, 1, width), "gather": (2, 1, width)}.get(layout, (0, 1, width))
    offset, sr, sc = view
    t = torch.from_numpy(flat).as_strided((rq, n), (sr, sc), offset)
    return flat, offset, sr, sc, t


def _tables(rng, r, cap, negate):
    t = np.sort((rng.integers(-8, 8, (r, cap)) / 4).astype(np.float32), axis=1)
    t[:, cap - 3 :] = _BIG
    if negate:
        neg = np.sort((rng.integers(-8, 8, (r, cap)) / 4).astype(np.float32), axis=1)
        neg[:, :3] = -_BIG
        t = np.concatenate([t, neg])
    t[min(1, r - 1)] = _BIG  # a row without positives
    return t


def _search(tab, x, cap, fixed):
    """``count_le.cuh``'s interleaved searches on numpy arrays: ``tab`` (L,
    cap) the lanes' tables, ``x`` (S, L) their queries; ``fixed``: the fixed,
    unguarded steps (``count_le_shared``), which must never probe past the
    table, else the guarded ones (``count_le_many``)."""
    top = 1 << (cap.bit_length() - 1)
    lanes = np.arange(tab.shape[0])[None, :]
    lo = np.zeros(x.shape, np.int64)
    step = top >> 1 if fixed else top
    while step:
        probe = lo + step
        if fixed:
            assert probe.max() - 1 < cap
            take = tab[lanes, probe - 1] <= x
        else:
            inside = probe <= cap
            take = inside & (tab[lanes, np.minimum(probe, cap) - 1] <= x)
        lo = np.where(take, probe, lo)
        step >>= 1
    if fixed:
        assert lo.max() < cap
        lo = lo + (tab[lanes, lo] <= x)
    return lo


def _model(flat, offset, sr, sc, rq, n, tables, plan, *, negate=False, hist=False):
    """Run ``plan`` as the kernel does; returns the counts (rank_sum) or the
    histogram (rank_hist), and who took each (row, query)."""
    g, bpg = plan.group_rows, plan.blocks_per_group
    cap = tables.shape[1]
    vec16 = plan.copy == "16 B"
    out = np.zeros(2 * rq if negate else rq, np.int64)
    counts = np.zeros((rq, cap), np.int64)
    owner = np.full((rq, n, 5), -1, np.int64)  # block, tile, warp, slot, lane
    seen = np.zeros((rq, n), np.int64)
    garbage = np.random.default_rng(0).normal(size=(32, cap)).astype(np.float32)
    for block in range(plan.blocks):
        group, j = divmod(block, bpg)
        row0 = group * g
        rows = min(g, rq - row0)
        ring = np.full((plan.stages, 64 * 32), _STALE, np.float32)
        for k, t in enumerate(range(j, plan.tiles, bpg)):
            tile = ring[k % plan.stages]
            if g == 32:
                q0, width = t * 64, min(64, n - t * 64)
                cells = [(s, c, offset + (row0 + c) * sr + (q0 + s) * sc)
                         for s in range(width) for c in range(rows)]
            else:
                q0, width = t * 2048, min(2048, n - t * 2048)
                cells = [(i // 32, i % 32, offset + row0 * sr + (q0 + i) * sc)
                         for i in range(width)]
            if vec16:  # four adjacent cells from one aligned 16-byte source
                for s, c, addr in cells:
                    if c % 4 == 0:
                        assert (4 * addr) % 16 == 0
                        tile[s * 32 + c : s * 32 + c + 4] = 0.0  # the zero fill
                for s, c, addr in cells:
                    tile[s * 32 + c] = flat[addr]
            else:
                for s, c, addr in cells:
                    tile[s * 32 + c] = flat[addr]
            x = tile.reshape(64, 32)
            s_idx, lane = np.meshgrid(np.arange(64), np.arange(32), indexing="ij")
            if g == 32:
                holds = (q0 + s_idx < n) & (lane < rows)
                row = np.where(holds, row0 + lane, 0)
                q = q0 + s_idx
            else:
                holds = q0 + 32 * s_idx + lane < n
                row = np.full_like(lane, row0)
                q = q0 + 32 * s_idx + lane
            # The kernel's count of live slots (query_ring.cuh::live_slots)
            # for warp s // 8, lane: slot s % 8 holds a query iff below it.
            w = s_idx // 8
            if g == 32:
                live = np.where(lane < rows, np.clip(n - t * 64 - 8 * w, 0, 8), 0)
            else:
                m = n - t * 2048 - 256 * w - lane
                live = np.clip(np.where(m > 0, (m + 31) // 32, 0), 0, 8)
            np.testing.assert_array_equal(s_idx % 8 < live, holds)
            assert (x[holds] == flat[offset + row[holds] * sr + q[holds] * sc]).all()
            seen[row[holds], q[holds]] += 1
            who = np.stack([np.full_like(lane, block), np.full_like(lane, t),
                            s_idx // 8, s_idx % 8, lane], axis=-1)
            owner[row[holds], q[holds]] = who[holds]
            shared = plan.tables == "shared"
            assert plan.fixed_top in (0, cap)
            fixed = plan.fixed_top > 0

            def lane_tables(base):
                if g == 1:
                    return np.repeat(tables[base + row0][None], 32, axis=0)
                live = np.arange(32) < rows
                rows_ix = base + row0 + np.minimum(np.arange(32), rows - 1)
                # Shared memory holds no table for a dead lane; global
                # memory reads the last row's.
                return np.where(live[:, None], tables[rows_ix], garbage if shared else
                                tables[rows_ix])

            la = _search(lane_tables(0), x, cap, fixed)
            if hist:
                for r, v in zip(row[holds & (la > 0)], la[holds & (la > 0)] - 1):
                    counts[r, v] += 1
            else:
                np.add.at(out, row[holds], la[holds])
                if negate:
                    lb = _search(lane_tables(rq), -x, cap, fixed)
                    np.add.at(out, rq + row[holds], lb[holds])
    assert (seen == 1).all(), "every (row, query) exactly once"
    return (counts if hist else out), owner


def _expected_owner(plan, rq, n):
    """The closed form of who takes (row, q): block, tile, warp, slot, lane."""
    row, q = np.meshgrid(np.arange(rq), np.arange(n), indexing="ij")
    g, bpg = plan.group_rows, plan.blocks_per_group
    if g == 32:
        tile, s, lane = q // 64, q % 64, row % 32
    else:
        tile, s, lane = q // 2048, (q % 2048) // 32, q % 32
    block = (row // g) * bpg + tile % bpg
    return np.stack([block, tile, s // 8, s % 8, lane], axis=-1)


# (layout, rq, n, cap, negate, sms): G = 32 tiles hold 64 samples, G = 1
# tiles 2048; sms = 1 gives each block several tiles (the ring turns).
_CASES = [
    ("columns", 1000, 63, 256, True, 132),  # less than one tile, 16-byte copies
    ("columns", 31, 64, 16, True, 132),  # one tile; pitch 31: 4-byte copies
    ("columns", 32, 65, 512, True, 132),  # a tile and one sample
    ("columns", 33, 127, 256, False, 132),  # a tile short of two
    ("columns", 40, 1000, 64, True, 1),  # 16 tiles through one block's ring
    ("narrow", 999, 65, 256, True, 132),  # buf[:, :999] of 1000: zero-filled copies
    ("offset", 40, 100, 16, True, 132),  # buf[:, 1:]: 4-byte copies
    ("columns", 33, 100, 80, True, 132),  # cap 80: guarded steps in shared memory
    ("columns", 32, 70, 768, True, 132),  # the largest shared-memory cap
    ("columns", 33, 70, 784, True, 132),  # one past shared memory: global tables
    ("rows", 1, 2047, 256, True, 132),  # G = 1, a tile short
    ("rows", 1, 2048, 16, False, 132),  # G = 1, one tile
    ("rows", 3, 2049, 512, True, 132),  # pitch 2049: 4-byte copies
    ("rows", 2, 4096 * 3 + 5, 256, True, 1),  # seven tiles through each row's ring
    ("rows", 1, 3000, 1024, True, 132),  # a power of two past 512: guarded steps
    ("rows", 2, 100, 24_720, True, 132),  # G = 1 past shared memory
    ("gather", 1, 3000, 32, True, 132),  # one row at stride 5: 4-byte gathers
]


def _case_id(case):
    layout, rq, n, cap, negate, sms = case
    return f"{layout}-{rq}x{n}-cap{cap}{'-neg' if negate else ''}-sms{sms}"


@pytest.mark.parametrize("case", _CASES, ids=_case_id)
def test_rank_sum_schedule_model_equals_plain_and_jax(case):
    layout, rq, n, cap, negate, sms = case
    rng = np.random.default_rng(rq * 7 + n + cap)
    flat, offset, sr, sc, q = _queries(layout, rng, rq, n)
    tables = _tables(rng, rq, cap, negate)
    t = torch.from_numpy(tables)
    plan = ustat.rank_sum_plan(q, t, negate=negate, sms=sms)
    got, owner = _model(flat, offset, sr, sc, rq, n, tables, plan, negate=negate)
    np.testing.assert_array_equal(owner, _expected_owner(plan, rq, n))
    want = ustat._rank_sum_counts_plain(q, t, negate=negate).numpy()
    np.testing.assert_array_equal(got, want)
    if cap <= 1024 and rq <= 64:
        stacked = np.concatenate([q.numpy(), -q.numpy()]) if negate else q.numpy()
        jax_counts = jx.rank_sum_counts(
            jnp.asarray(np.ascontiguousarray(stacked)), jnp.asarray(tables),
            interpret=True, tile=128,
        )
        np.testing.assert_array_equal(got, np.asarray(jax_counts))


@pytest.mark.parametrize("case", _CASES, ids=_case_id)
def test_rank_hist_schedule_model_equals_plain_and_jax(case):
    layout, rq, n, cap, _, sms = case
    cap = {784: 784, 24_720: 24_976}.get(cap, cap)  # rank_hist's own first global caps
    rng = np.random.default_rng(rq * 5 + n + cap)
    flat, offset, sr, sc, q = _queries(layout, rng, rq, n)
    tables = _tables(rng, rq, cap, False)
    t = torch.from_numpy(tables)
    plan = ustat.rank_hist_plan(q, t, sms=sms)
    got, owner = _model(flat, offset, sr, sc, rq, n, tables, plan, hist=True)
    np.testing.assert_array_equal(owner, _expected_owner(plan, rq, n))
    np.testing.assert_array_equal(got, ustat._rank_hist_counts_plain(q, t).numpy())
    assert not got[min(1, rq - 1)].any()
    if cap <= 1024 and rq <= 64:
        jax_hist = jx.rank_hist_counts(
            jnp.asarray(np.ascontiguousarray(q.numpy())), jnp.asarray(tables),
            interpret=True, tile=128,
        )
        np.testing.assert_array_equal(got, np.asarray(jax_hist))


_HEADLINE = dict(rq=1000, n=131072, cap=256, stride_row=1, stride_col=1000, data_ptr=0)


@pytest.mark.parametrize(
    "name,args,kind,want",
    [
        # the headline AUROC: 32 groups of 32 classes, 8 blocks each, 2 an SM
        ("headline rank_sum", _HEADLINE, "sum2",
         (32, "16 B", "shared", 256, 64, 4, 2048, 32, 8, 98_304, 2)),
        ("headline rank_hist", _HEADLINE, "hist",
         (32, "16 B", "shared", 256, 64, 4, 2048, 32, 8, 98_304, 2)),
        ("binary rows (4, 2^20), cap 512", dict(rq=4, n=2**20, cap=512, stride_row=2**20,
                                                stride_col=1, data_ptr=256), "sum2",
         (1, "16 B", "shared", 512, 2048, 4, 512, 4, 66, 36_864, 2)),
        ("C = 999", dict(_HEADLINE, rq=999, stride_col=999), "sum2",
         (32, "4 B", "shared", 256, 64, 4, 2048, 32, 8, 98_304, 2)),
        ("scores[:, 1:]", dict(_HEADLINE, rq=999, data_ptr=4), "hist",
         (32, "4 B", "shared", 256, 64, 4, 2048, 32, 8, 98_304, 2)),
        ("scores[:, :999], one table", dict(_HEADLINE, rq=999), "sum1",
         (32, "16 B", "shared", 0, 64, 4, 2048, 32, 8, 65_536, 2)),
        ("cap 768 (not a power of two), one block an SM", dict(_HEADLINE, cap=768), "sum2",
         (32, "16 B", "shared", 0, 64, 4, 2048, 32, 4, 229_376, 1)),
        ("cap 784: global tables", dict(_HEADLINE, cap=784), "sum2",
         (32, "16 B", "global", 0, 64, 4, 2048, 32, 8, 32_768, 2)),
        ("rank_hist cap 784", dict(_HEADLINE, cap=784), "hist",
         (32, "16 B", "global", 0, 64, 4, 2048, 32, 8, 32_768, 2)),
        ("cap 80", dict(_HEADLINE, cap=80), "sum2",
         (32, "16 B", "shared", 0, 64, 4, 2048, 32, 8, 53_248, 2)),
        ("cap 1024, G = 1", dict(rq=2, n=5000, cap=1024, stride_row=5000, stride_col=1,
                                 data_ptr=0), "sum2",
         (1, "16 B", "shared", 0, 2048, 4, 3, 2, 3, 40_960, 2)),
        ("one row, stride 5", dict(rq=1, n=3000, cap=32, stride_row=1, stride_col=5,
                                   data_ptr=8), "sum2",
         (1, "4 B", "shared", 32, 2048, 4, 2, 1, 2, 33_024, 2)),
        ("one row, 4 bytes past alignment", dict(rq=1, n=3000, cap=32, stride_row=3000,
                                                 stride_col=1, data_ptr=4), "hist",
         (1, "4 B", "shared", 32, 2048, 4, 2, 1, 2, 33_024, 2)),
        ("rows at an odd pitch", dict(rq=3, n=2049, cap=512, stride_row=2049,
                                      stride_col=1, data_ptr=0), "sum2",
         (1, "4 B", "shared", 512, 2048, 4, 2, 3, 2, 36_864, 2)),
        ("G = 1 past shared memory", dict(rq=2, n=100, cap=24_720, stride_row=100,
                                          stride_col=1, data_ptr=0), "sum2",
         (1, "16 B", "global", 0, 2048, 4, 1, 2, 1, 32_768, 2)),
        ("more groups than blocks", dict(_HEADLINE, rq=32 * 300, n=5000), "hist",
         (32, "16 B", "shared", 256, 64, 4, 79, 300, 1, 98_304, 2)),
        ("n = 0", dict(_HEADLINE, n=0), "sum2",
         (32, "16 B", "shared", 256, 64, 4, 0, 32, 1, 98_304, 2)),
    ],
    ids=lambda v: v if isinstance(v, str) and " " in v else "",
)
def test_launch_plan(name, args, kind, want):
    plan = ustat._rank_plan(
        **args, tables=2 if kind == "sum2" else 1, hist=kind == "hist"
    )
    assert tuple(plan) == want, name
    assert plan.blocks == plan.groups * plan.blocks_per_group
    static = 0 if kind == "hist" else ustat._RANK_SUM_STATIC
    assert plan.smem_bytes + static <= ustat._BLOCK_SMEM
    assert plan.blocks_per_sm * (plan.smem_bytes + static + ustat._BLOCK_RESERVED) <= ustat._SM_SMEM
    assert plan.blocks_per_group <= max(1, plan.tiles)


def test_plan_reads_the_tensors_strides_and_address():
    buf = torch.zeros(2048, 1001)
    cols = buf[:, :1000].T  # the (C, N) view of an (N, C) buffer
    tables = torch.zeros(1000, 256)
    assert ustat.rank_hist_plan(cols, tables).copy == "4 B"  # pitch 1001
    buf = torch.zeros(2048, 1000)
    assert ustat.rank_hist_plan(buf.T, tables).copy == "16 B"
    assert ustat.rank_hist_plan(buf[:, 1:].T, tables[1:]).copy == "4 B"
    plan = ustat.rank_sum_plan(buf.T, torch.zeros(2000, 256), negate=True, sms=66)
    assert (plan.group_rows, plan.blocks_per_group) == (32, 4)
    assert "G=32, cp.async 16 B, shared tables, fixed steps" in plan.describe()


def test_plan_constants_match_the_kernel_sources():
    """The plan's copies of the kernels' compile-time constants: the ring
    (``query_ring.cuh``), blocks an SM (``__launch_bounds__``), rank_sum's
    reduction buffer, and the caps with fixed search steps
    (``count_le.cuh::with_top``), which the C entries refuse past."""
    csrc = Path(ustat.__file__).parent / "csrc"
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", (csrc / "query_ring.cuh").read_text()))
    assert int(const["kThreads"]) == 32 * ustat._RING_WARPS
    assert int(const["kSlots"]) == ustat._RING_SLOTS
    assert int(const["kStages"]) == ustat._RING_STAGES
    for name in ("rank_sum.cu", "rank_hist.cu"):
        bounds = re.findall(r"__launch_bounds__\(kThreads, (\d+)\)", (csrc / name).read_text())
        assert bounds == [str(ustat._BLOCKS_PER_SM)], name
    assert "__shared__ int red[2][kWarps][32];" in (csrc / "rank_sum.cu").read_text()
    assert ustat._RANK_SUM_STATIC == 2 * ustat._RING_WARPS * 32 * 4
    le = (csrc / "count_le.cuh").read_text()
    with_top = le[le.index("inline auto with_top") :]
    with_top = with_top[: with_top.index("\n}\n")]
    caps = re.findall(r"case (\d+): return f\(std::integral_constant<int, (\d+)>", with_top)
    assert all(a == b for a, b in caps)
    assert tuple(int(a) for a, _ in caps) == ustat._FIXED_CAPS

