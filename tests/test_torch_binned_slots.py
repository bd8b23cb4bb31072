"""The binned count kernel's arithmetic and schedule, modelled on the CPU:
``csrc/binned_count.cu`` and ``count_le.cuh`` have no CPU mode, so their
slot rule (``slot_of``: a guess from the grid's ends, a walk of at most
``kWalk`` steps, a binary search past it; ``slots_of``: the guesses'
probes issued together), the launch plan's visit of every (row, sample)
and the suffix kernel's chunked scan are held here as numpy models against
``bucketize`` and ``_counts_from_hist``."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from torcheval_tpu_torch.metrics.functional.classification.binned_precision_recall_curve import (
    _linspace_grid,
)
from torcheval_tpu_torch.ops import binned
from torcheval_tpu_torch.ops.binned import _counts_from_hist, binned_count_plan
from torcheval_tpu_torch.parallel.sync import _grid_np

_CSRC = Path(binned.__file__).resolve().parent / "csrc"
_WALK = 4  # count_le.cuh's kWalk
_WARPS, _PER = 16, 8  # binned_count.cu's kWarps, kPer
_SUFFIX_PER = 8  # kSuffixPer
_CELL, _CELL_THREADS = 64, 256  # kCell, kCellThreads
_DRAWS = 20_000


def _constant(source: str, name: str) -> int:
    text = (_CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


def test_model_constants_match_the_kernel_sources():
    assert _constant("count_le.cuh", "kWalk") == _WALK
    assert _constant("binned_count.cu", "kWarps") == _WARPS == binned._COUNT_WARPS
    assert _constant("binned_count.cu", "kPer") == _PER == binned._COUNT_PER_LANE
    assert _constant("binned_count.cu", "kSuffixPer") == _SUFFIX_PER
    assert _constant("binned_count.cu", "kCell") == _CELL == binned._CELL
    assert _constant("binned_count.cu", "kPrivateTilesPerWarp") == binned._PRIVATE_TILES_PER_WARP
    assert _constant("binned_count.cu", "kCellThreads") == _CELL_THREADS
    text = (_CSRC / "binned_count.cu").read_text()
    assert "t + 1 <= 128 * kSuffixPer ? launch_suffix<128>" in text
    assert re.findall(r"launch_suffix<(\d+)>\(", text) == ["128", "256"]
    # The private route's shared memory: the wrapper's copy of the formula
    # is the source's, evaluated at sizes around its roundings.
    expr = re.search(r"long long private_smem\(int t\) \{.*?return (.*?);\n\}", text, re.S).group(1)
    expr = re.sub(r"\(long long\)", "", expr).replace("LL", "").replace("/", "//")
    for t in (1, 2, 3, 4, 5, 62, 63, 64, 65, 127, 10_000, 16_384, 58_000):
        assert eval(expr, {"t": t, "t1": t + 1, "kCell": _CELL}) == binned._private_smem(t), t
    # slot_of lives in the shared header, used by both binned kernels.
    for source in ("binned_count.cu", "binned_wcount.cu"):
        text = (_CSRC / source).read_text()
        assert '#include "count_le.cuh"' in text and "int slot_of(" not in text


# ------------------------------------------------------------- the slot rule


def _count_le(th: np.ndarray, x: np.ndarray) -> np.ndarray:
    """count_le<1>: the branchless upper bound over power-of-two steps."""
    t = th.size
    lo = np.zeros(x.shape, np.int64)
    step = 1 << (t.bit_length() - 1)
    while step:
        probe = lo + step
        ok = (probe <= t) & (th[np.minimum(probe, t) - 1] <= x)
        lo = np.where(ok, probe, lo)
        step >>= 1
    return lo


def _ends(th: np.ndarray):
    """lo and scale as the kernels compute them, in f32."""
    t = th.size
    lo, hi = th[0], th[-1]
    with np.errstate(all="ignore"):
        scale = np.float32(t - 1) / (hi - lo) if t > 1 and hi > lo else np.float32(0)
    return lo, np.float32(scale)


def _guess(th: np.ndarray, x: np.ndarray, lo, scale) -> np.ndarray:
    """slot_guess for x >= lo (other entries: any value in [1, T])."""
    t = th.size
    with np.errstate(all="ignore"):
        g = (x - lo) * scale
        inside = g < np.float32(t - 1)
        return np.where(inside, np.trunc(np.where(inside, g, 0)).astype(np.int64) + 1, t)


def _slot_of(th: np.ndarray, x: np.ndarray):
    """count_le.cuh's slot_of on f32 arrays: (slots, took the search)."""
    t = th.size
    lo, scale = _ends(th)
    nan = np.isnan(x)
    if scale == 0:
        return np.where(nan, t, _count_le(th, x)), ~nan
    below = ~nan & ~(x >= lo)
    k = np.where(below | nan, 1, _guess(th, x, lo, scale))
    done = below | nan
    for _ in range(_WALK):
        down = ~done & (th[k - 1] > x)
        up = ~done & ~down & (k < t) & (th[np.minimum(k, t - 1)] <= x)
        done |= ~down & ~up
        k = k - down + up
    search = ~done
    k = np.where(search, _count_le(th, x), k)
    return np.where(nan, t, np.where(below, 0, k)), search


def _slots_of(th: np.ndarray, x: np.ndarray) -> np.ndarray:
    """binned_count.cu's slots_of: a guess k stands when t[k-1] <= x <
    t[k] (t[T] read as +inf); any other sample takes slot_of."""
    t = th.size
    lo, scale = _ends(th)
    guessed = (scale != 0) & (x >= lo)
    k = np.where(guessed, _guess(th, x, lo, scale), 1)
    above = np.where(k < t, th[np.minimum(k, t - 1)], np.float32(np.inf))
    stands = guessed & (th[k - 1] <= x) & (x < above)
    return np.where(stands, k, _slot_of(th, x)[0]), stands


def _scores_for(th: np.ndarray, rng) -> np.ndarray:
    """Every threshold and one ulp either side, +-inf, +-0.0, NaN,
    subnormals, values outside [0, 1] and uniform draws."""
    up = np.nextafter(th, np.float32(np.inf))
    down = np.nextafter(th, np.float32(-np.inf))
    special = np.array(
        [np.inf, -np.inf, 0.0, -0.0, np.nan, 1e-45, -1e-45, 1e-40, -1e-40, 1.17549435e-38,
         -1.0, 2.0, 1e30, -1e30, 3.4e38, -3.4e38, 0.5, 1.0],
        np.float32,
    )
    uniform = rng.random(_DRAWS).astype(np.float32)
    return np.concatenate([th, up, down, special, uniform * 1.2 - 0.1])


def _bucketize(th: np.ndarray, x: np.ndarray) -> np.ndarray:
    got = torch.bucketize(torch.from_numpy(x), torch.from_numpy(th.copy()), right=True)
    return torch.where(torch.isnan(torch.from_numpy(x)), th.size, got).numpy()


_UNIFORM = {
    **{f"linspace T={t}": (lambda t=t: _linspace_grid(t, torch.device("cpu")).numpy())
       for t in (1, 2, 3, 200, 2048, 10_000, 16_384)},
    "bisected T=2048": lambda: _grid_np(2048),
    "bisected T=16384": lambda: _grid_np(16_384),
}
_OTHER = {
    "geometric (exhausts the walk)": lambda: np.geomspace(1e-6, 1.0, 1000).astype(np.float32),
    "equal ends": lambda: np.full(5, 0.5, np.float32),
    "steps of one value": lambda: np.repeat(np.float32([0.1, 0.4, 0.9]), 4),
}


@pytest.mark.parametrize("name", list(_UNIFORM) + list(_OTHER))
def test_slot_of_equals_bucketize_with_nan_at_t(name):
    th = np.asarray({**_UNIFORM, **_OTHER}[name](), np.float32)
    x = _scores_for(th, np.random.default_rng(th.size))
    want = _bucketize(th, x)
    slots, search = _slot_of(th, x)
    np.testing.assert_array_equal(slots, want)
    batched, stands = _slots_of(th, x)
    np.testing.assert_array_equal(batched, want)
    finite = np.isfinite(x) & (x >= th[0])
    if name in _UNIFORM and th.size > 1:
        # One or two probes: the guess stands for nearly every uniform
        # draw at or above the grid (below it slot_of answers 0 with no
        # probe), and no walk runs out.  (T = 1 has equal ends: count_le's
        # one step.)
        assert not search[finite].any()
        assert stands[-_DRAWS:][x[-_DRAWS:] >= th[0]].mean() > 0.99
    elif name.startswith("geometric"):
        assert search[finite].mean() > 0.5


# ----------------------------------------------------------- the launch plan


def _visits(plan, r: int, n: int):
    """(row, sample) of every load the count kernel's schedule makes:
    warps grid-stride over the plan's tiles, lanes and units as in
    binned_count.cu."""
    warps = plan.blocks * _WARPS
    tiles = np.concatenate([np.arange(w, plan.tiles, warps) for w in range(warps)])
    assert np.array_equal(np.sort(tiles), np.arange(plan.tiles))
    lane = np.arange(32)
    if plan.group_rows == 1:
        per_row = -(-n // (32 * _PER))
        assert plan.tiles == r * per_row
        row = np.repeat(tiles // per_row, 32 * _PER)
        if plan.vec:  # lane l: samples 4l .. 4l + 3 of each 128-sample half
            offsets = np.arange(_PER // 4)[:, None, None] * 128 + 4 * lane[:, None] + np.arange(4)
        else:  # lane l: samples l, l + 32, ..
            offsets = np.arange(_PER)[:, None] * 32 + lane
        q = ((tiles % per_row * 32 * _PER)[:, None] + offsets.reshape(1, -1)).reshape(-1)
    else:
        per_group = -(-n // _PER)
        assert plan.tiles == -(-r // 32) * per_group
        row = ((tiles // per_group * 32)[:, None, None] + lane[None, :, None]
               + np.zeros(_PER, np.int64)).reshape(-1)
        q = ((tiles % per_group * _PER)[:, None, None] + np.zeros((1, 32, 1), np.int64)
             + np.arange(_PER)).reshape(-1)
    keep = (q < n) & (row < r)
    return row[keep], q[keep]


def _views():
    """(label, scores, hits, expected group_rows, expected vec)."""
    def rows(r, n, offset=0):
        s = torch.rand(r, n + offset)[:, offset:]
        h = (torch.rand(r, n + offset) < 0.4)[:, offset:]
        return s, h

    buf = torch.rand(1003, 37)
    hits = torch.rand(37, 1003) < 0.3
    wide_hits = (torch.rand(37, 1009) < 0.3)[:, 1:1004]
    return [
        ("one row, N % 4 == 0", *rows(1, 4096), 1, True),
        ("one row, N = 1003", *rows(1, 1003), 1, True),
        ("4 contiguous rows of 1024", *rows(4, 1024), 1, True),
        ("3 rows of 1001 (a pitch not a multiple of 4)", *rows(3, 1001), 1, False),
        ("scores[:, 1:] (not 16-byte aligned)", *rows(2, 1025, offset=1), 1, False),
        ("a strided row", torch.rand(1, 2 * 777)[:, ::2], torch.rand(1, 777) < 0.5, 1, False),
        ("(C, N) class view of an (N, C) buffer, N = 1003", buf.T, hits, 32, False),
        ("(C, N) class view, hit rows of 1008", buf.T, (torch.rand(37, 1008) < 0.3)[:, :1003],
         32, True),
        ("(C, N) class view, hits not 8-byte aligned", buf.T, wide_hits, 32, False),
        ("(C, N) class view, 64 classes, N = 5000", torch.rand(5000, 64).T,
         torch.rand(64, 5000) < 0.5, 32, True),
    ]


@pytest.mark.parametrize("case", range(len(_views())), ids=[v[0] for v in _views()])
@pytest.mark.parametrize("t", [1, 200, 10_000, 70_000])
def test_launch_plan_visits_every_sample_once(case, t):
    label, s, h, group_rows, vec = _views()[case]
    r, n = s.shape
    plan = binned_count_plan(s, h, t, sms=8)
    assert (plan.group_rows, plan.vec) == (group_rows, vec), (label, plan.describe())
    fits = r == 1 and binned._private_smem(t) <= binned._MAX_SMEM
    if plan.private:  # a block an SM, below 2^16 samples a block
        assert fits and plan.smem
        assert plan.blocks == max(1, min(-(-plan.tiles // _WARPS), 8))
        assert -(-plan.tiles // (plan.blocks * _WARPS)) * _WARPS * 32 * _PER < 2**16
    else:
        assert not fits or -(-plan.tiles // (8 * _WARPS)) > 15
        assert plan.smem == (4 * t <= binned._MAX_SMEM)
        per_sm = binned._COUNT_BLOCKS_PER_SM
        if plan.smem:
            per_sm = min(per_sm, binned._MAX_SMEM // (4 * t))
        assert plan.blocks == max(1, min(-(-plan.tiles // _WARPS), 8 * per_sm))
    row, q = _visits(plan, r, n)
    np.testing.assert_array_equal(np.bincount(row * n + q, minlength=r * n), np.ones(r * n))


def test_plan_at_the_main_paths_shapes():
    # The binned lifecycle's update, the rank blocks of the sharded calls.
    one = binned_count_plan(torch.zeros(1, 2**19), torch.zeros(1, 2**19, dtype=torch.bool),
                            10_000)
    assert one == binned.CountPlan(1, True, True, True, 2048, 128)
    ns = binned_count_plan(torch.zeros(2**15, 1000).T, torch.zeros(1000, 2**15, dtype=torch.bool),
                           2048)
    assert (ns.group_rows, ns.vec, ns.smem, ns.private) == (32, True, True, False)
    assert ns.blocks == 132 * 2
    bs = binned_count_plan(torch.zeros(1, 2**20), torch.zeros(1, 2**20, dtype=torch.bool), 16_384)
    assert bs == binned.CountPlan(1, True, True, True, 4096, 132)
    assert "16-byte" in one.describe() and "private histogram" in bs.describe()
    # Past 15 tiles a warp, or slots and thresholds past shared memory: L2.
    assert not binned._count_plan(1, 2**23, 10_000, 1, True, 132).private
    assert not binned._count_plan(1, 2**19, 30_000, 1, True, 132).private
    assert "in L2" in binned._count_plan(2, 2**19, 10_000, 1, True, 132).describe()


# ----------------------------------------------------------- the suffix kernel


def _suffix_model(hist: np.ndarray, n: int):
    """binned_count.cu's suffix kernel: each row in chunks of threads x 8
    slots (128 threads for a row of at most 1024 slots, else 256), a block
    a chunk that sums every slot above
    it; in the chunk each thread's sum of its 8, a warp suffix scan, the
    later warps' sums, then each thread's slots from the top; unpacked."""
    r, t1 = hist.shape
    threads = 128 if t1 <= 128 * _SUFFIX_PER else 256
    size = threads * _SUFFIX_PER
    cum = np.zeros_like(hist)
    for row in range(r):
        for c0 in range(0, t1, size):
            carry = int(hist[row, c0 + size:].sum())
            idx = c0 + np.arange(threads)[:, None] * _SUFFIX_PER + np.arange(_SUFFIX_PER)
            v = np.where(idx < t1, hist[row, np.minimum(idx, t1 - 1)], 0)
            own = v.sum(1).reshape(-1, 32)
            below = own[:, ::-1].cumsum(1)[:, ::-1]  # this lane and later ones
            warp_sum = below[:, 0]
            later = warp_sum[::-1].cumsum()[::-1] - warp_sum  # later warps
            run = (carry + later[:, None] + below - own).reshape(-1)
            for j in range(_SUFFIX_PER - 1, -1, -1):
                run = run + v[:, j]
                ok = idx[:, j] < t1
                cum[row, idx[ok, j]] = run[ok]
    hit = (cum & 0xFFFFFFFF).astype(np.int32)
    num_tp = hit[:, 1:]
    num_fp = (cum[:, 1:] >> 32).astype(np.int32) - num_tp
    return num_tp, num_fp, hit[:, 0], np.full(r, n, np.int32)


@pytest.mark.parametrize("r,t", [(1, 1), (3, 200), (1, 1023), (2, 1024), (1, 2047), (32, 2048),
                                 (1, 10_000), (1, 20_000)])
def test_suffix_kernel_model_equals_counts_from_hist(r, t):
    rng = np.random.default_rng(t)
    total = rng.integers(0, 5000, (r, t + 1))
    hits = rng.integers(0, total + 1)
    hist = (total << 32) | hits
    n = int(total.sum(1).max())
    want = _counts_from_hist(torch.from_numpy(hist), n)
    for got, w in zip(_suffix_model(hist, n), want):
        np.testing.assert_array_equal(got, w.numpy())


def _private_model(counts: np.ndarray, hits: np.ndarray, n: int):
    """binned_count.cu's private route from each block's histogram
    (``counts``, ``hits``: (blocks, T + 1)): a block's slots as
    (count << 16) | hits in uint32 and its cells' suffix sums, then the
    cell suffix kernel: a cell's slots summed over the copies widened to
    (count << 32) | hits, the next cell's sums over the copies above it,
    and a warp's scan two slots a lane."""
    blocks, t1 = counts.shape
    assert counts.sum(1).max() < 2**16
    copies = (counts.astype(np.uint32) << 16) | hits.astype(np.uint32)
    cells = -(-t1 // _CELL)
    padded = np.zeros((blocks, cells * _CELL), np.uint32)
    padded[:, :t1] = copies
    cell = padded.reshape(blocks, cells, _CELL).sum(2, dtype=np.uint32)
    cell_sums = cell[:, ::-1].cumsum(1, dtype=np.uint32)[:, ::-1].T  # (cells, blocks)

    def widen(v):
        return ((v >> 16).astype(np.int64) << 32) | (v & 0xFFFF).astype(np.int64)

    cum = np.zeros(t1, np.int64)
    for c in range(cells):
        above = int(widen(cell_sums[c + 1]).sum()) if c + 1 < cells else 0
        x = widen(padded[:, c * _CELL:(c + 1) * _CELL]).sum(0).reshape(32, 2)
        own = x.sum(1)
        below = own[::-1].cumsum()[::-1]
        run = above + below - own + x[:, 1]
        pair = np.stack([run + x[:, 0], run], 1).reshape(-1)  # slots 2l, 2l + 1
        k = c * _CELL + np.arange(_CELL)
        cum[k[k < t1]] = pair[k < t1]
    hit = (cum & 0xFFFFFFFF).astype(np.int32)
    return hit[None, 1:], (cum[None, 1:] >> 32).astype(np.int32) - hit[None, 1:], hit[:1], \
        np.full(1, n, np.int32)


@pytest.mark.parametrize("blocks,t", [(1, 1), (3, 63), (5, 64), (4, 200), (128, 10_000),
                                      (132, 16_384)])
def test_private_route_model_equals_counts_from_hist(blocks, t):
    rng = np.random.default_rng(blocks + t)
    counts = rng.multinomial(min(61_440, 40 * (t + 1)), np.ones(t + 1) / (t + 1), size=blocks)
    hits = rng.binomial(counts, 0.5)
    hist = (counts.sum(0).astype(np.int64) << 32) | hits.sum(0).astype(np.int64)
    n = int(counts.sum())
    want = _counts_from_hist(torch.from_numpy(hist[None]), n)
    for got, w in zip(_private_model(counts, hits, n), want):
        np.testing.assert_array_equal(got, w.numpy())
