"""A numpy model of ``csrc/auc_scan.cu``'s row split, held bit for bit
against the plain version (``ops/auc.py::_auc_from_sorted_plain``) and
against the JAX kernel run in interpret mode, as ``tests/ops/`` runs it.

A stretch of a sorted row reduces to seven integers (``_summary``); two
adjacent stretches combine exactly (``_combine``, the kernel's
``combine``); the row's AUC follows from its summary (``_finish``).  The
model cuts rows at any chunk length, and also follows the kernel's own
schedule from the wrapper's plan (``auc_plan``): lanes of 16, the warp's
ordered shuffle tree, its spans, the block's warps, and the combine
launch's runs of chunks.  Every value is an integer until the f32
epilogue, so every comparison is bit-equal."""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.ops.pallas_auc import auc_from_sorted as jax_auc_from_sorted
from torcheval_tpu_torch.ops import auc

EMPTY = (0, 0, -1, 0, 0, 0, 0)  # tp, fp, ftp, ffp, ltp, lfp, a
EDGE = (0, 0, 0, 0, 0, 0, 0)  # a boundary at counts (0, 0)


def _combine(x, y):
    tp, fp = x[0] + y[0], x[1] + y[1]
    if y[2] < 0:
        return (tp, fp) + x[2:]
    inner = y[6] + 2 * x[1] * (y[4] - y[2])
    if x[2] < 0:
        f, a = (x[0] + y[2], x[1] + y[3]), inner
    else:
        f = x[2:4]
        a = x[6] + inner + (x[0] + y[2] - x[4]) * (x[1] + y[3] + x[5])
    return (tp, fp) + f + (x[0] + y[4], x[1] + y[5], a)


def _summary(t, h, lo, hi):
    """Stretch [lo, hi) of one row (positions outside [0, n) are masked)."""
    n = t.shape[0]
    tp = fp = a = ltp = lfp = 0
    ftp = ffp = -1
    for e in range(max(lo, 0), min(hi, n)):
        if e > 0 and t[e] != t[e - 1]:
            if ftp < 0:
                ftp, ffp = tp, fp
            else:
                a += (tp - ltp) * (fp + lfp)
            ltp, lfp = tp, fp
        if h[e]:
            tp += 1
        else:
            fp += 1
    return (tp, fp, ftp, max(ffp, 0), ltp, lfp, a)


def _finish(s):
    a = _combine(_combine(EDGE, s), EDGE)[6]
    factor = np.float32(s[0]) * np.float32(s[1])
    area = factor - np.float32(0.5) * np.float32(a)
    return np.float32(0.5) if factor == 0 else np.float32(area / factor)


def _chunked(t, h, chunk):
    """Each row cut into chunks of ``chunk`` and combined in order."""
    out = []
    for tr, hr in zip(t, h):
        s = EMPTY
        for lo in range(0, tr.shape[0], chunk):
            s = _combine(s, _summary(tr, hr, lo, lo + chunk))
        out.append(_finish(s))
    return np.asarray(out, np.float32)


def _tree(sums):
    """The kernel's warp_reduce: shuffle-down levels 1, 2, 4, 8, 16 over 32
    lanes; lane 0's result (missing lanes hold EMPTY)."""
    lanes = list(sums) + [EMPTY] * (32 - len(sums))
    d = 1
    while d < 32:
        lanes = [_combine(lanes[i], lanes[i + d] if i + d < 32 else lanes[i]) for i in range(32)]
        d *= 2
    return lanes[0]


def _scheduled(t, h, plan):
    """The kernel's schedule from the wrapper's plan: per row and chunk,
    each warp's spans of 32 lanes x 16 positions (shifted by the row's
    offset on the 16-element grid when ``plan.vec``), and the combine
    launch's 256 threads, each a contiguous run of chunks."""
    rows, n = t.shape
    warp_len = plan.chunk // auc._WARPS
    out = []
    for r in range(rows):
        shift = (r * n) % 16 if plan.vec else 0
        chunk_sums = []
        for k in range(plan.chunks):
            warps = []
            for w in range(auc._WARPS):
                acc = EMPTY
                begin = k * plan.chunk + w * warp_len - shift
                for base in range(begin, min(begin + warp_len, n), auc._SPAN):
                    lanes = [_summary(t[r], h[r], base + 16 * i, base + 16 * i + 16)
                             for i in range(32)]
                    acc = _combine(acc, _tree(lanes))
                warps.append(acc)
            block = EMPTY
            for s in warps:
                block = _combine(block, s)
            chunk_sums.append(block)
        out.append(_finish(_combine_launch(chunk_sums)))
    return np.asarray(out, np.float32)


def _combine_launch(chunk_sums):
    """auc_combine_kernel: 256 threads, thread i combines chunks
    [i * per, (i + 1) * per) in order, then the warp tree, then 8 warps."""
    k = len(chunk_sums)
    per = -(-k // 256)
    runs = []
    for i in range(256):
        s = EMPTY
        for j in range(i * per, min(i * per + per, k)):
            s = _combine(s, chunk_sums[j])
        runs.append(s)
    total = EMPTY
    for w in range(8):
        total = _combine(total, _tree(runs[32 * w : 32 * w + 32]))
    return total


def _rows(seed, rows, n, levels, p_hit=0.3):
    rng = np.random.default_rng(seed)
    s = (rng.integers(0, levels, (rows, n)) / levels).astype(np.float32)
    h = rng.random((rows, n)) < p_hit
    order = np.argsort(-s, axis=1, kind="stable")
    return np.take_along_axis(s, order, 1), np.take_along_axis(h, order, 1)


def _cases():
    """Rows with ties spanning several chunks, an all-tied row, rows with no
    positives or no negatives, a row shorter than one chunk, one element."""
    t, h = _rows(0, 6, 600, 7)
    t[1] = 0.25  # all tied
    h[2] = False  # no positives
    h[3] = True  # no negatives
    t[4, :500] = 0.75  # one run across most chunks
    short_t, short_h = _rows(1, 2, 5, 3)
    return [(t, h), (short_t, short_h), (t[:, :1].copy(), h[:, :1].copy())]


def _plain(t, h):
    return auc._auc_from_sorted_plain(torch.from_numpy(t), torch.from_numpy(h)).numpy()


def _jax(t, h):
    return np.asarray(jax_auc_from_sorted(jnp.asarray(t), jnp.asarray(h.astype(np.float32)),
                                          interpret=True, tile=128))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("chunk", [1, 2, 7, 4096, "n"])
def test_chunk_summaries_combine_to_the_plain_version_and_jax(chunk):
    for t, h in _cases():
        got = _chunked(t, h, t.shape[1] if chunk == "n" else chunk)
        np.testing.assert_array_equal(_bits(got), _bits(_plain(t, h)))
        np.testing.assert_array_equal(_bits(got), _bits(_jax(t, h)))


def test_combine_is_associative_on_real_summaries():
    t, h = _rows(2, 1, 300, 5)
    parts = [_summary(t[0], h[0], lo, lo + 37) for lo in range(0, 300, 37)]
    left = right = EMPTY
    for p in parts:
        left = _combine(left, p)
    for p in reversed(parts):
        right = _combine(p, right)
    assert left == right == _summary(t[0], h[0], 0, 300)
    assert _combine(EMPTY, left) == _combine(left, EMPTY) == left


def test_combine_launch_runs_of_many_chunks():
    """More chunks than the combine launch's 256 threads (runs of 12)."""
    t, h = _rows(3, 1, 3000, 40)
    t[0, 1000:2500] = t[0, 1000]  # a run over 1500 one-element chunks
    sums = [_summary(t[0], h[0], e, e + 1) for e in range(3000)]
    got = _finish(_combine_launch(sums))
    np.testing.assert_array_equal(_bits([got]), _bits(_plain(t, h)))


@pytest.mark.parametrize(
    "rows,n,sms,vec",
    [
        (3, 4095, 132, True),  # one lane group short of a chunk
        (3, 4097, 132, True),  # one past it: two chunks, a combine launch
        (5, 1031, 132, True),  # n % 16 != 0: each row shifted on the 16-grid
        (5, 1031, 132, False),  # unaligned operands: no shift
        (8, 20_000, 1, True),  # two spans a warp, three chunks a row
        (2, 9000, 1, False),
    ],
)
def test_the_kernel_schedule_of_the_plan(rows, n, sms, vec):
    t, h = _rows(rows * n, rows, n, 9)
    t[0, : n // 2] = t[0, 0]  # a tie run across chunks and spans
    plan = auc._auc_plan(rows, n, vec, sms)
    assert plan.chunk * plan.chunks >= plan.reach > plan.chunk * (plan.chunks - 1)
    got = _scheduled(t, h, plan)
    np.testing.assert_array_equal(_bits(got), _bits(_plain(t, h)))
    if n <= 4097:
        np.testing.assert_array_equal(_bits(got), _bits(_jax(t, h)))


def test_plans_at_the_main_path_shapes():
    one = auc._auc_plan(1, 2**22, True, 132)
    assert (one.chunk, one.chunks, one.combine) == (4096, 1024, True)
    head = auc._auc_plan(1000, 131072, True, 132)
    assert head.chunks == 3 and head.chunk % auc._CHUNK_UNIT == 0
    assert head.chunk * head.chunks >= 131072
    flag = auc._auc_plan(8, 1024, True, 132)
    assert (flag.chunks, flag.combine, flag.blocks) == (1, False, 8)
    odd = auc._auc_plan(1, 2**22 + 3, True, 132)
    assert odd.reach == 2**22 + 18 and odd.chunks == 1025
    for rows, n in [(1, 1), (1, 2**22), (1000, 131072), (7, 123_457), (2**16, 100)]:
        for vec in (True, False):
            p = auc._auc_plan(rows, n, vec, 132)
            assert p.chunk % auc._CHUNK_UNIT == 0 and p.blocks < 2**31
            assert p.chunk * p.chunks >= p.reach > p.chunk * (p.chunks - 1)


def test_plan_reads_the_operands_alignment():
    buf = torch.zeros(2 * 100 + 1)
    hits = torch.zeros(2, 100, dtype=torch.bool)
    assert auc.auc_plan(buf[:200].view(2, 100), hits).vec == (buf.data_ptr() % 16 == 0)
    assert not auc.auc_plan(buf[1:].view(2, 100), hits).vec


def test_plan_constants_match_the_kernel_source():
    """The plan's copies of ``auc_scan.cu``'s block shape and summary size."""
    src = (Path(auc.__file__).parent / "csrc" / "auc_scan.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
    assert int(const["kThreads"]) == 32 * auc._WARPS
    assert const["kWarps"] == "kThreads / 32" and int(const["kPer"]) * 32 == auc._SPAN
    assert const["kChunkUnit"] == "kWarps * kSpan" and auc._CHUNK_UNIT == auc._WARPS * auc._SPAN
    assert f"sizeof(Sum) == {auc._SUM_BYTES}" in src
    assert len(EMPTY) == 7 and "long long a;" in src
