"""Smoke run of the PyTorch port (``torcheval_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root, on a host with a GPU
    python3 chip_smoke.py --profile  # also phase 6, the device-time profile

Builds the port's CUDA kernels from ``torcheval_tpu_torch/ops/csrc`` with
``nvcc``, holds each kernel against its plain PyTorch version on the card
at the main path's shapes, drives the main path through the public
classes, checks the results against a float64 Mann-Whitney oracle, and
times kernels and lifecycle with CUDA events.  Phases:

1. card and build: the device, ``nvidia-smi``'s name and power limit, the
   build time;
2. kernels against their plain versions (bit-equal), at the headline
   shapes and at edge cases (ties on a 1/64 grid, a query count that is
   not a multiple of the kernel's chunk, a pinned cap past shared memory,
   contiguous rows, degenerate AUC rows);
3. the headline lifecycle: ``MulticlassAUROC(num_classes=1000)`` on the
   repository's headline data (numpy seed 0, 8 updates of 16384 x 1000
   f32, one compute) takes the rank-sum route with cap 256 through the
   kernel, and agrees with the oracle within 1e-6;
4. the sort route at full width: ``BinaryAUROC`` on 2^22 balanced samples
   and the headline ``MulticlassAUROC`` with the rank-sum route switched
   off, both through the AUC-scan kernel;
5. times: the median of 7 CUDA-event timings per kernel and of 5 host
   timings of each lifecycle, each line tagged with the card and power
   limit;
6. with ``--profile`` only: ``torch.profiler`` over 3 lifecycles of each
   route (and of the lifecycles of phases 8 and 9), printing device time
   by kernel, the device's busy share of the host wall time, and the peak
   device memory;
7. the confusion-slab kernel against its plain version (bit-equal) at the
   lifecycle's shape (2^17 labels in [0, 1000] with the sentinel), at
   C = 130, with every sample in one cell, at N = 100 003 and at N = 0;
8. the 1000-class confusion-matrix + F1 lifecycle of the repository's
   confusion workload (numpy seed 3, 2^20 int32 label pairs, 8 updates of
   2^17, one compute of each): 16 slab launches, the matrix bit-equal to
   an ``np.add.at`` oracle, macro F1 within 1e-6 of a float64 oracle;
9. the flagship eval step (``torcheval_tpu_torch.flagship``) with numpy
   weights, TF32 off: logits within 1e-5 of a float64 forward, accuracy
   and matrix exact against numpy counts, AUROC within 1e-6 of the
   oracle, one AUC-scan launch;
10. times of phases 7-9, tagged with the card and power limit;
11. the rank-histogram kernel against its plain version (bit-equal) at
    the headline's strided (1000, 131072) view with cap 256, on ties on a
    1/8 grid with half-pad tables, at N = 100 003, on 37 contiguous rows
    and at a pinned cap of 4096 (tables and counts in global memory);
12. the binned-count kernel against its plain version (bit-equal) at the
    binned lifecycle's update (1, 2^19) x 10 000 thresholds, at the
    strided (1000, 16384) multiclass layout x 200, with scores equal to
    thresholds, outside [0, 1], +-inf and NaN, all in one bin, at T = 1
    and at N = 0;
13. the 1000-class AUPRC lifecycle: ``MulticlassAUPRC(num_classes=1000)``
    on the headline batches takes the rank-histogram route (one launch),
    every class's AP within 1e-6 of a float64 step-sum oracle, the macro
    mean within 1e-6 of the sort route (no kernel);
14. the binned lifecycle of the repository's binned workload (numpy seed
    5, ``BinaryBinnedAUROC(threshold=10_000)`` over 2^22 samples in 8
    updates): 8 launches, counts bit-equal to a numpy ``searchsorted``
    count over the same grid, AUROC within 1e-6 of a float64 trapezoid;
15. times of phases 11-14, tagged with the card and power limit (with
    ``--profile``, both lifecycles profiled);
16. the one-pass collection kernel against its plain version (bit-equal)
    at the main path's update (65536 x 100, five members), at the sliced
    stream's shapes (C = 20, 16 slices, a mask), on the binary + binned
    set (1-D scores, T = 512, NaN scores), at the plan bounds (F = C =
    256), with labels out of range and negative, and at N = 0;
17. the collection lifecycle of the repository's collection workload
    (numpy seed 6, 2^19 x 100 f32 scores, five 100-class members,
    ``fused_update`` x 8, one compute): 8 kernel launches and no other,
    every state bit-equal to the same lifecycle with the kernel switched
    off, the confusion matrix bit-equal to an ``np.add.at`` count of
    numpy's argmax, the four macro figures within 1e-6 of float64 oracles;
18. the sliced stream (numpy seed 23, 96 ragged batches, ``bucket=True``,
    16 slices): one launch per batch, ``compute_slices()`` bit-equal to
    the per-member path;
19. the sync toolkit on the card: ``LocalWorld(4)``, each rank a quarter
    of phase 17's batches, ``sync_and_compute`` bit-equal to phase 17's
    result on every rank;
20. times of phases 16-19, tagged with the card and power limit: the
    kernel's device time per update beside its plain version, its bound
    and the per-member route's update, the lifecycle on three routes, and
    the sliced stream with its updates, ``compute_slices()`` and
    ``reset()`` apart (with ``--profile``, the lifecycle by operator on two
    routes, and the sliced stream's updates);
21. the edit-distance kernel against its plain version (bit-equal) and both
    against the port's native host DP (which must be the compiled one): at
    the corpus update's shape (8192 pairs, widths 256), on short pairs
    (widths 32 and 16), on asymmetric widths (16 x 256 and the reverse),
    on empty, identical and disjoint pairs, at a reference of width 0, with
    changed pad values, with lengths past the widths, at n = 0 (no launch)
    and n = 1, and at widths 2048, 4096 (shared memory past 48 KB) and
    12 000 (the diagonals in a global scratch);
22. the corpus WER lifecycle (numpy seed 31, 2^16 pairs in 8 updates of
    8192, references of 1-200 ids, hypotheses with substitutions, deletions
    and insertions, packed to (8192, 256) int32): ``WordErrorRate``,
    ``WordInformationPreserved`` and ``WordInformationLost`` in one
    ``MetricCollection``; 24 kernel launches (each member runs its own) and
    no plain call, the three counters exactly equal to the native DP's sums,
    the three figures within 1e-6 of float64;
23. the repository's WER stream (numpy seed 31, 8 batches of 32-64 sentence
    pairs of 1-20 words from 97, one ``WordInterner``): ``WordErrorRate`` on
    the tokenized batches (8 launches) against ``WordErrorRate`` on the
    strings (the host path), the three states exactly equal;
24. the LM logits lifecycle of the repository's perplexity workload (numpy
    seed 7, (16, 256, 8192) f32 logits, 8 updates of 2 sequences) through
    one ``MetricCollection`` of ``Perplexity`` and ``WordErrorRate``:
    perplexity within 1e-5 of a float64 oracle, the token error counters
    exactly equal to the native DP over numpy's argmax, 8 launches;
25. times of phases 21-24, tagged with the card and power limit: the kernel
    at the corpus update's shape beside its plain version and its bound,
    its device time at the stream's largest batch, the three lifecycles,
    and the native host DP over the corpus pairs on the host's CPU (with
    ``--profile``, phases 22 and 24 by operator);
26. the weighted binned kernel against its plain version at the shape of
    the repository's weighted-histogram workload (numpy seed 15, (1000,
    2^17) f32 scores, hits, weights in [0.5, 1.5), 2048 thresholds on the
    ``jnp.linspace`` grid): within 1e-6 of the sum of |w| a cell, the same
    bits on two launches, bit-equal to ``binned_counts`` under unit
    weights; the same three checks on NaN / +-inf scores, mixed-sign and
    zero weights, T = 1, T = 60 000 (the global-memory path), a strided
    (C, N) class view, and N = 0 (no launch); its time beside its plain
    version's and the unweighted kernel's;
27. the north-star sharded multiclass histogram (numpy seed 6, (2^17, 1000)
    f32 scores, int32 targets, 2048 bins) over ``LocalWorld(4)`` ranks on
    the one card, each with its ``shard_batch`` block: 4 ``binned_counts``
    launches unweighted, 4 ``binned_weighted_counts`` launches weighted,
    no plain call; the merged counts bit-equal to ``LocalWorld(1)`` on the
    whole array (weighted: within 1e-6 of the sum of |w|), unit weights
    bit-equal to unweighted, every class's AUROC within 1e-6 of a float64
    ``np.bincount`` oracle of the same binned curve;
28. binary ``sharded_auroc_histogram`` / ``sharded_auprc_histogram`` at the
    repository's sharded-sync shape (numpy seed 5, 2^22 samples, 16 384
    bins), weighted and unweighted, over ``LocalWorld(4)``: 4 launches a
    call, unit weights and ``LocalWorld(1)`` bit-equal, within 1e-6 of the
    float64 oracles;
29. ``make_synced_update`` over ``LocalWorld(4)`` on the per-class accuracy
    counts of phase 27's batch, bit-equal to one rank's update on the
    whole batch; then the wall clock of each sharded call (median of 5)
    beside its all-reduce alone, whose tensors pickle through the CPU.

Each lifecycle's launch counters are zeroed just before it runs and read
just after, so every path shows its own launches.

The line before the last is one JSON object listing every ported kernel;
the last is ``{"ok": true, "device": {...}}``.  Any failed check exits
non-zero before it.  With no GPU the script exits 1 and prints no result.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

NUM_CLASSES = 1000
NUM_SAMPLES = 131072  # 2^17, the headline's total
NUM_UPDATES = 8
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores
ORACLE_CLASSES = 32
TOL = 1e-6
CM_CLASSES = 1000
CM_SAMPLES = 2**20  # the confusion workload's total, 8 updates of 2^17
LOGITS_TOL = 1e-5
BINNED_SAMPLES = 2**22  # the binned workload's total, 8 updates of 2^19
BINNED_THRESHOLDS = 10_000
BIG = 3.0e38  # the tables' pad value
COL_CLASSES = 100
COL_SAMPLES = 2**19  # the collection workload's total, 8 updates of 2^16
SLICED_CLASSES, SLICES = 20, 16
# 132 SMs x 64 int32 lanes x 1.98 GHz: half the 33.5 TOPS of the Hopper white
# paper, which counts a multiply-add as two operations.
INT32_OPS_PER_S = 16.7e12
CELL_OPS = 5  # one DP cell: a compare, two adds, two mins
WER_PAIRS = 2**16  # the corpus WER lifecycle, 8 updates of 8192
WER_MAX_LEN, WER_VOCAB = 200, 10_000
PPL_TOL = 1e-5


def fail(message: str) -> None:
    print(f"FAIL: {message}", flush=True)
    sys.exit(1)


def check(ok: bool, message: str) -> None:
    if not ok:
        fail(message)
    print(f"ok: {message}", flush=True)


def oracle_auc(scores: np.ndarray, hits: np.ndarray) -> float:
    """Mann-Whitney AUROC in float64 with average ranks for ties."""
    _, inverse, count = np.unique(
        scores.astype(np.float64), return_inverse=True, return_counts=True
    )
    start = np.cumsum(count) - count
    ranks = (start + (count + 1) / 2.0)[inverse]
    p = int(hits.sum())
    q = hits.size - p
    if p == 0 or q == 0:
        return 0.5
    return (ranks[hits].sum() - p * (p + 1) / 2.0) / (p * q)


def oracle_ap(scores: np.ndarray, target: np.ndarray, num_classes: int) -> np.ndarray:
    """One-vs-rest step-sum average precision in float64, per class:
    AP = (1/P) sum over distinct positive scores v of
    #{positives = v} * #{positives >= v} / #{scores >= v}; 0 without
    positives."""
    n = scores.shape[0]
    order = np.argsort(target, kind="stable")
    edges = np.searchsorted(target[order], np.arange(num_classes + 1))
    out = np.zeros(num_classes)
    for k in range(num_classes):
        own = scores[order[edges[k]:edges[k + 1]], k]
        if own.size == 0:
            continue
        vals, cnt = np.unique(own, return_counts=True)
        pos_ge = own.size - (np.cumsum(cnt) - cnt)
        all_ge = n - np.searchsorted(np.sort(scores[:, k]), vals, side="left")
        out[k] = float(np.sum(cnt * pos_ge / all_ge)) / own.size
    return out


def headline_data():
    """The repository's headline data (``bench.py``'s ``_make_data``)."""
    rng = np.random.default_rng(0)
    scores = rng.random((NUM_SAMPLES, NUM_CLASSES)).astype(np.float32)
    target = rng.integers(0, NUM_CLASSES, size=NUM_SAMPLES).astype(np.int32)
    return scores, target


def wer_corpus(rng, n):
    """``n`` (hypothesis, reference) id-list pairs at the scale of an ASR
    test set: a reference of 1-200 ids, and the hypothesis the reference
    with every token independently substituted (p = 0.08), deleted (0.04)
    or followed by an inserted id (0.04)."""
    lens = rng.integers(1, WER_MAX_LEN + 1, n)
    live = np.arange(WER_MAX_LEN)[None, :] < lens[:, None]
    ref = rng.integers(0, WER_VOCAB, (n, WER_MAX_LEN))
    u = rng.random((n, WER_MAX_LEN))
    tok = np.where(u < 0.08, rng.integers(0, WER_VOCAB, (n, WER_MAX_LEN)), ref)
    ins = rng.integers(0, WER_VOCAB, (n, WER_MAX_LEN))
    keep = live & ~((u >= 0.08) & (u < 0.12))
    add = live & (u >= 0.12) & (u < 0.16)
    count = keep.astype(np.int64) + add
    start = np.cumsum(count, axis=1) - count
    hyp_lens = count.sum(axis=1)
    hyp = np.full((n, int(hyp_lens.max())), -1, np.int64)
    r, c = np.nonzero(keep)
    hyp[r, start[r, c]] = tok[r, c]
    r, c = np.nonzero(add)
    hyp[r, start[r, c] + keep[r, c]] = ins[r, c]
    return ([hyp[i, :hyp_lens[i]].tolist() for i in range(n)],
            [ref[i, :lens[i]].tolist() for i in range(n)])


def device_us(evt):
    """An event's own device time in microseconds (the attribute's name
    differs between torch versions)."""
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def device_events(torch, prof):
    """Device-side rows of a profile: an aten op's own row repeats the
    time of the kernels it launched."""
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.key.startswith("Activity Buffer") and device_us(e) > 0]


def device_ms(torch, fn, reps=20):
    """Device time per call of ``fn``: the time of every kernel, copy and
    fill it ran, under ``torch.profiler`` over ``reps`` calls.  For calls of
    a few microseconds, where CUDA events around one call time the host's
    launch path instead."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(device_us(e) for e in device_events(torch, prof))
    if total_us == 0:
        fail("the profiler recorded no device time")
    return total_us / 1e3 / reps


def profile_lifecycle(torch, card, label, lifecycle, repeats=3, host_ops=False):
    """Device time by kernel, busy share and peak memory of ``lifecycle``;
    with ``host_ops``, also the host's own time by operator."""
    from torch.profiler import ProfilerActivity, profile

    lifecycle()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(repeats):
            lifecycle()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / repeats
    peak = torch.cuda.max_memory_allocated()
    rows = sorted(
        ((e.key, device_us(e) / 1e3 / repeats, e.count // repeats)
         for e in device_events(torch, prof)),
        key=lambda r: -r[1],
    )
    busy_ms = sum(r[1] for r in rows)
    print(f"profile {card}: {label}: wall {wall_ms:.3f} ms under the "
          f"profiler, device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %), "
          f"peak memory {peak / 2**30:.2f} GiB", flush=True)
    if not rows:
        print("   device time: not measured (the profiler recorded no device time)")
    for key, ms, count in rows[:12]:
        print(f"   {ms:9.4f} ms  x{count:<4d} {key[:100]}", flush=True)
    if host_ops:
        host = sorted(
            ((e.key, e.self_cpu_time_total / 1e3 / repeats, e.count // repeats)
             for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CPU),
            key=lambda r: -r[1],
        )
        print(f"   host time by operator (self), {sum(r[1] for r in host):.3f} ms in all:",
              flush=True)
        for key, ms, count in host[:10]:
            print(f"   {ms:9.4f} ms  x{count:<4d} {key[:100]}", flush=True)


def main(argv) -> int:
    import torch

    profile_phase = "--profile" in argv

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device; this smoke run needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from torcheval_tpu_torch.metrics import BinaryAUROC, MulticlassAUROC
    from torcheval_tpu_torch.metrics.functional.classification._sort_scan import (
        class_hits,
        sort_desc,
    )
    from torcheval_tpu_torch.ops import _build
    from torcheval_tpu_torch.ops.auc import _auc_from_sorted_plain, auc_from_sorted
    from torcheval_tpu_torch.ops.ustat import (
        _auroc_from_counts,
        _pack_positive_tables,
        _pack_row_tables,
        _rank_sum_counts_plain,
        rank_sum_counts,
        ustat_route_cap,
    )

    dev = torch.device("cuda")

    # ---------------------------------------------------------------- 1. card
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"[{smi}]"
    print(f"device: {kind} (count {torch.cuda.device_count()}), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    print(smi, flush=True)
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {time.perf_counter() - t0:.3f} s (nvcc, {_build.library()._name})", flush=True)

    def median_ms(fn, reps=7):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def bound(nbytes, nops):
        by_bytes, by_ops = nbytes / HBM_BYTES_PER_S, nops / F32_OPS_PER_S
        return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"

    scores, target = headline_data()
    s_chunks = [torch.from_numpy(c).to(dev) for c in np.split(scores, NUM_UPDATES)]
    t_chunks = [torch.from_numpy(c).to(dev) for c in np.split(target, NUM_UPDATES)]
    s_all, t_all = torch.cat(s_chunks), torch.cat(t_chunks)
    n, c = s_all.shape

    # ------------------------------------------ 2. kernels vs plain versions
    counts, table = _pack_positive_tables(s_all, t_all, NUM_CLASSES, 256)
    tables2 = torch.cat([table, -table.flip(1)])
    k_kernel = rank_sum_counts(s_all.T, tables2, negate=True)
    torch.cuda.synchronize()
    k_plain = _rank_sum_counts_plain(s_all.T, tables2, negate=True)
    rank_err = int((k_kernel - k_plain).abs().max())
    check(torch.equal(k_kernel, k_plain),
          f"rank_sum_counts bit-equal to plain at the headline ({2 * c}, {n}), cap 256")

    gen = torch.Generator(device=dev).manual_seed(1)
    grid = torch.floor(torch.rand(100_003, 250, device=dev, generator=gen) * 64) / 64
    grid_t = torch.randint(0, 250, (100_003,), device=dev, generator=gen)
    for label, q_scores, q_target, cap in [
        ("ties on a 1/64 grid, N % 4096 != 0, cap 512", grid, grid_t, 512),
        ("pinned cap 4096 (tables past shared memory)", grid[:, :64], grid_t % 64, 4096),
    ]:
        cnt, tab = _pack_positive_tables(q_scores, q_target, q_scores.shape[1], cap)
        tabs = torch.cat([tab, -tab.flip(1)])
        got = rank_sum_counts(q_scores.T, tabs, negate=True)
        torch.cuda.synchronize()
        check(torch.equal(got, _rank_sum_counts_plain(q_scores.T, tabs, negate=True)),
              f"rank_sum_counts bit-equal to plain: {label}")
    rows = torch.floor(torch.rand(4, 2**20, device=dev, generator=gen) * 64) / 64
    cnt, tab = _pack_row_tables(rows, torch.rand(4, 2**20, device=dev, generator=gen) < 2e-4, 512)
    tabs = torch.cat([tab, -tab.flip(1)])
    got = rank_sum_counts(rows, tabs, negate=True)
    torch.cuda.synchronize()
    check(torch.equal(got, _rank_sum_counts_plain(rows, tabs, negate=True)),
          "rank_sum_counts bit-equal to plain: contiguous rows (4, 2^20), cap 512")
    del grid, grid_t, rows, got

    th, hh = sort_desc(s_all.T, class_hits(t_all, NUM_CLASSES))
    a_kernel = auc_from_sorted(th, hh)
    torch.cuda.synchronize()
    a_plain = _auc_from_sorted_plain(th, hh)
    auc_err = float((a_kernel - a_plain).abs().max())
    check(torch.equal(a_kernel, a_plain),
          f"auc_from_sorted bit-equal to plain at the headline ({c}, {n})")
    x22 = torch.rand(1, 2**22, device=dev, generator=gen)
    y22 = torch.rand(1, 2**22, device=dev, generator=gen) < 0.5
    th22, hh22 = sort_desc(x22, y22)
    got = auc_from_sorted(th22, hh22)
    torch.cuda.synchronize()
    check(torch.equal(got, _auc_from_sorted_plain(th22, hh22)),
          "auc_from_sorted bit-equal to plain at (1, 2^22)")
    deg_t = torch.sort(torch.floor(torch.rand(4, 10_007, device=dev, generator=gen) * 64) / 64,
                       dim=1, descending=True).values
    deg_t[0] = 0.25  # all tied
    deg_h = torch.rand(4, 10_007, device=dev, generator=gen) < 0.3
    deg_h[1], deg_h[2] = False, True  # no positives, no negatives
    got = auc_from_sorted(deg_t, deg_h)
    torch.cuda.synchronize()
    check(torch.equal(got, _auc_from_sorted_plain(deg_t, deg_h))
          and got[:3].tolist() == [0.5, 0.5, 0.5],
          "auc_from_sorted: all-tied / no-positive / no-negative rows give 0.5, bit-equal")

    # ------------------------------------------------ 3. headline lifecycle
    check(ustat_route_cap(s_all, t_all, NUM_CLASSES) == 256,
          "the headline data takes the rank-sum route with cap 256")

    def headline_lifecycle(metric):
        metric.reset()
        for s, t in zip(s_chunks, t_chunks):
            metric.update(s, t)
        return metric.compute()

    def counted(label, lifecycle, metric, kernel, times=1):
        """Run one lifecycle with the counters zeroed just before it; fail
        unless it launched ``kernel`` ``times`` times and nothing else."""
        _build.reset_counts()
        out = lifecycle(metric)
        torch.cuda.synchronize()
        launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
        print(f"{label}: launches {launches}, plain calls {plain}", flush=True)
        check(launches == {kernel: times} and not plain,
              f"{label} launched {kernel} {times} time(s), no other kernel, no plain version")
        return out, launches[kernel]

    # average=None: the lifecycle's own per-class output is checked below.
    headline = MulticlassAUROC(num_classes=NUM_CLASSES, average=None)
    per_class, headline_launches = counted(
        "headline MulticlassAUROC", headline_lifecycle, headline, "rank_sum_counts")
    plain_per_class = _auroc_from_counts(k_plain, counts, n, 256)
    check(torch.equal(per_class, plain_per_class),
          "headline lifecycle's per-class AUROC bit-equal to the plain-count version, all classes")
    print(f"headline macro AUROC {float(per_class.mean())!r}", flush=True)
    sampled = np.random.default_rng(1).choice(NUM_CLASSES, ORACLE_CLASSES, replace=False)
    per_class_np = per_class.cpu().numpy()
    oracle_err = max(
        abs(float(per_class_np[k]) - oracle_auc(scores[:, k], target == k)) for k in sampled
    )
    check(oracle_err <= TOL,
          f"rank-sum route vs float64 oracle on {ORACLE_CLASSES} classes: max err {oracle_err:.3e}")

    # -------------------------------------------- 4. sort route, full width
    rng = np.random.default_rng(2)
    xb = rng.random(2**22).astype(np.float32)
    yb = (rng.random(2**22) < 0.5).astype(np.int32)
    xb_dev, yb_dev = torch.from_numpy(xb).to(dev), torch.from_numpy(yb).to(dev)

    def binary_lifecycle(metric):
        metric.reset()
        for xs, ys in zip(xb_dev.chunk(4), yb_dev.chunk(4)):
            metric.update(xs, ys)
        return metric.compute()

    binary = BinaryAUROC()
    sorted_mc = MulticlassAUROC(num_classes=NUM_CLASSES, average=None)
    os.environ["TORCHEVAL_TPU_TORCH_DISABLE_USTAT"] = "1"
    try:
        b_out, _ = counted("BinaryAUROC 2^22 (sort route)", binary_lifecycle, binary,
                           "auc_from_sorted")
        mc_sorted, sort_launches = counted(
            "headline MulticlassAUROC, rank-sum route off", headline_lifecycle, sorted_mc,
            "auc_from_sorted")
    finally:
        del os.environ["TORCHEVAL_TPU_TORCH_DISABLE_USTAT"]
    b_val = float(b_out)
    b_err = abs(b_val - oracle_auc(xb, yb == 1))
    check(b_err <= TOL, f"BinaryAUROC 2^22 vs float64 oracle: {b_val!r}, err {b_err:.3e}")
    mc_np = mc_sorted.cpu().numpy()
    sort_err = max(abs(float(mc_np[k]) - oracle_auc(scores[:, k], target == k)) for k in sampled)
    check(sort_err <= TOL,
          f"sort route vs float64 oracle on {ORACLE_CLASSES} classes: max err {sort_err:.3e}")
    route_gap = float((mc_sorted - per_class).abs().max())
    check(route_gap <= TOL, f"sort route vs rank-sum route, all classes: max gap {route_gap:.3e}")

    # -------------------------------------------------------------- 5. times
    rank_ms = median_ms(lambda: rank_sum_counts(s_all.T, tables2, negate=True))
    rank_plain_ms = median_ms(lambda: _rank_sum_counts_plain(s_all.T, tables2, negate=True))
    stacked = torch.cat([s_all.T, -s_all.T]).contiguous()
    rank_lib_ms = median_ms(
        lambda: torch.searchsorted(tables2, stacked, right=True).sum(-1)
    )
    del stacked
    rank_bound, rank_by = bound(
        n * c * 4 + tables2.numel() * 4 + tables2.shape[0] * 4,
        2 * n * c * 8,  # two binary searches of log2(256) compares per query
    )
    auc_ms = median_ms(lambda: auc_from_sorted(th, hh))
    auc_plain_ms = median_ms(lambda: _auc_from_sorted_plain(th, hh))
    auc_bound, auc_by = bound(c * n * (4 + 1) + c * 4, 3 * c * n)
    auc22_ms = median_ms(lambda: auc_from_sorted(th22, hh22))
    auc22_bound, _ = bound(2**22 * 5 + 4, 3 * 2**22)
    for name, ms, plain, lib, bnd in [
        (f"rank_sum_counts ({2 * c}, {n}) cap 256", rank_ms, rank_plain_ms, rank_lib_ms, rank_bound),
        (f"auc_from_sorted ({c}, {n})", auc_ms, auc_plain_ms, None, auc_bound),
        ("auc_from_sorted (1, 2^22)", auc22_ms, None, None, auc22_bound),
    ]:
        print(f"time {card}: {name}: kernel {ms:.4f} ms, plain "
              f"{'n/a' if plain is None else f'{plain:.4f} ms'}, library "
              f"{'none' if lib is None else f'{lib:.4f} ms'}, bound {bnd:.4f} ms", flush=True)

    def host_median_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    life_ms = host_median_ms(lambda: headline_lifecycle(headline))
    print(f"time {card}: headline lifecycle (8 updates + compute, rank-sum route): "
          f"{life_ms:.3f} ms", flush=True)
    os.environ["TORCHEVAL_TPU_TORCH_DISABLE_USTAT"] = "1"
    try:
        sort_life_ms = host_median_ms(lambda: headline_lifecycle(sorted_mc))
        bin_life_ms = host_median_ms(lambda: binary_lifecycle(binary))
    finally:
        del os.environ["TORCHEVAL_TPU_TORCH_DISABLE_USTAT"]
    print(f"time {card}: headline lifecycle, sort route: {sort_life_ms:.3f} ms", flush=True)
    print(f"time {card}: BinaryAUROC 2^22 lifecycle (4 updates + compute): "
          f"{bin_life_ms:.3f} ms", flush=True)

    # --------------------------------------------------- 6. profile (opt-in)
    if profile_phase:
        profile_lifecycle(torch, card, "headline lifecycle, rank-sum route",
                          lambda: headline_lifecycle(headline))
        os.environ["TORCHEVAL_TPU_TORCH_DISABLE_USTAT"] = "1"
        try:
            profile_lifecycle(torch, card, "headline lifecycle, sort route",
                              lambda: headline_lifecycle(sorted_mc))
        finally:
            del os.environ["TORCHEVAL_TPU_TORCH_DISABLE_USTAT"]

    # ------------------------------------ 7. confusion slab vs plain version
    from torcheval_tpu_torch.convert import params_from_jax
    from torcheval_tpu_torch.flagship import FlagshipMLP, eval_step
    from torcheval_tpu_torch.metrics import MulticlassConfusionMatrix, MulticlassF1Score
    from torcheval_tpu_torch.ops.cm import _confusion_slab_plain, _slab

    m = CM_SAMPLES // NUM_UPDATES
    cm_t = torch.randint(0, CM_CLASSES + 1, (m,), device=dev, generator=gen, dtype=torch.int32)
    cm_p = torch.randint(0, CM_CLASSES + 1, (m,), device=dev, generator=gen, dtype=torch.int32)
    one_t = torch.zeros(m, dtype=torch.int32, device=dev)
    one_p = torch.full((m,), 7, dtype=torch.int32, device=dev)
    slab_err = None
    for label, st, sp, sc in [
        (f"lifecycle shape ({m},), C={CM_CLASSES}, labels in [0, C]", cm_t, cm_p, CM_CLASSES),
        ("C=130", cm_t % 131, cm_p % 131, 130),
        ("every sample in cell (0, 7)", one_t, one_p, CM_CLASSES),
        ("N=100003, not a multiple of the block", cm_t[:100_003], cm_p[:100_003], CM_CLASSES),
        ("N=0", cm_t[:0], cm_p[:0], CM_CLASSES),
    ]:
        got = _slab(st, sp, sc)
        torch.cuda.synchronize()
        want = _confusion_slab_plain(st, sp, sc)
        if slab_err is None:
            slab_err = int((got - want).abs().max())
        check(torch.equal(got, want) and int(got.sum()) == st.numel(),
              f"confusion_slab bit-equal to plain: {label}")

    # --------------------------------- 8. the 1000-class CM + F1 lifecycle
    cm_rng = np.random.default_rng(3)  # benchmarks/workloads.py's bench_confusion_f1
    pred_np = cm_rng.integers(0, CM_CLASSES, CM_SAMPLES).astype(np.int32)
    target_np = cm_rng.integers(0, CM_CLASSES, CM_SAMPLES).astype(np.int32)
    p_chunks = [torch.from_numpy(c).to(dev) for c in np.split(pred_np, NUM_UPDATES)]
    y_chunks = [torch.from_numpy(c).to(dev) for c in np.split(target_np, NUM_UPDATES)]

    def cm_f1_lifecycle(pair):
        cm_metric, f1_metric = pair
        cm_metric.reset()
        f1_metric.reset()
        for p, t in zip(p_chunks, y_chunks):
            cm_metric.update(p, t)
            f1_metric.update(p, t)
        return cm_metric.compute(), f1_metric.compute()

    cm_pair = (MulticlassConfusionMatrix(num_classes=CM_CLASSES),
               MulticlassF1Score(num_classes=CM_CLASSES, average="macro"))
    (cm_out, f1_out), cm_launches = counted(
        "1000-class CM + F1 lifecycle", cm_f1_lifecycle, cm_pair, "confusion_slab",
        times=2 * NUM_UPDATES)
    cm_oracle = np.zeros((CM_CLASSES, CM_CLASSES), np.int64)
    np.add.at(cm_oracle, (target_np, pred_np), 1)
    check(np.array_equal(cm_out.cpu().numpy(), cm_oracle),
          "1000-class confusion matrix bit-equal to the np.add.at oracle")
    tp = np.diag(cm_oracle).astype(np.float64)
    n_label, n_pred = cm_oracle.sum(1), cm_oracle.sum(0)
    with np.errstate(divide="ignore", invalid="ignore"):
        f1_c = np.nan_to_num(2 * tp / (n_label + n_pred))
    f1_oracle = f1_c[(n_label != 0) | (n_pred != 0)].mean()
    f1_err = abs(float(f1_out) - f1_oracle)
    check(f1_err <= TOL, f"macro F1 {float(f1_out)!r} vs float64 oracle: err {f1_err:.3e}")

    # ------------------------------------------------ 9. the flagship step
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}",
          flush=True)
    fl_rng = np.random.default_rng(4)
    features, hidden, classes = 32, 64, 8
    params = {  # as __graft_entry__._init_params: normal / sqrt(fan_in), zero biases
        "w1": (fl_rng.standard_normal((features, hidden)) / np.sqrt(features)).astype(np.float32),
        "b1": np.zeros(hidden, np.float32),
        "w2": (fl_rng.standard_normal((hidden, classes)) / np.sqrt(hidden)).astype(np.float32),
        "b2": np.zeros(classes, np.float32),
    }
    fl_x = fl_rng.standard_normal((1024, features)).astype(np.float32)
    fl_y = fl_rng.integers(0, classes, 1024).astype(np.int32)
    model = FlagshipMLP()
    model.load_state_dict(params_from_jax(params))
    fl_x_dev, fl_y_dev = torch.from_numpy(fl_x).to(dev), torch.from_numpy(fl_y).to(dev)
    fl_out, _ = counted("flagship eval step", lambda mdl: eval_step(mdl, fl_x_dev, fl_y_dev),
                        model, "auc_from_sorted")
    f64 = {k: v.astype(np.float64) for k, v in params.items()}
    logits_ref = np.maximum(fl_x.astype(np.float64) @ f64["w1"] + f64["b1"], 0) @ f64["w2"] + f64["b2"]
    logits_err = float(np.abs(fl_out["logits"].cpu().numpy() - logits_ref).max())
    check(logits_err <= LOGITS_TOL, f"flagship logits vs float64 forward: max err {logits_err:.3e}")
    fl_scores = torch.softmax(fl_out["logits"], dim=-1)
    fl_pred = fl_scores.argmax(-1).cpu().numpy()
    fl_acc = np.float32((fl_pred == fl_y).sum()) / np.float32(fl_y.size)
    check(float(fl_out["accuracy"]) == float(fl_acc),
          f"flagship accuracy {float(fl_out['accuracy'])!r} equals the numpy count")
    fl_cm = np.zeros((classes, classes), np.int64)
    np.add.at(fl_cm, (fl_y, fl_pred), 1)
    check(np.array_equal(fl_out["confusion_matrix"].cpu().numpy(), fl_cm),
          "flagship confusion matrix equals the numpy count")
    scores_np = fl_scores.cpu().numpy()
    fl_auc = np.mean([oracle_auc(scores_np[:, k], fl_y == k) for k in range(classes)])
    fl_auc_err = abs(float(fl_out["auroc"]) - fl_auc)
    check(fl_auc_err <= TOL, f"flagship macro AUROC {float(fl_out['auroc'])!r} vs oracle: "
          f"err {fl_auc_err:.3e}")

    # ----------------------------------------------- 10. times of phases 7-9
    # Device time (the slab call is a few microseconds of work), and the
    # CUDA-event time of one call beside it, which is mostly launch path.
    flat = cm_t.to(torch.int64) * (CM_CLASSES + 1) + cm_p
    slab_calls = {
        "kernel": lambda: _slab(cm_t, cm_p, CM_CLASSES),
        "plain": lambda: _confusion_slab_plain(cm_t, cm_p, CM_CLASSES),
        "library": lambda: torch.bincount(flat, minlength=(CM_CLASSES + 1) ** 2),
        "one cell": lambda: _slab(one_t, one_p, CM_CLASSES),
    }
    slab_dev = {k: device_ms(torch, fn) for k, fn in slab_calls.items()}
    slab_wall = {k: median_ms(fn) for k, fn in slab_calls.items()}
    slab_ms, slab_plain_ms, slab_lib_ms = (slab_dev[k] for k in ("kernel", "plain", "library"))
    slab_bound, slab_by = bound(m * 8 + (CM_CLASSES + 1) ** 2 * 4, m)
    print(f"time {card}: confusion_slab ({m},) C={CM_CLASSES}, device time per call: "
          f"kernel {slab_ms:.4f} ms, plain {slab_plain_ms:.4f} ms, library {slab_lib_ms:.4f} ms "
          f"(torch.bincount), bound {slab_bound:.4f} ms ({slab_by}); every sample in one "
          f"cell {slab_dev['one cell']:.4f} ms", flush=True)
    print(f"time {card}: confusion_slab ({m},) C={CM_CLASSES}, CUDA events around one call: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in slab_wall.items()), flush=True)
    cm_life_ms = host_median_ms(lambda: cm_f1_lifecycle(cm_pair))
    os.environ["TORCHEVAL_TPU_TORCH_SKIP_VALUE_CHECKS"] = "1"
    try:
        cm_life_skip_ms = host_median_ms(lambda: cm_f1_lifecycle(cm_pair))
    finally:
        del os.environ["TORCHEVAL_TPU_TORCH_SKIP_VALUE_CHECKS"]
    print(f"time {card}: 1000-class CM + F1 lifecycle (8 updates + 2 computes): "
          f"{cm_life_ms:.3f} ms; with value checks skipped {cm_life_skip_ms:.3f} ms", flush=True)
    fl_ms = host_median_ms(lambda: eval_step(model, fl_x_dev, fl_y_dev))
    print(f"time {card}: flagship eval step (1024 x 32 -> 8): {fl_ms:.3f} ms", flush=True)
    if profile_phase:
        profile_lifecycle(torch, card, "1000-class CM + F1 lifecycle",
                          lambda: cm_f1_lifecycle(cm_pair), host_ops=True)
        profile_lifecycle(torch, card, "flagship eval step",
                          lambda: eval_step(model, fl_x_dev, fl_y_dev), host_ops=True)

    # ------------------------------- 11. rank histogram vs plain version
    from torcheval_tpu_torch.metrics import BinaryBinnedAUROC, MulticlassAUPRC
    from torcheval_tpu_torch.metrics.functional.classification.binned_precision_recall_curve import (
        _create_threshold_tensor,
    )
    from torcheval_tpu_torch.ops.binned import _binned_counts_plain, binned_counts
    from torcheval_tpu_torch.ops.ustat import _rank_hist_counts_plain, rank_hist_counts

    # `table` is phase 2's: the headline's packed positive tables, cap 256.
    hist_kernel = rank_hist_counts(s_all.T, table)
    torch.cuda.synchronize()
    hist_plain = _rank_hist_counts_plain(s_all.T, table)
    hist_err = int((hist_kernel - hist_plain).abs().max())
    check(torch.equal(hist_kernel, hist_plain),
          f"rank_hist_counts bit-equal to plain at the headline ({c}, {n}) strided view, cap 256")
    del hist_plain

    def rand_tables(rows, cap, pads):
        t = torch.sort(torch.floor(torch.rand(rows, cap, device=dev, generator=gen) * 8) / 8,
                       dim=1).values
        t[:, cap - pads:] = BIG
        t[0] = BIG  # a class without positives: no bin
        return t

    def grid8(shape):
        return torch.floor(torch.rand(*shape, device=dev, generator=gen) * 8) / 8

    for label, q, tab in [
        ("ties on a 1/8 grid, half-pad tables, (64, 2^16) strided, cap 256",
         grid8((2**16, 64)).T, rand_tables(64, 256, 128)),
        ("N = 100003 (not a multiple of the 4096 chunk), (250, N) strided, cap 512",
         grid8((100_003, 250)).T, rand_tables(250, 512, 200)),
        ("37 contiguous rows, (37, 50000), cap 64", grid8((37, 50_000)),
         rand_tables(37, 64, 10)),
        ("pinned cap 4096 (tables and counts in global memory), (64, 50000) strided",
         grid8((50_000, 64)).T, rand_tables(64, 4096, 1000)),
    ]:
        got = rank_hist_counts(q, tab)
        torch.cuda.synchronize()
        check(torch.equal(got, _rank_hist_counts_plain(q, tab)) and int(got[0].sum()) == 0,
              f"rank_hist_counts bit-equal to plain: {label}")

    # --------------------------------- 12. binned counts vs plain version
    bin_rng = np.random.default_rng(5)  # benchmarks/workloads.py's bench_binned_auroc
    b_scores = bin_rng.random(BINNED_SAMPLES, dtype=np.float32)
    b_target = (bin_rng.random(BINNED_SAMPLES) > 0.5).astype(np.float32)
    b_s_chunks = [torch.from_numpy(x).to(dev) for x in np.split(b_scores, NUM_UPDATES)]
    b_t_chunks = [torch.from_numpy(x).to(dev) for x in np.split(b_target, NUM_UPDATES)]
    grid10k = _create_threshold_tensor(BINNED_THRESHOLDS, dev)
    upd_s, upd_h = b_s_chunks[0][None], (b_t_chunks[0] == 1)[None]
    grid200 = _create_threshold_tensor(200, dev)
    special = torch.rand(2, 100_003, device=dev, generator=gen) * 3 - 1
    special[0, :8] = torch.tensor([float("nan"), float("inf"), -float("inf"), -0.0, 1.0,
                                   2.0, -1.0, float("nan")])
    on_grid = grid200[torch.randint(0, 200, (2, 100_003), device=dev, generator=gen)]
    hits2 = torch.rand(2, 100_003, device=dev, generator=gen) < 0.4
    bin_err = None  # max |kernel - plain| over the four counts at the lifecycle's shape
    for label, bs, bh, bt in [
        (f"lifecycle update shape (1, {BINNED_SAMPLES // NUM_UPDATES}) x {BINNED_THRESHOLDS}",
         upd_s, upd_h, grid10k),
        (f"({NUM_CLASSES}, {n // NUM_UPDATES}) strided multiclass layout, class hits, x 200",
         s_chunks[0].T, class_hits(t_chunks[0], NUM_CLASSES), grid200),
        ("scores equal to thresholds, (2, 100003) x 200", on_grid, hits2, grid200),
        ("scores outside [0, 1], +-inf and NaN, (2, 100003) x 200", special, hits2, grid200),
        ("every score in one bin, (1, 2^19) x 10000", torch.full_like(upd_s, 0.37), upd_h,
         grid10k),
        ("T = 1", special, hits2, _create_threshold_tensor(1, dev)),
        ("N = 0", special[:, :0], hits2[:, :0], grid200),
    ]:
        got = binned_counts(bs, bh, bt)
        torch.cuda.synchronize()
        want = _binned_counts_plain(bs, bh, bt)
        if bin_err is None:
            bin_err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        check(all(g.dtype == torch.int32 and torch.equal(g, w) for g, w in zip(got, want)),
              f"binned_counts bit-equal to plain: {label}")
    del special, on_grid, hits2

    # ---------------------------------- 13. the 1000-class AUPRC lifecycle
    auprc = MulticlassAUPRC(num_classes=NUM_CLASSES, average=None)
    ap, hist_launches = counted("headline MulticlassAUPRC", headline_lifecycle, auprc,
                                "rank_hist_counts")
    t0 = time.perf_counter()
    ap_oracle = oracle_ap(scores, target, NUM_CLASSES)
    ap_err = float(np.abs(ap.cpu().numpy().astype(np.float64) - ap_oracle).max())
    check(ap_err <= TOL, f"per-class AP vs float64 step-sum oracle, all {NUM_CLASSES} classes: "
          f"max err {ap_err:.3e} (oracle {time.perf_counter() - t0:.1f} s)")
    print(f"headline macro AUPRC {float(ap.mean())!r}", flush=True)
    sorted_auprc = MulticlassAUPRC(num_classes=NUM_CLASSES)
    os.environ["TORCHEVAL_TPU_TORCH_DISABLE_USTAT"] = "1"
    try:
        _build.reset_counts()
        macro_sorted = headline_lifecycle(sorted_auprc)
        torch.cuda.synchronize()
        sort_counts = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
    finally:
        del os.environ["TORCHEVAL_TPU_TORCH_DISABLE_USTAT"]
    print(f"headline MulticlassAUPRC, sort route: launches {sort_counts[0]}, plain calls "
          f"{sort_counts[1]}", flush=True)
    macro_gap = abs(float(ap.mean()) - float(macro_sorted))
    check(sort_counts == ({}, {}) and macro_gap <= TOL,
          f"sort route (no kernel) macro AUPRC {float(macro_sorted)!r}: gap {macro_gap:.3e}")

    # ------------------------------------------ 14. the binned lifecycle
    def binned_lifecycle(metric):
        metric.reset()
        for bs, bt in zip(b_s_chunks, b_t_chunks):
            metric.update(bs, bt)
        return metric.compute()

    binned = BinaryBinnedAUROC(threshold=BINNED_THRESHOLDS)
    (b_auroc, b_grid), binned_launches = counted(
        f"BinaryBinnedAUROC 2^22, {BINNED_THRESHOLDS} thresholds", binned_lifecycle, binned,
        "binned_counts", times=NUM_UPDATES)
    grid_np = b_grid.cpu().numpy()
    t_1 = BINNED_THRESHOLDS - 1
    # jnp.linspace(0, 1, T): XLA's f32 iota times the f32 reciprocal, then 1.0
    grid_want = np.append(np.arange(t_1, dtype=np.float32) * (np.float32(1) / np.float32(t_1)),
                          np.float32(1.0))
    check(np.array_equal(grid_np.view(np.int32), grid_want.view(np.int32)),
          "the 10000-threshold grid bit-equal to its numpy rebuild")
    pos_sorted = np.sort(b_scores[b_target == 1])
    num_ge = BINNED_SAMPLES - np.searchsorted(np.sort(b_scores), grid_np, side="left")
    tp_o = pos_sorted.size - np.searchsorted(pos_sorted, grid_np, side="left")
    fp_o = num_ge - tp_o
    check(np.array_equal(binned.num_tp[0].cpu().numpy(), tp_o)
          and np.array_equal(binned.num_fp[0].cpu().numpy(), fp_o)
          and int(binned.num_total[0]) == BINNED_SAMPLES,
          "binned num_tp / num_fp bit-equal to the numpy searchsorted count")
    tpr = np.append(tp_o / pos_sorted.size, 0.0)[::-1]
    fpr = np.append(fp_o / (BINNED_SAMPLES - pos_sorted.size), 0.0)[::-1]
    b_oracle = 0.5 * float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1])))
    b_auc_err = abs(float(b_auroc) - b_oracle)
    check(b_auc_err <= TOL, f"binned AUROC {float(b_auroc)!r} vs float64 trapezoid: "
          f"err {b_auc_err:.3e}")

    # ------------------------------------------ 15. times of phases 11-14
    hist_ms = median_ms(lambda: rank_hist_counts(s_all.T, table))
    hist_plain_ms = median_ms(lambda: _rank_hist_counts_plain(s_all.T, table))
    hist_bound, hist_by = bound(n * c * 4 + 2 * table.numel() * 4, n * c * 8)
    print(f"time {card}: rank_hist_counts ({c}, {n}) cap 256: kernel {hist_ms:.4f} ms, "
          f"plain {hist_plain_ms:.4f} ms, library none, bound {hist_bound:.4f} ms ({hist_by})",
          flush=True)
    m_bin = BINNED_SAMPLES // NUM_UPDATES
    one_bin = torch.full_like(upd_s, 0.37)
    bin_calls = {
        "kernel": lambda: binned_counts(upd_s, upd_h, grid10k),
        "plain": lambda: _binned_counts_plain(upd_s, upd_h, grid10k),
        "one bin": lambda: binned_counts(one_bin, upd_h, grid10k),
    }
    bin_dev = {k: device_ms(torch, fn) for k, fn in bin_calls.items()}
    bin_wall = {k: median_ms(fn) for k, fn in bin_calls.items()}
    bin_ms, bin_plain_ms = bin_dev["kernel"], bin_dev["plain"]
    bin_bound, bin_by = bound(
        m_bin * 5 + BINNED_THRESHOLDS * 4 + 2 * BINNED_THRESHOLDS * 4 + 8,
        m_bin * int(np.ceil(np.log2(BINNED_THRESHOLDS + 1))),
    )
    print(f"time {card}: binned_counts (1, {m_bin}) x {BINNED_THRESHOLDS}, device time per "
          f"call: kernel {bin_ms:.4f} ms, plain {bin_plain_ms:.4f} ms, library none, bound "
          f"{bin_bound:.4f} ms ({bin_by}); every score in one bin {bin_dev['one bin']:.4f} ms; "
          "CUDA events around one call: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in bin_wall.items()), flush=True)
    ap_life_ms = host_median_ms(lambda: headline_lifecycle(auprc))
    print(f"time {card}: headline MulticlassAUPRC lifecycle (8 updates + compute, "
          f"rank-histogram route): {ap_life_ms:.3f} ms", flush=True)
    binned_life_ms = host_median_ms(lambda: binned_lifecycle(binned))
    print(f"time {card}: BinaryBinnedAUROC 2^22 lifecycle (8 updates + compute, "
          f"{BINNED_THRESHOLDS} thresholds): {binned_life_ms:.3f} ms", flush=True)
    if profile_phase:
        profile_lifecycle(torch, card, "headline MulticlassAUPRC lifecycle",
                          lambda: headline_lifecycle(auprc), host_ops=True)
        profile_lifecycle(torch, card, "BinaryBinnedAUROC 2^22 lifecycle",
                          lambda: binned_lifecycle(binned), host_ops=True)

    # --------------------- 16. the collection kernel vs its plain version
    from torcheval_tpu_torch.distributed import LocalWorld
    from torcheval_tpu_torch.metrics import (
        BinaryAccuracy,
        BinaryConfusionMatrix,
        BinaryF1Score,
        MetricCollection,
        MulticlassAccuracy,
        MulticlassPrecision,
        MulticlassRecall,
    )
    from torcheval_tpu_torch.metrics.toolkit import sync_and_compute
    from torcheval_tpu_torch.ops._mega_plan import plan_for
    from torcheval_tpu_torch.ops.mega import _mega_counts_plain, mega_counts

    def five(c):
        """The collection workload's members (benchmarks/workloads.py's
        bench_collection_fused)."""
        return {
            "acc": MulticlassAccuracy(num_classes=c, average="macro"),
            "f1": MulticlassF1Score(num_classes=c, average="macro"),
            "cm": MulticlassConfusionMatrix(num_classes=c),
            "prec": MulticlassPrecision(num_classes=c, average="macro"),
            "rec": MulticlassRecall(num_classes=c, average="macro"),
        }

    def binary_set():
        return {
            "bacc": BinaryAccuracy(threshold=0.4),
            "bf1": BinaryF1Score(threshold=0.55),
            "bcm": BinaryConfusionMatrix(threshold=0.6),
            "auroc": BinaryBinnedAUROC(threshold=512),
        }

    col_rng = np.random.default_rng(6)  # benchmarks/workloads.py's bench_collection_fused
    col_scores = col_rng.random((COL_SAMPLES, COL_CLASSES), dtype=np.float32)
    col_target = col_rng.integers(0, COL_CLASSES, COL_SAMPLES).astype(np.int32)
    col_x = [torch.from_numpy(a).to(dev) for a in np.split(col_scores, NUM_UPDATES)]
    col_y = [torch.from_numpy(a).to(dev) for a in np.split(col_target, NUM_UPDATES)]

    def mega_case(members, x, y, mask=None, sids=None, slices=None):
        plan = plan_for(members, (x, y), {} if mask is None else {"mask": mask}, slices)
        if plan is None or set(plan.member_names) != set(members):
            fail("the collection kernel's plan must take every member")
        thr = [members[mp.name].threshold for mp in plan.members if mp.kind == "binned"]
        return plan, (x, y, mask, sids, thr)

    def mega_equal(plan, operands):
        got = mega_counts(plan, *operands)
        torch.cuda.synchronize()
        want = _mega_counts_plain(plan, *operands)
        err = 0
        for pair_got, pair_want in zip(got, want):
            for g, w in zip(pair_got, pair_want):
                if (g is None) != (w is None):
                    return False, None
                if g is not None:
                    if g.dtype != torch.int32 or g.shape != w.shape:
                        return False, None
                    if g.numel():
                        err = max(err, int((g - w).abs().max()))
        return err == 0, err

    os.environ["TORCHEVAL_TPU_TORCH_MEGAKERNEL"] = "1"  # plan single members too
    try:
        main_plan, main_ops = mega_case(five(COL_CLASSES), col_x[0], col_y[0])
        ok, mega_err = mega_equal(main_plan, main_ops)
        check(ok, f"mega_counts bit-equal to plain at the main path's update "
                  f"({COL_SAMPLES // NUM_UPDATES}, {COL_CLASSES}), five members")
        sl = torch.rand(313, SLICED_CLASSES, device=dev, generator=gen)
        sl_y = torch.randint(0, SLICED_CLASSES, (313,), device=dev, generator=gen,
                             dtype=torch.int32)
        sl_ids = torch.randint(-1, SLICES + 1, (313,), device=dev, generator=gen,
                               dtype=torch.int32)
        sl_mask = (torch.rand(313, device=dev, generator=gen) < 0.8).to(torch.int32)
        bx = torch.rand(100_003, device=dev, generator=gen)
        bx[:64] = float("nan")
        bx[64:128] = 0.55
        by = torch.randint(0, 2, (100_003,), device=dev, generator=gen, dtype=torch.int32)
        wide = torch.randn(70_001, 256, device=dev, generator=gen)
        wide[:4, 9] = float("nan")  # torch.argmax's first NaN
        wide[4:8] = 0.5  # whole rows tied
        wide_y = torch.randint(-256, 512, (70_001,), device=dev, generator=gen,
                               dtype=torch.int32)
        for label, members, operands in [
            ("sliced stream shapes: C=20, 16 slices (ids -1..16), a mask", five(SLICED_CLASSES),
             (sl, sl_y, sl_mask, sl_ids, SLICES)),
            ("binary + binned set, 1-D scores, T=512, NaN scores, 16 slices", binary_set(),
             (bx, by, None, torch.randint(0, SLICES, (100_003,), device=dev, generator=gen,
                                          dtype=torch.int32), SLICES)),
            ("plan bounds F=C=256, labels in [-256, 512), NaN rows, 3 slices", five(256),
             (wide, wide_y, None, wide_y % 3, 3)),
            ("1-D labels in [-100, 200) as predictions", five(COL_CLASSES),
             (col_y[1] * 3 - 100, col_y[0] * 3 - 100, None, None, None)),
        ]:
            x, y, mask, sids, slices = operands
            plan, ops = mega_case(members, x, y, mask, sids, slices)
            ok, _ = mega_equal(plan, ops)
            check(ok, f"mega_counts bit-equal to plain: {label}")
        _build.reset_counts()
        empty = mega_counts(main_plan, col_x[0][:0], col_y[0][:0])
        check(not _build.LAUNCHES and all(t is None or int(t.abs().sum()) == 0
                                          for pair in empty for t in pair),
              "mega_counts at N=0: zero counts, no launch")
    finally:
        del os.environ["TORCHEVAL_TPU_TORCH_MEGAKERNEL"]
    del sl, bx, wide

    # ------------------------------- 17. the collection workload's lifecycle
    def fused_lifecycle(col):
        col.reset()
        for x, y in zip(col_x, col_y):
            col.fused_update(x, y)
        return col.compute()

    def update_lifecycle(col):
        col.reset()
        for x, y in zip(col_x, col_y):
            col.update(x, y)
        return col.compute()

    def off(fn, *args):
        os.environ["TORCHEVAL_TPU_TORCH_MEGAKERNEL"] = "0"
        try:
            return fn(*args)
        finally:
            del os.environ["TORCHEVAL_TPU_TORCH_MEGAKERNEL"]

    col = MetricCollection(five(COL_CLASSES))
    col_out, col_launches = counted(
        "collection lifecycle (fused_update x 8, kernel route)", fused_lifecycle, col,
        "mega_counts", times=NUM_UPDATES)
    col_off = MetricCollection(five(COL_CLASSES))
    _build.reset_counts()
    off_out = off(fused_lifecycle, col_off)
    torch.cuda.synchronize()
    print(f"collection lifecycle, kernel switched off: launches {dict(_build.LAUNCHES)}",
          flush=True)
    a_sd, b_sd = col.state_dict(), col_off.state_dict()
    check(a_sd.keys() == b_sd.keys() and all(
        a_sd[k].dtype == b_sd[k].dtype and torch.equal(a_sd[k], b_sd[k]) for k in a_sd),
        "every state bit-equal to the lifecycle with the kernel switched off")
    check(all(torch.equal(col_out[k], off_out[k]) for k in col_out),
          "every computed figure bit-equal to the kernel-off lifecycle")
    col_pred = col_scores.argmax(1)
    col_cm = np.zeros((COL_CLASSES, COL_CLASSES), np.int64)
    np.add.at(col_cm, (col_target, col_pred), 1)
    check(np.array_equal(col_out["cm"].cpu().numpy(), col_cm),
          "100-class confusion matrix bit-equal to the np.add.at count of numpy's argmax")
    tp = np.diag(col_cm).astype(np.float64)
    n_label, n_pred = col_cm.sum(1).astype(np.float64), col_cm.sum(0).astype(np.float64)
    seen = (n_label != 0) | (n_pred != 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        prec_c = np.nan_to_num(tp / n_pred)
        rec_c = np.nan_to_num(tp / n_label)
        f1_c = np.nan_to_num(2 * prec_c * rec_c / (prec_c + rec_c))
    oracles = {
        "acc": np.mean(tp[n_label != 0] / n_label[n_label != 0]),
        "prec": prec_c[seen].mean(),
        "rec": rec_c[seen].mean(),
        "f1": f1_c[seen].mean(),
    }
    for name, want in oracles.items():
        err = abs(float(col_out[name]) - want)
        check(err <= TOL, f"macro {name} {float(col_out[name])!r} vs float64 oracle: "
                          f"err {err:.3e}")

    # ------------------------------------------------ 18. the sliced stream
    sl_rng = np.random.default_rng(23)  # benchmarks/workloads.py's sliced stream
    sizes = sorted([160, 96, 224, 130, 313, 200, 256, 77] * 12)
    sliced_batches = [
        (torch.from_numpy(sl_rng.random((b, SLICED_CLASSES), dtype=np.float32)).to(dev),
         torch.from_numpy(sl_rng.integers(0, SLICED_CLASSES, b).astype(np.int32)).to(dev),
         torch.from_numpy(sl_rng.integers(0, SLICES, b).astype(np.int32)).to(dev))
        for b in sizes
    ]

    def sliced_lifecycle(col):
        col.reset()
        for x, y, ids in sliced_batches:
            col.fused_update(x, y, slice_ids=ids)
        return col.compute_slices()

    sliced = MetricCollection(five(SLICED_CLASSES), bucket=True, slices=SLICES)
    sl_out, sliced_launches = counted(
        f"sliced stream ({len(sizes)} batches, bucket=True, {SLICES} slices)",
        sliced_lifecycle, sliced, "mega_counts", times=len(sizes))
    sliced_off = MetricCollection(five(SLICED_CLASSES), bucket=True, slices=SLICES)
    sl_want = off(sliced_lifecycle, sliced_off)
    check(all(torch.equal(sl_out[lab][k], sl_want[lab][k]) for lab in sl_want
              for k in sl_want[lab])
          and all(torch.equal(v, sliced_off.state_dict()[k])
                  for k, v in sliced.state_dict().items()),
          f"compute_slices() and all {len(sliced.state_dict())} states bit-equal to the "
          "per-member path")

    # ------------------------------------------- 19. the toolkit on the card
    def rank_fn(group, rank):
        mine = MetricCollection(five(COL_CLASSES))
        per = NUM_UPDATES // 4
        for x, y in zip(col_x[rank * per:(rank + 1) * per], col_y[rank * per:(rank + 1) * per]):
            mine.fused_update(x, y)
        return sync_and_compute(mine, group, "all")

    synced = LocalWorld(4).run(rank_fn)
    torch.cuda.synchronize()
    check(all(out[k].device.type == "cuda" and torch.equal(out[k], col_out[k])
              for out in synced for k in col_out),
          "LocalWorld(4) sync_and_compute bit-equal to the single collection's compute(), "
          "every rank")

    # ----------------------------------------------- 20. times of phases 16-19
    # Each call takes the next of the 8 updates (26 MB each, 210 MB in all),
    # so the scores come from device memory, not the 50 MB L2, as in the
    # lifecycle.
    turn = [0]

    def next_update(fn):
        def call():
            i = turn[0] = (turn[0] + 1) % NUM_UPDATES
            return fn(col_x[i], col_y[i])
        return call

    mega_ms = device_ms(torch, next_update(lambda x, y: mega_counts(main_plan, x, y)))
    mega_plain_ms = device_ms(
        torch, next_update(lambda x, y: _mega_counts_plain(main_plan, x, y)), reps=5)
    mega_wall = median_ms(next_update(lambda x, y: mega_counts(main_plan, x, y)))
    m_upd = COL_SAMPLES // NUM_UPDATES
    mega_bound, mega_by = bound(
        m_upd * COL_CLASSES * 4 + m_upd * 4
        + 4 * (4 * 3 * COL_CLASSES + COL_CLASSES * COL_CLASSES),
        m_upd * COL_CLASSES,
    )
    upd_kernel = MetricCollection(five(COL_CLASSES))
    upd_members = MetricCollection(five(COL_CLASSES))
    upd_kernel_ms = device_ms(torch, next_update(upd_kernel.fused_update))
    upd_members_ms = off(device_ms, torch, next_update(upd_members.fused_update))
    print(f"time {card}: mega_counts ({m_upd}, {COL_CLASSES}) five members, device time per "
          f"call, the scores read from device memory: kernel {mega_ms:.4f} ms, plain {mega_plain_ms:.4f} ms, library none, bound "
          f"{mega_bound:.4f} ms ({mega_by}); CUDA events around one call {mega_wall:.4f} ms",
          flush=True)
    print(f"time {card}: one fused_update ({m_upd}, {COL_CLASSES}), device time: kernel route "
          f"{upd_kernel_ms:.4f} ms, per-member route (kernel switched off) "
          f"{upd_members_ms:.4f} ms", flush=True)
    col_ms = host_median_ms(lambda: fused_lifecycle(col))
    col_off_ms = off(host_median_ms, lambda: fused_lifecycle(col_off))
    col_upd_ms = host_median_ms(lambda: update_lifecycle(col_off))
    print(f"time {card}: collection lifecycle (2^19 x 100, 8 updates + compute): "
          f"fused_update with the kernel {col_ms:.3f} ms, fused_update with the kernel "
          f"switched off {col_off_ms:.3f} ms, plain update() {col_upd_ms:.3f} ms", flush=True)
    def sliced_updates():
        for x, y, ids in sliced_batches:
            sliced.fused_update(x, y, slice_ids=ids)

    sliced_ms = host_median_ms(lambda: sliced_lifecycle(sliced), reps=3)
    sliced_upd_ms = host_median_ms(sliced_updates, reps=3)
    sliced_cmp_ms = host_median_ms(sliced.compute_slices, reps=3)
    sliced_reset_ms = host_median_ms(sliced.reset, reps=3)
    print(f"time {card}: sliced stream ({len(sizes)} batches, {SLICES} slices), kernel route: "
          f"{sliced_ms:.3f} ms; of it the {len(sizes)} fused_update {sliced_upd_ms:.3f} ms, "
          f"compute_slices() {sliced_cmp_ms:.3f} ms, reset() {sliced_reset_ms:.3f} ms",
          flush=True)
    if profile_phase:
        profile_lifecycle(torch, card, "collection lifecycle, kernel route",
                          lambda: fused_lifecycle(col), host_ops=True)
        off(profile_lifecycle, torch, card, "collection lifecycle, kernel switched off",
            lambda: fused_lifecycle(col_off), 3, True)
        profile_lifecycle(torch, card, f"sliced stream's {len(sizes)} fused_update, kernel route",
                          sliced_updates, 1, True)


    # ------------------- 21. the edit-distance kernel vs its plain version
    from torcheval_tpu_torch.metrics import (
        Perplexity,
        WordErrorRate,
        WordInformationLost,
        WordInformationPreserved,
    )
    from torcheval_tpu_torch.metrics.text._tokens import WordInterner, _pack, tokenize_pairs
    from torcheval_tpu_torch.native import edit_distance as native_dp
    from torcheval_tpu_torch.ops.wavefront import (
        _edit_distance_kernel,
        _edit_distance_native,
        _edit_distance_plain,
        edit_distance_tokens,
        lens_from_ids,
    )

    print(f"native host edit distance: {native_dp.backend()}", flush=True)
    check(native_dp.backend() == "c++",
          "the native host DP is the compiled C++ one (this host has a compiler)")

    t0 = time.perf_counter()
    wer_hyp, wer_ref = wer_corpus(np.random.default_rng(31), WER_PAIRS)
    per = WER_PAIRS // NUM_UPDATES
    wer_batches_np = [(_pack(wer_hyp[i:i + per], 16), _pack(wer_ref[i:i + per], 16))
                      for i in range(0, WER_PAIRS, per)]
    check(all(h.shape == r.shape == (per, 256) and h.dtype == np.int32
              for h, r in wer_batches_np),
          f"the corpus packs to {NUM_UPDATES} updates of ({per}, 256) int32 "
          f"({time.perf_counter() - t0:.1f} s)")
    wer_batches = [(torch.from_numpy(h).to(dev), torch.from_numpy(r).to(dev))
                   for h, r in wer_batches_np]

    def wave_case(label, a, b, al=None, bl=None):
        """Kernel against plain version on the card, both against the native
        DP; returns max |kernel - plain|."""
        ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
        tal = None if al is None else torch.from_numpy(al).to(dev)
        tbl = None if bl is None else torch.from_numpy(bl).to(dev)
        _build.reset_counts()
        got = edit_distance_tokens(ta, tb, tal, tbl)
        torch.cuda.synchronize()
        launches, plain_calls = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
        la = torch.clamp(lens_from_ids(ta) if tal is None else tal, 0, a.shape[1])
        lb = torch.clamp(lens_from_ids(tb) if tbl is None else tbl, 0, b.shape[1])
        want = _edit_distance_plain(ta, tb, la, lb)
        native = _edit_distance_native(a, b, la, lb)
        n_pairs = a.shape[0]
        check(launches == ({"edit_distance_tokens": 1} if n_pairs else {}) and not plain_calls
              and got.dtype == torch.int32 and got.shape == (n_pairs,)
              and torch.equal(got, want) and np.array_equal(got.cpu().numpy(), native),
              f"edit_distance_tokens bit-equal to plain and to the native DP: {label}")
        return int((got - want).abs().max()) if n_pairs else 0

    def ragged(rng, n_pairs, width, lo, hi, vocab):
        lens = rng.integers(lo, hi + 1, n_pairs)
        ids = rng.integers(0, vocab, (n_pairs, width)).astype(np.int32)
        ids[np.arange(width)[None, :] >= lens[:, None]] = -1
        return ids

    wave_err = wave_case(f"the corpus update's shape ({per}, 256) x ({per}, 256)",
                         *wer_batches_np[0])
    wrng = np.random.default_rng(32)
    wave_case("(4096, 32) pairs of 1-20 tokens from 97",
              ragged(wrng, 4096, 32, 1, 20, 97), ragged(wrng, 4096, 32, 1, 20, 97))
    wave_case("(4096, 16) pairs of 0-16 tokens from 5",
              ragged(wrng, 4096, 16, 0, 16, 5), ragged(wrng, 4096, 16, 0, 16, 5))
    wave_case("asymmetric widths (2048, 16) x (2048, 256)",
              ragged(wrng, 2048, 16, 0, 16, 50), ragged(wrng, 2048, 256, 0, 256, 50))
    wave_case("asymmetric widths (2048, 256) x (2048, 16)",
              ragged(wrng, 2048, 256, 0, 256, 50), ragged(wrng, 2048, 16, 0, 16, 50))
    full = ragged(wrng, 500, 64, 1, 64, 1000)
    none = np.full((100, 64), -1, np.int32)
    deg_a = np.concatenate([none, full[:100], none, full[200:300], full[300:400]])
    deg_b = np.concatenate([full[:100], none, none, full[200:300],
                            np.where(full[400:500] >= 0, full[400:500] + 1000, -1)])
    wave_case("empty hypothesis / empty reference / both empty / identical / disjoint "
              "vocabularies, 100 pairs each", deg_a, deg_b)
    wave_case("a reference of width 0: (300, 64) x (300, 0)", full[:300],
              np.zeros((300, 0), np.int32))
    wave_case("a hypothesis of width 0: (300, 0) x (300, 64)", np.zeros((300, 0), np.int32),
              full[:300])
    pads_a, pads_b = wer_batches_np[1][0][:512].copy(), wer_batches_np[1][1][:512].copy()
    al_np, bl_np = (pads_a >= 0).sum(1).astype(np.int32), (pads_b >= 0).sum(1).astype(np.int32)
    pads_a[pads_a < 0] = 7  # a real token's id where the pads were
    pads_b[pads_b < 0] = -91
    t_pa, t_pb = torch.from_numpy(pads_a).to(dev), torch.from_numpy(pads_b).to(dev)
    same = edit_distance_tokens(t_pa, t_pb, torch.from_numpy(al_np).to(dev),
                                torch.from_numpy(bl_np).to(dev))
    check(torch.equal(same, edit_distance_tokens(wer_batches[1][0][:512], wer_batches[1][1][:512])),
          "changed pad values (a real id, another negative) leave the distances unchanged")
    wave_case("changed pad values, explicit lengths", pads_a, pads_b, al_np, bl_np)
    wave_case("explicit lengths past the widths and negative (clipped)", full[:300], full[200:500],
              wrng.integers(-5, 100, 300).astype(np.int32),
              wrng.integers(-5, 100, 300).astype(np.int32))
    wave_case("n = 0 (no launch)", full[:0], full[:0])
    wave_case("n = 1", full[:1], full[1:2])
    wave_case("(64, 2048) pairs of 0-2048 tokens", ragged(wrng, 64, 2048, 0, 2048, 30),
              ragged(wrng, 64, 2048, 0, 2048, 30))
    wave_case("(8, 4096) pairs, shared memory past 48 KB", ragged(wrng, 8, 4096, 3000, 4096, 30),
              ragged(wrng, 8, 4096, 0, 4096, 30))
    wave_case("(3, 12000) pairs, the diagonals in a global scratch",
              ragged(wrng, 3, 12_000, 9000, 12_000, 30), ragged(wrng, 3, 12_000, 9000, 12_000, 30))

    # ------------------------------------ 22. the corpus WER lifecycle
    def wer_lifecycle(col):
        col.reset()
        for h, r in wer_batches:
            col.update(h, r)
        return col.compute()

    wer_col = MetricCollection({
        "wer": WordErrorRate(), "wip": WordInformationPreserved(), "wil": WordInformationLost(),
    })
    wer_out, wer_launches = counted(
        f"corpus WER lifecycle (2^16 pairs, {NUM_UPDATES} updates, WER + WIP + WIL, each member "
        "its own launch)", wer_lifecycle, wer_col, "edit_distance_tokens", times=3 * NUM_UPDATES)
    t0 = time.perf_counter()
    wer_native = native_dp.edit_distance_batch(wer_hyp, wer_ref)
    native_s = time.perf_counter() - t0
    n_err = int(wer_native.sum())
    n_ref, n_hyp = sum(map(len, wer_ref)), sum(map(len, wer_hyp))
    print(f"corpus: {n_err} errors, {n_ref} reference ids, {n_hyp} hypothesis ids", flush=True)
    wer_sd = wer_col.state_dict()
    check(all(wer_sd[f"{m}/errors"].item() == n_err and wer_sd[f"{m}/target_total"].item() == n_ref
              and wer_sd[f"{m}/input_total"].item() == n_hyp for m in ("wer", "wip", "wil")),
          "errors, target_total and input_total of all three members exactly equal to the "
          "native DP's sums")
    wip64 = (n_ref - n_err) / n_ref * ((n_ref - n_err) / n_hyp)
    for name, want in (("wer", n_err / n_ref), ("wip", wip64), ("wil", 1.0 - wip64)):
        err = abs(float(wer_out[name]) - want) / want
        check(err <= TOL, f"corpus {name} {float(wer_out[name])!r} vs float64 {want!r}: "
                          f"relative err {err:.3e}")

    # --------------------------------- 23. the repository's WER stream
    st_rng = np.random.default_rng(31)  # benchmarks/workloads.py's bench_wer_wavefront_stream
    st_words = [f"w{k}" for k in range(97)]

    def sentence():
        return " ".join(st_rng.choice(st_words, st_rng.integers(1, 21)))

    string_batches = [([sentence() for _ in range(b)], [sentence() for _ in range(b)])
                      for b in [48, 64, 32, 64, 56, 40, 64, 48]]
    interner = WordInterner()
    token_batches = [tuple(torch.from_numpy(x).to(dev) for x in tokenize_pairs(h, r, interner=interner))
                     for h, r in string_batches]

    def stream_lifecycle(batches):
        def run(metric):
            metric.reset()
            for h, r in batches:
                metric.update(h, r)
            return metric.compute()
        return run

    wave_wer, host_wer = WordErrorRate(), WordErrorRate()
    st_out, stream_launches = counted(
        "WER stream, tokenized batches", stream_lifecycle(token_batches), wave_wer,
        "edit_distance_tokens", times=len(token_batches))
    _build.reset_counts()
    host_out = stream_lifecycle(string_batches)(host_wer)
    check(not _build.LAUNCHES and not _build.PLAIN_CALLS
          and all(torch.equal(getattr(wave_wer, s), getattr(host_wer, s))
                  for s in ("errors", "target_total", "input_total"))
          and torch.equal(st_out, host_out),
          f"WER stream: the tokenized route's three states exactly equal the string (host) "
          f"route's; WER {float(st_out)!r}")

    # ------------------------------------- 24. the LM logits lifecycle
    lm_rng = np.random.default_rng(7)  # benchmarks/workloads.py's bench_perplexity
    lm_seqs, lm_tokens, lm_vocab = 16, 256, 8192
    lm_logits = lm_rng.normal(size=(lm_seqs, lm_tokens, lm_vocab)).astype(np.float32)
    lm_target = lm_rng.integers(0, lm_vocab, (lm_seqs, lm_tokens))
    lm_batches = [(torch.from_numpy(x).to(dev), torch.from_numpy(t).to(dev))
                  for x, t in zip(np.split(lm_logits, NUM_UPDATES), np.split(lm_target, NUM_UPDATES))]

    def lm_lifecycle(col):
        col.reset()
        for x, t in lm_batches:
            col.update(x, t)
        return col.compute()

    lm_col = MetricCollection({"ppl": Perplexity(), "wer": WordErrorRate()})
    lm_out, lm_launches = counted(
        f"LM logits lifecycle ({lm_seqs} x {lm_tokens} x {lm_vocab} f32, {NUM_UPDATES} updates, "
        "Perplexity + WordErrorRate)", lm_lifecycle, lm_col, "edit_distance_tokens",
        times=NUM_UPDATES)
    nll = 0.0
    for x, t in zip(lm_logits, lm_target):  # a sequence at a time: 16 MB of float64
        x64 = x.astype(np.float64)
        top = x64.max(-1)
        lse = np.log(np.exp(x64 - top[:, None]).sum(-1)) + top
        nll += float((lse - x64[np.arange(lm_tokens), t]).sum())
    ppl64 = float(np.exp(nll / lm_target.size))
    ppl_err = abs(float(lm_out["ppl"]) - ppl64) / ppl64
    check(ppl_err <= PPL_TOL and lm_col["ppl"].num_total.item() == lm_target.size,
          f"perplexity {float(lm_out['ppl'])!r} vs float64 oracle {ppl64!r}: relative err "
          f"{ppl_err:.3e}")
    lm_hyp = lm_logits.argmax(-1)
    lm_native = int(native_dp.edit_distance_batch(lm_hyp.tolist(), lm_target.tolist()).sum())
    lm_wer = lm_col["wer"]
    check(lm_wer.errors.item() == lm_native and lm_wer.target_total.item() == lm_target.size
          and lm_wer.input_total.item() == lm_target.size,
          f"token error counters exactly equal to the native DP over numpy's argmax "
          f"({lm_native} errors of {lm_target.size} tokens)")
    del lm_logits

    # ----------------------------------------- 25. times of phases 21-24
    h0, r0 = wer_batches[0]
    hl0, rl0 = lens_from_ids(h0), lens_from_ids(r0)
    wave_ms = median_ms(lambda: _edit_distance_kernel(h0, r0, hl0, rl0))
    wave_plain_ms = median_ms(lambda: _edit_distance_plain(h0, r0, hl0, rl0), reps=3)
    cells = int((hl0.to(torch.int64) * rl0.to(torch.int64)).sum())
    by_bytes = (h0.numel() + r0.numel() + 3 * per) * 4 / HBM_BYTES_PER_S
    by_ops = cells * CELL_OPS / INT32_OPS_PER_S
    wave_bound, wave_by = max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"
    big_h, big_r = max(token_batches, key=lambda p: p[0].shape[0])
    st_dev_ms = device_ms(torch, lambda: edit_distance_tokens(big_h, big_r))
    print(f"time {card}: edit_distance_tokens ({per}, 256) x ({per}, 256), {cells} DP cells: "
          f"kernel {wave_ms:.4f} ms, plain {wave_plain_ms:.4f} ms, library none, bound "
          f"{wave_bound:.4f} ms ({wave_by}: {CELL_OPS} int32 operations a cell at "
          f"{INT32_OPS_PER_S:.3g}/s; the bytes alone {by_bytes * 1e3:.4f} ms); at the WER "
          f"stream's largest batch {tuple(big_h.shape)} x {tuple(big_r.shape)}, device time per "
          f"call (lengths, kernel) {st_dev_ms:.4f} ms", flush=True)
    wer_life_ms = host_median_ms(lambda: wer_lifecycle(wer_col))
    one_wer = MetricCollection({"wer": WordErrorRate()})
    wer_one_ms = host_median_ms(lambda: wer_lifecycle(one_wer))
    print(f"time {card}: corpus WER lifecycle (2^16 pairs, 8 updates + compute): WER + WIP + "
          f"WIL {wer_life_ms:.3f} ms, WER alone {wer_one_ms:.3f} ms; the native host DP over the "
          f"same pairs, on this host's CPU (no device time): {native_s * 1e3:.1f} ms", flush=True)
    st_ms = host_median_ms(lambda: stream_lifecycle(token_batches)(wave_wer))
    st_host_ms = host_median_ms(lambda: stream_lifecycle(string_batches)(host_wer))
    print(f"time {card}: WER stream (416 pairs, 8 updates + compute): tokenized route "
          f"{st_ms:.3f} ms; string route on this host's CPU {st_host_ms:.3f} ms", flush=True)
    lm_ms = host_median_ms(lambda: lm_lifecycle(lm_col))
    print(f"time {card}: LM logits lifecycle (16 x 256 x 8192 f32, 8 updates + compute, "
          f"Perplexity + WordErrorRate): {lm_ms:.3f} ms", flush=True)
    if profile_phase:
        profile_lifecycle(torch, card, "corpus WER lifecycle (WER + WIP + WIL)",
                          lambda: wer_lifecycle(wer_col), host_ops=True)
        profile_lifecycle(torch, card, "LM logits lifecycle (Perplexity + WordErrorRate)",
                          lambda: lm_lifecycle(lm_col), host_ops=True)

    # --------------------- 26. the weighted binned kernel vs its plain version
    from torcheval_tpu_torch.metrics.functional.classification.accuracy import (
        _multiclass_accuracy_update_kernel,
    )
    from torcheval_tpu_torch.ops.binned import (
        _binned_weighted_counts_plain,
        binned_weighted_counts,
    )
    from torcheval_tpu_torch.parallel import (
        make_mesh,
        make_synced_update,
        mesh_merge_states,
        shard_batch,
        sharded_auprc_histogram,
        sharded_auroc_histogram,
        sharded_multiclass_auroc_histogram,
    )
    from torcheval_tpu_torch.parallel import sync as psync

    def within(got, want, scale):
        """|got - want| <= 1e-6 x (sum of |w| over each cell's samples), and
        the largest |got - want|."""
        ok = all(g.dtype == torch.float32 and g.shape == w.shape
                 and bool(((g - w).abs() <= TOL * a).all())
                 for g, w, a in zip(got, want, scale))
        return ok, max(float((g - w).abs().max()) if g.numel() else 0.0
                       for g, w in zip(got, want))

    wh_rng = np.random.default_rng(15)  # benchmarks/workloads.py's bench_weighted_histogram
    wh_r, wh_n, wh_t = 1000, 2**17, 2048
    wh_s = torch.from_numpy(wh_rng.random((wh_r, wh_n)).astype(np.float32)).to(dev)
    wh_h = torch.from_numpy(wh_rng.random((wh_r, wh_n)) > 0.4).to(dev)
    wh_w = torch.from_numpy(wh_rng.random(wh_n).astype(np.float32) + 0.5).to(dev)
    wh_th = _create_threshold_tensor(wh_t, dev)  # jnp.linspace(0, 1, 2048) bit for bit
    _build.reset_counts()
    wk = binned_weighted_counts(wh_s, wh_h, wh_w, wh_th)
    torch.cuda.synchronize()
    check(dict(_build.LAUNCHES) == {"binned_weighted_counts": 1} and not _build.PLAIN_CALLS,
          "binned_weighted_counts at the bench shape: one launch, no plain call")
    ok, wcount_err = within(wk, _binned_weighted_counts_plain(wh_s, wh_h, wh_w, wh_th),
                            _binned_weighted_counts_plain(wh_s, wh_h, wh_w.abs(), wh_th))
    check(ok, f"binned_weighted_counts within 1e-6 x sum|w| of plain at ({wh_r}, {wh_n}) x "
          f"{wh_t}: max |kernel - plain| {wcount_err:.3e}")
    again = binned_weighted_counts(wh_s, wh_h, wh_w, wh_th)
    check(all(torch.equal(a, b) for a, b in zip(wk, again)),
          "binned_weighted_counts: two launches on one input give identical bits")
    ones_k = binned_weighted_counts(wh_s, wh_h, torch.ones_like(wh_w), wh_th)
    check(all(torch.equal(a, b.to(torch.float32))
              for a, b in zip(ones_k, binned_counts(wh_s, wh_h, wh_th))),
          "binned_weighted_counts under unit weights bit-equal to binned_counts as f32")
    del again, ones_k
    wcount_ms = median_ms(lambda: binned_weighted_counts(wh_s, wh_h, wh_w, wh_th))
    wcount_plain_ms = median_ms(lambda: _binned_weighted_counts_plain(wh_s, wh_h, wh_w, wh_th))
    unweighted_ms = median_ms(lambda: binned_counts(wh_s, wh_h, wh_th))
    wh_searches = wh_r * wh_n * (int(np.ceil(np.log2(wh_t + 1))) + 2)
    wcount_bound, wcount_by = bound(
        wh_r * wh_n * 5 + wh_n * 4 + wh_t * 4 + (2 * wh_r * wh_t + 2 * wh_r) * 4, wh_searches)
    print(f"time {card}: binned_weighted_counts ({wh_r}, {wh_n}) x {wh_t}: kernel "
          f"{wcount_ms:.4f} ms, plain {wcount_plain_ms:.4f} ms, library none, bound "
          f"{wcount_bound:.4f} ms ({wcount_by}); binned_counts at the same shape "
          f"{unweighted_ms:.4f} ms; weighted_over_unweighted {wcount_ms / unweighted_ms:.3f}",
          flush=True)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            binned_weighted_counts(wh_s, wh_h, wh_w, wh_th)
        torch.cuda.synchronize()
    split = sorted(((e.key, device_us(e) / 3e3) for e in device_events(torch, prof)),
                   key=lambda r: -r[1])
    print(f"   device time a call by kernel: " + "; ".join(
        f"{key[:48]} {ms:.4f} ms" for key, ms in split[:5]), flush=True)
    edge_s = torch.rand(2, 100_003, device=dev, generator=gen)
    edge_s[0, :6] = torch.tensor([float("nan"), float("inf"), -float("inf"), -1.0, 2.0, 0.5])
    edge_h = torch.rand(2, 100_003, device=dev, generator=gen) < 0.4
    edge_w = torch.rand(100_003, device=dev, generator=gen) + 0.5
    mixed_w = (edge_w - 1.0) * 3.0
    mixed_w[::7] = 0.0
    view_s = torch.rand(4096 * 3 + 7, NUM_CLASSES // 10, device=dev, generator=gen)
    view_y = torch.randint(0, NUM_CLASSES // 10, (4096 * 3 + 7,), device=dev, generator=gen)
    view_w = torch.rand(4096 * 3 + 7, device=dev, generator=gen) + 0.5
    long_s = torch.full((1, 2**26), 0.37, device=dev)
    long_h = torch.ones(1, 2**26, dtype=torch.bool, device=dev)
    long_w = torch.full((2**26,), 0.1, device=dev)
    for label, es, eh, ew, et in [
        ("NaN, +-inf and out-of-range scores, (2, 100003) x 200", edge_s, edge_h, edge_w,
         _create_threshold_tensor(200, dev)),
        ("mixed-sign and zero weights, (2, 100003) x 200", edge_s, edge_h, mixed_w,
         _create_threshold_tensor(200, dev)),
        ("T = 1", edge_s, edge_h, edge_w, _create_threshold_tensor(1, dev)),
        ("T = 60000 (histograms and thresholds past shared memory)", edge_s, edge_h, edge_w,
         _create_threshold_tensor(60_000, dev)),
        ("(100, 12295) strided class view of an (N, C) buffer x 2048", view_s.T,
         class_hits(view_y, NUM_CLASSES // 10), view_w, wh_th),
        ("one row, 2^26 hits in one slot at a constant weight 0.1 (an f32 sum drifts), x 2048",
         long_s, long_h, long_w, wh_th),
        ("(2, 100003) x 10000 (the histograms only in shared memory, one warp)", edge_s,
         edge_h, edge_w, _create_threshold_tensor(10_000, dev)),
        ("N = 0", edge_s[:, :0], edge_h[:, :0], edge_w[:0], _create_threshold_tensor(200, dev)),
    ]:
        _build.reset_counts()
        got = binned_weighted_counts(es, eh, ew, et)
        torch.cuda.synchronize()
        launched = _build.LAUNCHES["binned_weighted_counts"]
        ok, err = within(got, _binned_weighted_counts_plain(es, eh, ew, et),
                         _binned_weighted_counts_plain(es, eh, ew.abs(), et))
        twice = all(torch.equal(a, b) for a, b in zip(got, binned_weighted_counts(es, eh, ew, et)))
        unit = all(torch.equal(a, b.to(torch.float32)) for a, b in zip(
            binned_weighted_counts(es, eh, torch.ones_like(ew), et), binned_counts(es, eh, et)))
        check(ok and twice and unit and launched == (0 if es.shape[1] == 0 else 1),
              f"binned_weighted_counts: {label}: within tolerance of plain (max err {err:.3e}), "
              f"same bits twice, unit weights bit-equal to binned_counts, {launched} launch(es)")
    del edge_s, edge_h, view_s, long_s, long_h, long_w
    del wh_s, wh_h, wk

    # ------------------- 27. the north-star sharded multiclass histogram
    def world(size, fn):
        """``fn(mesh)`` on every rank of ``LocalWorld(size)``; all ranks
        must return the same bits."""
        out = LocalWorld(size).run(lambda g, r: fn(make_mesh(group=g)))
        torch.cuda.synchronize()
        flat = [o if isinstance(o, (list, tuple)) else [o] for o in out]
        check(all(all(torch.equal(a, b) for a, b in zip(flat[0], f)) for f in flat[1:]),
              f"LocalWorld({size}): every rank holds the same bits")
        return out[0]

    def world_counted(label, size, fn, kernel):
        _build.reset_counts()
        out = world(size, fn)
        launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
        check(launches == {kernel: size} and not plain,
              f"{label}: launches {launches}, no plain call")
        return out, launches[kernel]

    def hold_shard(label, s, h, w, grid):
        """Both binned kernels on one rank's block, as the sharded path
        gives it them, against their plain versions on the same tensors:
        counts bit-equal, weighted sums within 1e-6 x sum|w| a cell, the
        same bits on a second launch and under unit weights the counts.
        These launches are comparisons: the counters are reset before
        each main-path run."""
        counts = binned_counts(s, h, grid)
        check(all(torch.equal(a, b) for a, b in zip(counts, _binned_counts_plain(s, h, grid))),
              f"binned_counts on {label}: bit-equal to its plain version")
        got = binned_weighted_counts(s, h, w, grid)
        ok, err = within(got, _binned_weighted_counts_plain(s, h, w, grid),
                         _binned_weighted_counts_plain(s, h, w.abs(), grid))
        twice = all(torch.equal(a, b) for a, b in zip(got, binned_weighted_counts(s, h, w, grid)))
        unit = all(torch.equal(a, b.to(torch.float32)) for a, b in zip(
            binned_weighted_counts(s, h, torch.ones_like(w), grid), counts))
        check(ok and twice and unit,
              f"binned_weighted_counts on {label}: within 1e-6 x sum|w| of plain (max err "
              f"{err:.3e}), same bits twice, unit weights bit-equal to binned_counts")
        return err

    def rank_block(rank, *arrays):
        """Rank ``rank``'s ``shard_batch`` block of ``arrays`` in a
        ``LocalWorld(4)``."""
        return LocalWorld(4).run(lambda g, r: shard_batch(make_mesh(group=g), *arrays))[rank]

    def binned_oracle(scores_np, hits_np, w_np, nb):
        """float64 per-bin positive / total mass of the scatter rule
        clip(int(f32(s) * nb)), by np.bincount; rows on the last axis."""
        s2 = scores_np.reshape(scores_np.shape[0], -1)
        h2 = hits_np.reshape(s2.shape)
        idx = np.clip((s2 * np.float32(nb)).astype(np.int32), 0, nb - 1)
        flat = (idx + nb * np.arange(s2.shape[1])[None, :]).ravel()
        wt = np.broadcast_to(w_np[:, None], s2.shape).ravel().astype(np.float64)
        pos = np.bincount(flat, weights=wt * h2.ravel(), minlength=nb * s2.shape[1])
        tot = np.bincount(flat, weights=wt, minlength=nb * s2.shape[1])
        return pos.reshape(-1, nb), tot.reshape(-1, nb)

    def oracle_binned_roc(pos, tot):
        cum_tp = np.concatenate([np.zeros((pos.shape[0], 1)), np.cumsum(pos[:, ::-1], 1)], 1)
        cum_fp = np.concatenate([np.zeros((pos.shape[0], 1)),
                                 np.cumsum((tot - pos)[:, ::-1], 1)], 1)
        area = 0.5 * np.sum(np.diff(cum_fp, axis=1) * (cum_tp[:, 1:] + cum_tp[:, :-1]), 1)
        factor = cum_tp[:, -1] * cum_fp[:, -1]
        return np.where(factor == 0, 0.5, area / np.where(factor == 0, 1, factor))

    def oracle_binned_ap(pos, tot):
        delta = pos[0, ::-1]
        cum_tp, cum_all = np.cumsum(delta), np.cumsum(tot[0, ::-1])
        prec = np.where(cum_all > 0, cum_tp / np.where(cum_all > 0, cum_all, 1), 1.0)
        return 0.0 if cum_tp[-1] == 0 else float(np.sum(delta * prec) / cum_tp[-1])

    ns_rng = np.random.default_rng(6)  # benchmarks/workloads.py's bench_sharded_multiclass_auroc
    ns_s_np = ns_rng.random((NUM_SAMPLES, NUM_CLASSES), dtype=np.float32)
    ns_t_np = ns_rng.integers(0, NUM_CLASSES, NUM_SAMPLES).astype(np.int32)
    ns_w_np = ns_rng.random(NUM_SAMPLES).astype(np.float32) + 0.5
    ns_s, ns_t, ns_w = (torch.from_numpy(x).to(dev) for x in (ns_s_np, ns_t_np, ns_w_np))
    ns_bins = 2048

    def ns_call(weights=None):
        def fn(mesh):
            s, t, w = shard_batch(mesh, ns_s, ns_t, ns_w if weights is None else weights)
            return sharded_multiclass_auroc_histogram(
                s, t, mesh, num_bins=ns_bins, average=None,
                weights=None if weights is None else w)
        return fn

    def ns_counts(weights=None):
        def fn(mesh):
            s, t, w = shard_batch(mesh, ns_s, ns_t, ns_w if weights is None else weights)
            local = psync._counts_local(s.T, class_hits(t, NUM_CLASSES),
                                        None if weights is None else w, ns_bins)
            return list(mesh_merge_states(local, "dp", mesh=mesh))
        return fn

    sh_s, sh_t, sh_w = rank_block(1, ns_s, ns_t, ns_w)
    shard_errs = [hold_shard(
        f"rank 1's north-star block, the strided ({NUM_CLASSES}, {NUM_SAMPLES // 4}) class view "
        f"x {ns_bins}", sh_s.T, class_hits(sh_t, NUM_CLASSES), sh_w,
        torch.tensor(psync._grid_np(ns_bins), device=dev))]
    del sh_s, sh_t, sh_w
    ns_auroc, ns_launches = world_counted(
        f"sharded_multiclass_auroc_histogram ({NUM_SAMPLES}, {NUM_CLASSES}) x {ns_bins}, "
        "LocalWorld(4), unweighted", 4, ns_call(), "binned_counts")
    ns_wauroc, ns_wlaunches = world_counted(
        "the same, weighted", 4, ns_call(ns_w), "binned_weighted_counts")
    merged4, merged1 = world(4, ns_counts()), world(1, ns_counts())
    check(all(torch.equal(a, b) for a, b in zip(merged4, merged1)),
          "merged per-class counts over LocalWorld(4) bit-equal to LocalWorld(1) on the whole")
    wmerged4, wmerged1 = world(4, ns_counts(ns_w)), world(1, ns_counts(ns_w))
    ok, ns_werr = within(wmerged4, wmerged1,
                         world(1, ns_counts(ns_w.abs())))  # positive weights: the sums
    check(ok, f"merged weighted sums over LocalWorld(4) within 1e-6 x sum|w| of LocalWorld(1): "
          f"max diff {ns_werr:.3e}")
    ns_ones = world(4, ns_call(torch.ones_like(ns_w)))
    check(torch.equal(ns_ones, ns_auroc),
          "weighted AUROC under unit weights bit-equal to the unweighted, every class")
    ns_hits = ns_t_np[:, None] == np.arange(NUM_CLASSES)[None, :]
    t0 = time.perf_counter()
    for label, got, w_np in [("unweighted", ns_auroc, np.ones(NUM_SAMPLES, np.float32)),
                             ("weighted", ns_wauroc, ns_w_np)]:
        want = oracle_binned_roc(*binned_oracle(ns_s_np, ns_hits, w_np, ns_bins))
        err = float(np.abs(got.cpu().numpy().astype(np.float64) - want).max())
        check(err <= TOL, f"north-star {label} per-class AUROC vs float64 bincount oracle, all "
              f"{NUM_CLASSES} classes: max err {err:.3e}")
    print(f"north-star oracles: {time.perf_counter() - t0:.1f} s on the host", flush=True)
    del ns_hits

    # -------------------------------- 28. the binary sharded AUROC / AP sync
    bs_rng = np.random.default_rng(5)  # benchmarks/workloads.py's bench_sharded_auroc_sync
    bs_n, bs_bins = 2**22, 16_384
    bs_s_np = bs_rng.random(bs_n, dtype=np.float32)
    bs_t_np = (bs_rng.random(bs_n) > 0.5).astype(np.float32)
    bs_w_np = bs_rng.random(bs_n).astype(np.float32) + 0.5
    bs_s, bs_t, bs_w = (torch.from_numpy(x).to(dev) for x in (bs_s_np, bs_t_np, bs_w_np))

    def bs_call(fn, weights=None):
        def run(mesh):
            s, t, w = shard_batch(mesh, bs_s, bs_t, bs_w if weights is None else weights)
            return fn(s, t, mesh, num_bins=bs_bins, weights=None if weights is None else w)
        return run

    sh_s, sh_t, sh_w = rank_block(1, bs_s, bs_t, bs_w)
    shard_errs.append(hold_shard(
        f"rank 1's binary block, (1, {bs_n // 4}) x {bs_bins} (histograms in the global scratch)",
        sh_s[None], (sh_t != 0)[None], sh_w, torch.tensor(psync._grid_np(bs_bins), device=dev)))
    del sh_s, sh_t, sh_w
    bs_out = {}
    for fn in (sharded_auroc_histogram, sharded_auprc_histogram):
        name = fn.__name__
        bs_out[name] = world_counted(f"{name} 2^22 x {bs_bins}, LocalWorld(4), unweighted",
                                     4, bs_call(fn), "binned_counts")[0]
        bs_out[name + " weighted"] = world_counted(
            f"{name}, weighted", 4, bs_call(fn, bs_w), "binned_weighted_counts")[0]
        check(torch.equal(world(4, bs_call(fn, torch.ones_like(bs_w))), bs_out[name])
              and torch.equal(world(1, bs_call(fn)), bs_out[name]),
              f"{name}: unit weights bit-equal to unweighted; LocalWorld(1) bit-equal to (4)")
    for w_label, w_np in [("", np.ones(bs_n, np.float32)), (" weighted", bs_w_np)]:
        pos, tot = binned_oracle(bs_s_np[:, None], (bs_t_np == 1)[:, None], w_np, bs_bins)
        for name, want in [("sharded_auroc_histogram", float(oracle_binned_roc(pos, tot)[0])),
                           ("sharded_auprc_histogram", oracle_binned_ap(pos, tot))]:
            got = float(bs_out[name + w_label])
            check(abs(got - want) <= TOL, f"{name}{w_label} {got!r} vs float64 bincount oracle "
                  f"{want!r}: err {abs(got - want):.3e}")

    # --------------------------------------- 29. make_synced_update on a world
    def synced_accuracy(mesh):
        step = make_synced_update(
            lambda s, t: _multiclass_accuracy_update_kernel(s, t, "macro", NUM_CLASSES, 1), mesh)
        return list(step(*shard_batch(mesh, ns_s, ns_t)))

    _build.reset_counts()
    synced4 = world(4, synced_accuracy)
    whole = _multiclass_accuracy_update_kernel(ns_s, ns_t, "macro", NUM_CLASSES, 1)
    check(all(torch.equal(a, b) for a, b in zip(synced4, whole)),
          f"make_synced_update over LocalWorld(4) (per-class accuracy counts, {NUM_SAMPLES} x "
          f"{NUM_CLASSES}) bit-equal to one rank's update on the whole batch")

    # -------------------------------------------- times of phases 27-29
    def world_ms(size, fn):
        return host_median_ms(lambda: LocalWorld(size).run(lambda g, r: fn(make_mesh(group=g))))

    ns_tp = merged4[0]
    reduce_only = {
        "multiclass (2 x (1000, 2048) int32)": lambda m: m.all_reduce_many(
            [ns_tp, ns_tp], ["sum", "sum"], "dp"),
        "binary (2 x (16384,) int32)": lambda m: m.all_reduce_many(
            [ns_tp[0, :1].expand(bs_bins).contiguous()] * 2, ["sum", "sum"], "dp"),
    }
    for label, fn, red in [
        ("sharded_multiclass_auroc_histogram (2^17, 1000) x 2048, unweighted", ns_call(),
         "multiclass (2 x (1000, 2048) int32)"),
        ("sharded_multiclass_auroc_histogram, weighted", ns_call(ns_w),
         "multiclass (2 x (1000, 2048) int32)"),
        ("sharded_auroc_histogram 2^22 x 16384, unweighted", bs_call(sharded_auroc_histogram),
         "binary (2 x (16384,) int32)"),
        ("sharded_auroc_histogram, weighted", bs_call(sharded_auroc_histogram, bs_w),
         "binary (2 x (16384,) int32)"),
        ("sharded_auprc_histogram, unweighted", bs_call(sharded_auprc_histogram),
         "binary (2 x (16384,) int32)"),
        ("make_synced_update (per-class accuracy counts)", synced_accuracy, None),
    ]:
        call_ms = world_ms(4, fn)
        share = ""
        if red is not None:
            red_ms = world_ms(4, reduce_only[red])
            share = (f"; the all-reduce alone (pickles through the CPU, {red}) {red_ms:.3f} ms, "
                     f"{100 * red_ms / call_ms:.0f} % of the call")
        print(f"time {card}: {label}, LocalWorld(4) on one card, wall clock of the call: "
              f"{call_ms:.3f} ms{share}", flush=True)
    one_ms = world_ms(1, ns_call())
    print(f"time {card}: sharded_multiclass_auroc_histogram unweighted, LocalWorld(1) on the whole "
          f"array: {one_ms:.3f} ms", flush=True)

    # ------------------------------------------------------ the kernels line
    kernels = [
        {
            "name": "rank_sum_counts",
            "route": "cuda",
            "source": "torcheval_tpu_torch/ops/csrc/rank_sum.cu",
            "replaces": "torcheval_tpu/ops/pallas_ustat.py:176",
            "launches": headline_launches,
            "max_abs_err": rank_err,
            "ms": rank_ms,
            "plain_ms": rank_plain_ms,
            "bound_ms": rank_bound,
            "bound_by": rank_by,
            "library_ms": rank_lib_ms,
            "verdict": "bit-equal",
        },
        {
            "name": "auc_from_sorted",
            "route": "cuda",
            "source": "torcheval_tpu_torch/ops/csrc/auc_scan.cu",
            "replaces": "torcheval_tpu/ops/pallas_auc.py:90",
            "launches": sort_launches,
            "max_abs_err": auc_err,
            "ms": auc_ms,
            "plain_ms": auc_plain_ms,
            "bound_ms": auc_bound,
            "bound_by": auc_by,
            "library_ms": None,
            "verdict": "bit-equal",
        },
        {
            "name": "confusion_slab",
            "route": "cuda",
            "source": "torcheval_tpu_torch/ops/csrc/cm_slab.cu",
            "replaces": "torcheval_tpu/ops/pallas_cm.py:85",
            "launches": cm_launches,
            "max_abs_err": slab_err,
            "ms": slab_ms,
            "plain_ms": slab_plain_ms,
            "bound_ms": slab_bound,
            "bound_by": slab_by,
            "library_ms": slab_lib_ms,
            "verdict": "bit-equal",
        },
        {
            "name": "rank_hist_counts",
            "route": "cuda",
            "source": "torcheval_tpu_torch/ops/csrc/rank_hist.cu",
            "replaces": "torcheval_tpu/ops/pallas_ustat.py:331",
            "launches": hist_launches,
            "max_abs_err": hist_err,
            "ms": hist_ms,
            "plain_ms": hist_plain_ms,
            "bound_ms": hist_bound,
            "bound_by": hist_by,
            "library_ms": None,
            "verdict": "bit-equal",
        },
        {
            "name": "binned_counts",
            "route": "cuda",
            "source": "torcheval_tpu_torch/ops/csrc/binned_count.cu",
            "replaces": "torcheval_tpu/ops/pallas_binned.py:191",
            "launches": binned_launches,
            "max_abs_err": bin_err,
            "ms": bin_ms,
            "plain_ms": bin_plain_ms,
            "bound_ms": bin_bound,
            "bound_by": bin_by,
            "library_ms": None,
            "verdict": "bit-equal",
        },
        {
            "name": "mega_counts",
            "route": "cuda",
            "source": "torcheval_tpu_torch/ops/csrc/mega.cu",
            "replaces": "torcheval_tpu/ops/pallas_mega.py:116",
            "launches": col_launches,
            "max_abs_err": mega_err,
            "ms": mega_ms,
            "plain_ms": mega_plain_ms,
            "bound_ms": mega_bound,
            "bound_by": mega_by,
            "library_ms": None,
            "verdict": "bit-equal",
        },
        {
            "name": "edit_distance_tokens",
            "route": "cuda",
            "source": "torcheval_tpu_torch/ops/csrc/wavefront.cu",
            "replaces": "torcheval_tpu/ops/pallas_wavefront.py:131",
            "launches": wer_launches,
            "max_abs_err": wave_err,
            "ms": wave_ms,
            "plain_ms": wave_plain_ms,
            "bound_ms": wave_bound,
            "bound_by": wave_by,
            "library_ms": None,
            "verdict": "bit-equal",
        },
        {
            "name": "binned_weighted_counts",
            "route": "cuda",
            "source": "torcheval_tpu_torch/ops/csrc/binned_wcount.cu",
            "replaces": "torcheval_tpu/ops/pallas_binned.py:228",
            "launches": ns_wlaunches,
            "max_abs_err": max([wcount_err, *shard_errs]),
            "ms": wcount_ms,
            "plain_ms": wcount_plain_ms,
            "bound_ms": wcount_bound,
            "bound_by": wcount_by,
            "library_ms": None,
            "verdict": "within 1e-6 x sum|w|; bit-equal to binned_counts under unit weights",
        },
    ]
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
