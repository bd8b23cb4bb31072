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
    ``--profile``, both lifecycles profiled).

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

    # ----------------------------------------------------------- 16. kernels
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
