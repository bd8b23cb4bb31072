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
   route, printing device time by kernel, the device's busy share of the
   host wall time, and the peak device memory.

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


def headline_data():
    """The repository's headline data (``bench.py``'s ``_make_data``)."""
    rng = np.random.default_rng(0)
    scores = rng.random((NUM_SAMPLES, NUM_CLASSES)).astype(np.float32)
    target = rng.integers(0, NUM_CLASSES, size=NUM_SAMPLES).astype(np.int32)
    return scores, target


def profile_lifecycle(torch, card, label, lifecycle, repeats=3):
    """Device time by kernel, busy share and peak memory of ``lifecycle``."""
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

    def device_us(evt):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(evt, name):
                return float(getattr(evt, name))
        return 0.0

    # Device-side events only: an aten op's own row repeats the time of the
    # kernels it launched.
    rows = sorted(
        ((e.key, device_us(e) / 1e3 / repeats, e.count // repeats)
         for e in prof.key_averages()
         if e.device_type == torch.autograd.DeviceType.CUDA
         and not e.key.startswith("Activity Buffer") and device_us(e) > 0),
        key=lambda r: -r[1],
    )
    busy_ms = sum(r[1] for r in rows)
    print(f"profile {card}: headline lifecycle, {label}: wall {wall_ms:.3f} ms under the "
          f"profiler, device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %), "
          f"peak memory {peak / 2**30:.2f} GiB", flush=True)
    if not rows:
        print("   device time: not measured (the profiler recorded no device time)")
    for key, ms, count in rows[:12]:
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

    def counted(label, lifecycle, metric, kernel):
        """Run one lifecycle with the counters zeroed just before it; fail
        unless it launched ``kernel`` once and nothing else."""
        _build.reset_counts()
        out = lifecycle(metric)
        torch.cuda.synchronize()
        launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
        print(f"{label}: launches {launches}, plain calls {plain}", flush=True)
        check(launches == {kernel: 1} and not plain,
              f"{label} launched {kernel} once, no other kernel, no plain version")
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
        profile_lifecycle(torch, card, "rank-sum route", lambda: headline_lifecycle(headline))
        os.environ["TORCHEVAL_TPU_TORCH_DISABLE_USTAT"] = "1"
        try:
            profile_lifecycle(torch, card, "sort route", lambda: headline_lifecycle(sorted_mc))
        finally:
            del os.environ["TORCHEVAL_TPU_TORCH_DISABLE_USTAT"]

    # ------------------------------------------------------------ 7. kernels
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
