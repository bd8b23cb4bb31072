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
   not a multiple of the kernel's tile, less than one tile and one past
   it, 31 and 33 classes, pinned caps past shared memory (784, 4096), a
   cap that is not a power of two, C = 999 (a pitch that is not 16-byte
   aligned), ``scores[:, 1:]`` and ``scores[:, :999]`` of the headline,
   contiguous rows whole, cut short and misaligned, degenerate AUC rows,
   and the AUC scan at (1, 2^22), an all-tied 2^22 row, a tie run over 64
   chunks, the flagship's (8, 1024), lengths one either side of a chunk
   edge and of 2^22, operands that are not 16-byte aligned); each rank
   case prints its launch plan (rows a block, 16- or 4-byte copies, shared
   or global tables, blocks), each AUC case its chunks a row, blocks and
   loads;
3. the headline lifecycle: ``MulticlassAUROC(num_classes=1000)`` on the
   repository's headline data (numpy seed 0, 8 updates of 16384 x 1000
   f32, one compute) takes the rank-sum route with cap 256 through the
   kernel, and agrees with the oracle within 1e-6;
4. the sort route at full width: ``BinaryAUROC`` on 2^22 balanced samples
   (with no flag set, past the rank route's cap, and again with the flag,
   the same bits) and the headline ``MulticlassAUROC`` with the rank-sum
   route switched off, all through the AUC-scan kernel;
5. times: the median of 7 CUDA-event timings per kernel (and the AUC
   scan's device time a call by ``torch.profiler``) and of 5 host timings
   of each lifecycle, each line tagged with the card and power limit;
6. with ``--profile`` only: ``torch.profiler`` over 3 lifecycles of each
   route, of ``BinaryAUROC`` on 2^22 (with its host time by operator), and
   of the lifecycles of phases 8 and 9, printing device time
   by kernel, the device's busy share of the host wall time, and the peak
   device memory;
7. the confusion-slab kernel against its plain version (bit-equal) at the
   lifecycle's shape (2^17 labels in [0, 1000] with the sentinel), at
   C = 130 and C = 100, with every sample in one cell, with two cells at
   random, at N = 100 003, on int64 labels, on an int32 target with an
   int64 prediction, on labels that are not 16-byte aligned, on a
   non-contiguous int64 view and at N = 0, each case with its launch plan;
8. the 1000-class confusion-matrix + F1 lifecycle of the repository's
   confusion workload (numpy seed 3, 2^20 int32 label pairs, 8 updates of
   2^17, one compute of each): 16 slab launches, the matrix bit-equal to
   an ``np.add.at`` oracle, macro F1 within 1e-6 of a float64 oracle; the
   same on int64 labels, bit-equal, and one slab call on them profiled:
   the kernel and no cast or copy;
9. the flagship eval step (``torcheval_tpu_torch.flagship``) with numpy
   weights, TF32 off: logits within 1e-5 of a float64 forward, accuracy
   and matrix exact against numpy counts, AUROC within 1e-6 of the
   oracle, one AUC-scan launch;
10. times of phases 7-9, tagged with the card and power limit: the slab's
    device time a call at C = 1000 (int32 and int64 labels, every sample in
    one cell) and at C = 100, beside its plain version, ``torch.bincount``
    and its bound, and the CM + F1 lifecycle on int32 and on int64 labels;
11. the rank-histogram kernel against its plain version (bit-equal) at
    the headline's strided (1000, 131072) view with cap 256, on ties on a
    1/8 grid with half-pad tables, at N = 100 003, on 37 contiguous rows,
    at pinned caps of 4096 and 784 (tables and counts in global memory),
    at cap 80, at N = 63 and 65, at C = 999, on ``scores[:, 1:]`` and
    ``scores[:, :999]`` of the headline and on 2 rows of 2047, each case
    with its launch plan;
12. the binned-count kernel against its plain version (bit-equal) at the
    binned lifecycle's update (1, 2^19) x 10 000 thresholds, at the
    strided (1000, 16384) multiclass layout x 200, with scores equal to
    thresholds, outside [0, 1], +-inf and NaN, all in one bin, in two bins
    at random, on ``scores[:, 1:]`` (not 16-byte aligned, N % 4 != 0), on a
    geometric grid (slot_of's binary search), at T = 1 and at N = 0, each
    case with its launch plan;
13. the 1000-class AUPRC lifecycle: ``MulticlassAUPRC(num_classes=1000)``
    on the headline batches takes the rank-histogram route (one launch),
    every class's AP within 1e-6 of a float64 step-sum oracle, the macro
    mean within 1e-6 of the sort route (no kernel);
14. the binned lifecycle of the repository's binned workload (numpy seed
    5, ``BinaryBinnedAUROC(threshold=10_000)`` over 2^22 samples in 8
    updates): 8 launches, counts bit-equal to a numpy ``searchsorted``
    count over the same grid, AUROC within 1e-6 of a float64 trapezoid;
15. times of phases 11-14, tagged with the card and power limit:
    ``binned_counts`` at the lifecycle's update and with every score in one
    bin, each also by kernel (zero fill, count, suffix), and at the strided
    (1000, 16384) x 200 layout (with ``--profile``, both lifecycles
    profiled);
16. the one-pass collection kernel against its plain version (bit-equal)
    at the main path's update (65536 x 100, five members), at the sliced
    stream's shapes (C = 20, 16 slices, a mask) and at n = 1, 31, 33, 128,
    512, 513, 4096 and 4097 of them, on the binary + binned set (1-D
    scores, T = 512, NaN scores), at the plan bounds (F = C = 256), with
    labels out of range and negative, with 70 members (two launches), with
    scores that are not 16-byte aligned, and at N = 0; each case prints
    its launch plan (image or global counters, groups, blocks, warps);
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
    ``reset()`` apart, and the kernel's device time a launch over the
    sliced stream's 96 ``fused_update`` (``torch.profiler``) beside its
    bound at those batches (with ``--profile``, the lifecycle by operator
    on two routes, and the sliced stream's updates);
21. the edit-distance kernel against its plain version (bit-equal) and both
    against the port's native host DP (which must be the compiled one): at
    the corpus update's shape (8192 pairs, widths 256), on short pairs
    (widths 32 and 16), on asymmetric widths (16 x 256 and the reverse),
    on empty, identical and disjoint pairs, at a reference of width 0, with
    changed pad values, with lengths past the widths, at n = 0 (no launch)
    and n = 1, at widths 2048, 4096 and 12 000 (bands of 256 rows with
    carries in a global scratch), at exact lengths on each strip height's
    edge (32 R rows and one past, R = 1, 2, 4, 8), at two and three bands,
    at one side far longer than the other, and on a batch that mixes empty,
    one-token and 4096-token pairs; each case prints its strip heights,
    bands and carry scratch;
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
    (C, N) class view, N = 0 (no launch), weights at both edges of the
    fixed-point range and just past it (the f64 route), and one row of 2^20
    at T = 16 384 (slot windows); each case prints the route it took
    (``LAUNCHES["binned_weighted_counts"]``: fixed point, ``..._f64``:
    f64); its time beside its plain version's and the unweighted kernel's,
    and the device time a call by kernel;
27. the north-star sharded multiclass histogram (numpy seed 6, (2^17, 1000)
    f32 scores, int32 targets, 2048 bins) over ``LocalWorld(4)`` ranks on
    the one card, each with its ``shard_batch`` block: 4 ``binned_counts``
    launches unweighted, 4 ``binned_weighted_counts`` launches weighted,
    no plain call; the merged counts bit-equal to ``LocalWorld(1)`` on the
    whole array (weighted: within 1e-6 of the sum of |w|), unit weights
    bit-equal to unweighted, every class's AUROC within 1e-6 of a float64
    ``np.bincount`` oracle of the same binned curve; both kernels held
    against their plain versions on rank 1's block, with the weighted
    kernel's route, and both kernels' times there beside their bounds
    (``binned_counts`` also by kernel);
28. binary ``sharded_auroc_histogram`` / ``sharded_auprc_histogram`` at the
    repository's sharded-sync shape (numpy seed 5, 2^22 samples, 16 384
    bins), weighted and unweighted, over ``LocalWorld(4)``: 4 launches a
    call, unit weights and ``LocalWorld(1)`` bit-equal, within 1e-6 of the
    float64 oracles; rank 1's block held and timed as in phase 27;
29. ``make_synced_update`` over ``LocalWorld(4)`` on the per-class accuracy
    counts of phase 27's batch, bit-equal to one rank's update on the
    whole batch; then the wall clock of each sharded call (median of 5)
    beside its all-reduce alone, whose tensors pickle through the CPU;
30. ``WindowedBinaryAUROC(max_num_samples=2**20)`` on the repository's
    windowed workload (numpy seed 14, 32 updates of 2^16 f32 scores,
    balanced targets: the window wraps twice): one ``auc_from_sorted``
    launch a lifecycle and no plain call, the ring bit-equal to a numpy
    ring model, the AUROC within 1e-6 of a float64 Mann-Whitney oracle
    over the last 2^20 samples; the same with batches that wrap past the
    ring's end and a batch larger than the window; two windows merged
    (capacity 2^21), one launch, within 1e-6 of the oracle;
31. a rare-positive windowed AUROC (numpy seed 17, ``num_tasks=16``,
    ``max_num_samples=2**17``, positives at 1/512, 32 updates of 2^13):
    one ``rank_sum_counts`` launch a lifecycle, within 1e-6 of the oracle;
    with ``TORCHEVAL_TPU_TORCH_DISABLE_USTAT=1`` one ``auc_from_sorted``
    launch and the same figures within 1e-6;
32. ``WindowedBinaryNormalizedEntropy``, ``WindowedClickThroughRate``,
    ``WindowedWeightedCalibration`` and ``WindowedMeanSquaredError``
    (2-D, ``raw_values``) in one ``MetricCollection`` through ``update()``
    (numpy seed 32, ``num_tasks=8``, ``max_num_updates=100``, lifetime
    on, 250 updates of (8, 2^16) clicks and predicted probabilities):
    window and lifetime figures within 1e-5 relative of float64 numpy over
    the same columns; ``fused_update`` refuses and names a windowed
    member;
33. ``PeakSignalNoiseRatio`` and ``StructuralSimilarity`` (11 x 11, sigma
    1.5, ``data_range=1.0``) over 8 updates of (16, 3, 512, 512) f32 image
    pairs (numpy seed 33): PSNR within 1e-5 relative and SSIM within 1e-5
    of float64 numpy oracles (a separable valid gaussian window), and
    SSIM's bits unchanged with ``cudnn.allow_tf32`` and
    ``matmul.allow_tf32`` set True globally;
34. ``FrechetInceptionDistance(model, feature_dim=2048)`` over 10 000 real
    and 10 000 fake (3, 32, 32) images (numpy seed 35) in updates of 1250,
    the model a linear map and ReLU from numpy seed 34: within 1e-3
    relative of a float64 ``scipy.linalg.sqrtm`` oracle on the same
    features, FID's own bits unchanged with TF32 set True globally, and
    the peak device memory;
35. times of phases 30-34, tagged with the card and power limit: each
    lifecycle (median of 5), the two kernels' device time a windowed
    compute beside their bounds, a wrapped ring insert, SSIM's
    convolution, and FID's product, ``eigh`` and ``eigvalsh`` (with
    ``--profile``, phases 30-34 by operator, phase 31 on both routes);
36. ``sharded_multiclass_auroc_ustat`` at the repository's sharded exact
    workload (numpy seed 8, (2^16, 1000) f32 scores, int32 targets) over
    ``LocalWorld(4)``, each rank with its ``shard_batch`` block: with
    defaults (the cap autotuned in the call: 64), pinned by
    ``eager_ustat_pin``, per class, on the ring and on ``LocalWorld(1)``;
    4 ``rank_sum_counts`` launches on the gather, 16 on the ring, no plain
    call; every rank, both schedules, the pin and the world of one the same
    bits; every class within 1e-6 of a float64 Mann-Whitney oracle; with
    ``TORCHEVAL_TPU_TORCH_DISABLE_USTAT=1`` the searchsorted formulation,
    no launch, within 1e-6; the kernel against its plain version on rank
    1's block and the gathered table and a ring chunk, with its plan;
37. the gather-exact functions: ``sharded_multiclass_auroc_exact`` on the
    same data bit-equal to ``multiclass_auroc`` on the whole (one
    ``rank_sum_counts`` launch a rank) and to the ustat, the binary AUROC / AP on phase 28's
    data (AUROC: one ``auc_from_sorted`` launch a rank; AP: the sort route,
    no kernel) and on its scores with 48 positives (``rank_sum_counts`` /
    ``rank_hist_counts``), and the multitask pair on (16, 2^17) with
    positives at 1/512, each bit-equal to the single-device functional on
    the whole;
38. ``sharded_binary_auroc_ustat`` / ``sharded_binary_auprc_ustat`` on
    phase 28's data (whole blocks) and on the 48-positive variant (caps
    64), gather and ring: no kernel, AUROC ring bit-equal to gather, within
    1e-6 of the gather-exact result and of float64 oracles (AP ring within
    1e-6); a cap one below a block's positives raises the same
    ``ValueError`` on every rank;
39. times of phases 36-38, tagged with the card and power limit: each
    sharded call's wall clock (median of 5; the gather-exact multiclass, 3)
    beside its collectives alone, ``rank_sum_counts``' device time a rank
    against the gathered table and a ring chunk beside its bound and issue
    floor, ``rank_sum_counts`` held against its plain version (with its
    plan) and timed at the operands of phase 37's multiclass whole, and
    ``rank_sum_counts`` / ``rank_hist_counts`` at those of its 48-positive
    and multitask wholes (with ``--profile``, the multiclass ustat call by
    operator);
40. the data-health monitor on phase 17's lifecycle: with
    ``health.enable()`` every state bit-equal to the monitor off, the same 8
    ``mega_counts`` launches and no plain call, one read back an update; a
    batch through ``faults.corrupt_batch`` (a clone on the card) with 3
    labels set to 100 and 2 to -1 gives the ``nan`` / ``label_range``
    findings numpy counts, one ``DataHealthEvent`` each;
    ``raise_on_corrupt=True`` raises ``DataCorruptionError`` after the batch
    is applied; the lifecycle's time with the monitor off and on (with
    ``--profile``, both by operator);
41. checkpoint and resume: ``CheckpointManager.save`` of the collection's
    card states after update 4, a fresh card collection loaded from
    ``load_latest()``, updates 5-8 (4 ``mega_counts`` launches): every
    state and figure bit-equal to the uninterrupted run; a torn save
    (``checkpoint.write``, ``action="tear"``) is quarantined and the
    previous generation loads; save, load and restore times and bytes;
42. retried collectives around kernels over ``LocalWorld(4)``:
    ``make_synced_update(_confusion_matrix_update, retry=...)`` on phase 8's
    steps with one rank's first ``sync.dispatch`` attempt failing (4 slab
    launches a step and one for the retry, one ``RetryEvent``, the matrix
    bit-equal to the fault-free call and to phase 8's oracle);
    ``sharded_multiclass_auroc_ustat`` at phase 36's data over
    ``ResilientGroup`` ranks whose first collective attempt fails (phase
    36's bits, 4 ``rank_sum_counts`` launches); a rank that never joins cut
    at a 1 s deadline on the other three; each retried call's wall clock
    beside the fault-free call's;
43. phase 3's headline lifecycle with the telemetry bus, tracing and the
    flight recorder on: the same AUROC bits, every event traced, the
    JSON-lines round trip, one Perfetto slice a timed event, Prometheus
    text that parses, a fired fault's bundle that validates, the
    lifecycle's time with the bus off and on (with ``--profile``, by
    operator), and the spans by name in a ``torch.profiler`` trace beside
    the rank-sum kernel.

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
# Warp instructions a second: 132 SMs x 4 schedulers x 1.98 GHz, one each a
# cycle.  A rank search step is at least 3 (a shared load at an address plus
# a constant, a compare, a predicated add), as rank_sum.cu's steps compile.
WARP_INSTR_PER_S = 132 * 4 * 1.98e9
SEARCH_STEP_INSTR = 3
CELL_OPS = 5  # one DP cell: a compare, two adds, two mins
WER_PAIRS = 2**16  # the corpus WER lifecycle, 8 updates of 8192
WER_MAX_LEN, WER_VOCAB = 200, 10_000
PPL_TOL = 1e-5
# FID against its float64 oracle: two float32 eigendecompositions at D = 2048
# and a covariance that is cov_sum - n mu mu^T in float32, as in the JAX
# package (relative).
FID_RTOL = 1e-3


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


def issue_floor_ms(searches, cap, extra=0):
    """The least time the card could issue ``searches`` rank searches of a
    power-of-two ``cap`` in: log2(cap) + 1 steps of SEARCH_STEP_INSTR warp
    instructions, plus ``extra`` a query, 32 searches a warp instruction."""
    steps = cap.bit_length()
    return searches * (steps * SEARCH_STEP_INSTR + extra) / 32 / WARP_INSTR_PER_S * 1e3


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


def profiled_device_events(torch, fn, reps, attempts=3):
    """The device rows of ``reps`` calls of ``fn`` under ``torch.profiler``.
    The profiler now and then returns a trace without its device rows: such
    a trace is taken again, up to ``attempts`` times; ``[]`` if none had
    them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = device_events(torch, prof)
        if events:
            return events
        print(f"profiler: a trace of {reps} calls without device rows; tracing again", flush=True)
    return []


def device_ms(torch, fn, reps=20):
    """Device time per call of ``fn``: the time of every kernel, copy and
    fill it ran, under ``torch.profiler`` over ``reps`` calls.  For calls of
    a few microseconds, where CUDA events around one call time the host's
    launch path instead.  Where no trace has device rows, CUDA events
    around all ``reps`` calls, which the line says."""
    events = profiled_device_events(torch, fn, reps)
    if events:
        return sum(device_us(e) for e in events) / 1e3 / reps
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    print("profiler: no device rows in any trace; this time is CUDA events around "
          f"{reps} calls", flush=True)
    return start.elapsed_time(end) / reps


def device_split(torch, fn, reps=20):
    """Device time per call of ``fn`` by kernel, under ``torch.profiler``
    over ``reps`` calls, each kernel named by what it is: ``"count"`` and
    ``"suffix"`` for the two kernels of either route of
    ``binned_count.cu``, ``"zero fill"`` for a fill, else the profiler's
    name; ``{}`` where no trace has device rows."""
    out = {}
    for e in profiled_device_events(torch, fn, reps):
        name = ("count" if "binned_count_kernel" in e.key or "binned_private_kernel" in e.key else
                "suffix" if "binned_suffix_kernel" in e.key or "binned_cell_suffix" in e.key else
                "zero fill" if "fill" in e.key.lower() else e.key[:50])
        out[name] = out.get(name, 0.0) + device_us(e) / 1e3 / reps
    return out


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
    from torcheval_tpu_torch.ops.auc import _auc_from_sorted_plain, auc_from_sorted, auc_plan
    from torcheval_tpu_torch.ops.ustat import (
        _auroc_from_counts,
        _pack_positive_tables,
        _pack_row_tables,
        _rank_sum_counts_plain,
        rank_sum_counts,
        rank_sum_plan,
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

    print(f"rank_sum_counts at the headline: {rank_sum_plan(s_all.T, tables2, negate=True).describe()}",
          flush=True)
    gen = torch.Generator(device=dev).manual_seed(1)
    grid = torch.floor(torch.rand(100_003, 250, device=dev, generator=gen) * 64) / 64
    grid_t = torch.randint(0, 250, (100_003,), device=dev, generator=gen)
    c999 = torch.floor(torch.rand(20_001, 999, device=dev, generator=gen) * 64) / 64
    c999_t = torch.randint(0, 999, (20_001,), device=dev, generator=gen)
    for label, q_scores, q_target, cap in [
        ("ties on a 1/64 grid, N % 4096 != 0, cap 512", grid, grid_t, 512),
        ("pinned cap 4096 (tables past shared memory)", grid[:, :64], grid_t % 64, 4096),
        ("cap 784, the first cap past shared memory", grid[:, :33], grid_t % 33, 784),
        ("cap 80, not a power of two (guarded steps)", grid[:, :40], grid_t % 40, 80),
        ("31 classes, N = 63, less than one tile", grid[:63, :31], grid_t[:63] % 31, 256),
        ("33 classes, N = 65, a tile and one sample", grid[:65, :33], grid_t[:65] % 33, 256),
        ("C = 999, a row pitch that is not 16-byte aligned, N = 20001", c999, c999_t, 256),
        ("scores[:, 1:] of the headline, a base that is not 16-byte aligned", s_all[:, 1:],
         t_all % 999, 256),
        ("scores[:, :999] of the headline, a partial last 16-byte copy", s_all[:, :999],
         t_all % 999, 256),
        *[(f"cap {cap}, the fixed steps of that cap, (33, 3000) strided", grid[:3000, :33],
           grid_t[:3000] % 33, cap) for cap in (16, 32, 64, 128)],
    ]:
        cnt, tab = _pack_positive_tables(q_scores, q_target, q_scores.shape[1], cap)
        tabs = torch.cat([tab, -tab.flip(1)])
        got = rank_sum_counts(q_scores.T, tabs, negate=True)
        torch.cuda.synchronize()
        check(torch.equal(got, _rank_sum_counts_plain(q_scores.T, tabs, negate=True)),
              f"rank_sum_counts bit-equal to plain: {label} "
              f"[{rank_sum_plan(q_scores.T, tabs, negate=True).describe()}]")
    rows = torch.floor(torch.rand(4, 2**20, device=dev, generator=gen) * 64) / 64
    cnt, tab = _pack_row_tables(rows, torch.rand(4, 2**20, device=dev, generator=gen) < 2e-4, 512)
    tabs = torch.cat([tab, -tab.flip(1)])
    for label, q_rows, negate in [
        ("contiguous rows (4, 2^20), cap 512", rows, True),
        ("contiguous rows (4, 2^20 - 1) of the same, a partial last copy",
         rows[:, : 2**20 - 1], True),
        ("rows[:, 1:] of the same, a base that is not 16-byte aligned", rows[:, 1:], True),
        ("one row (1, 2047), less than one tile, no negate", rows[:1, :2047], False),
    ]:
        t_rows = tabs if negate else tab[: q_rows.shape[0]]
        got = rank_sum_counts(q_rows, t_rows, negate=negate)
        torch.cuda.synchronize()
        check(torch.equal(got, _rank_sum_counts_plain(q_rows, t_rows, negate=negate)),
              f"rank_sum_counts bit-equal to plain: {label} "
              f"[{rank_sum_plan(q_rows, t_rows, negate=negate).describe()}]")
    for cap in (16, 32, 64, 128):
        cnt, tab = _pack_row_tables(rows[:2, :5000], rows[2:, :5000] < 0.5, cap)
        tabs = torch.cat([tab, -tab.flip(1)])
        got = rank_sum_counts(rows[:2, :5000], tabs, negate=True)
        torch.cuda.synchronize()
        check(torch.equal(got, _rank_sum_counts_plain(rows[:2, :5000], tabs, negate=True)),
              f"rank_sum_counts bit-equal to plain: rows (2, 5000) of the same, cap {cap} "
              f"[{rank_sum_plan(rows[:2, :5000], tabs, negate=True).describe()}]")
    del grid, grid_t, c999, c999_t, rows, got

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    th, hh = sort_desc(s_all.T, class_hits(t_all, NUM_CLASSES))
    a_kernel = auc_from_sorted(th, hh)
    torch.cuda.synchronize()
    a_plain = _auc_from_sorted_plain(th, hh)
    auc_err = float((a_kernel - a_plain).abs().max())
    check(torch.equal(a_kernel, a_plain),
          f"auc_from_sorted bit-equal to plain at the headline ({c}, {n}) "
          f"[{auc_plan(th, hh, sms).describe()}]")
    x22 = torch.rand(1, 2**22, device=dev, generator=gen)
    y22 = torch.rand(1, 2**22, device=dev, generator=gen) < 0.5
    th22, hh22 = sort_desc(x22, y22)

    def sorted_rows(rows, n, levels):
        t = torch.floor(torch.rand(rows, n, device=dev, generator=gen) * levels) / levels
        return (torch.sort(t, dim=1, descending=True).values,
                torch.rand(rows, n, device=dev, generator=gen) < 0.3)

    tied22 = torch.full((1, 2**22), 0.5, device=dev)
    run_t, run_h = sorted_rows(1, 2**20, 4)  # runs of 2^18 over 64 chunks
    flag_t, flag_h = sorted_rows(8, 1024, 64)
    edge_cases = [("(1, 2^22)", th22, hh22), ("all tied (1, 2^22)", tied22, hh22),
                  ("a tie run over 64 chunks (1, 2^20)", run_t, run_h),
                  ("the flagship's (8, 1024)", flag_t, flag_h)]
    for m in (4095, 4097, 2**22 - 1, 2**22 + 3):  # a chunk edge +-1; 2^22 +-
        edge_cases.append((f"(1, {m})", *sorted_rows(1, m, 64)))
    odd_t, odd_h = sorted_rows(3, 50_000, 64)
    flat_t = torch.empty(3 * 50_000 + 1, device=dev)
    flat_t[1:].copy_(odd_t.flatten())
    flat_h = torch.empty(3 * 50_000 + 1, dtype=torch.bool, device=dev)
    flat_h[1:].copy_(odd_h.flatten())
    edge_cases.append(("(3, 50000), operands not 16-byte aligned",
                       flat_t[1:].view(3, 50_000), flat_h[1:].view(3, 50_000)))
    for label, t_case, h_case in edge_cases:
        got = auc_from_sorted(t_case, h_case)
        torch.cuda.synchronize()
        check(torch.equal(got, _auc_from_sorted_plain(t_case, h_case)),
              f"auc_from_sorted bit-equal to plain at {label} "
              f"[{auc_plan(t_case, h_case, sms).describe()}]")
    del tied22, run_t, run_h, odd_t, odd_h, flat_t, flat_h, edge_cases
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
    # With no flag set, the rank route's cap (<= 512 positives, <= N/128)
    # declines a balanced 2^22 and the sort route runs the AUC scan.
    b_noflag, binary_launches = counted("BinaryAUROC 2^22, no flag (past the rank route's cap)",
                                        binary_lifecycle, binary, "auc_from_sorted")
    os.environ["TORCHEVAL_TPU_TORCH_DISABLE_USTAT"] = "1"
    try:
        b_out, _ = counted("BinaryAUROC 2^22 (sort route)", binary_lifecycle, binary,
                           "auc_from_sorted")
        mc_sorted, sort_launches = counted(
            "headline MulticlassAUROC, rank-sum route off", headline_lifecycle, sorted_mc,
            "auc_from_sorted")
    finally:
        del os.environ["TORCHEVAL_TPU_TORCH_DISABLE_USTAT"]
    check(torch.equal(b_noflag, b_out), "BinaryAUROC 2^22: the same bits with the flag and without")
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
    rank_floor = issue_floor_ms(2 * n * c, 256)
    auc_ms = median_ms(lambda: auc_from_sorted(th, hh))
    auc_plain_ms = median_ms(lambda: _auc_from_sorted_plain(th, hh))
    auc_bound, auc_by = bound(c * n * (4 + 1) + c * 4, 3 * c * n)
    auc22_ms = median_ms(lambda: auc_from_sorted(th22, hh22))
    auc22_bound, _ = bound(2**22 * 5 + 4, 3 * 2**22)
    auc_dev_ms = device_ms(torch, lambda: auc_from_sorted(th, hh))
    auc22_dev_ms = device_ms(torch, lambda: auc_from_sorted(th22, hh22))
    flag_dev_ms = device_ms(torch, lambda: auc_from_sorted(flag_t, flag_h))
    print(f"time {card}: auc_from_sorted device time a call (both launches): ({c}, {n}) "
          f"{auc_dev_ms:.4f} ms, (1, 2^22) {auc22_dev_ms:.4f} ms, (8, 1024) "
          f"{flag_dev_ms:.4f} ms", flush=True)
    print(f"time {card}: rank_sum_counts ({2 * c}, {n}) cap 256: issue floor "
          f"{rank_floor:.4f} ms ({2 * n * c} searches of 9 steps)", flush=True)
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
        profile_lifecycle(torch, card, "BinaryAUROC 2^22 lifecycle (sort route, no flag)",
                          lambda: binary_lifecycle(binary), host_ops=True)

    # ------------------------------------ 7. confusion slab vs plain version
    from torcheval_tpu_torch.convert import params_from_jax
    from torcheval_tpu_torch.flagship import FlagshipMLP, eval_step
    from torcheval_tpu_torch.metrics import MulticlassConfusionMatrix, MulticlassF1Score
    from torcheval_tpu_torch.ops.cm import _confusion_slab_plain, _slab, slab_plan

    m = CM_SAMPLES // NUM_UPDATES
    cm_t = torch.randint(0, CM_CLASSES + 1, (m,), device=dev, generator=gen, dtype=torch.int32)
    cm_p = torch.randint(0, CM_CLASSES + 1, (m,), device=dev, generator=gen, dtype=torch.int32)
    one_t = torch.zeros(m, dtype=torch.int32, device=dev)
    one_p = torch.full((m,), 7, dtype=torch.int32, device=dev)
    pick = torch.rand(m, device=dev, generator=gen) < 0.5
    slab_err = None
    for label, st, sp, sc in [
        (f"lifecycle shape ({m},), C={CM_CLASSES}, labels in [0, C]", cm_t, cm_p, CM_CLASSES),
        ("C=130", cm_t % 131, cm_p % 131, 130),
        ("C=100", cm_t % 101, cm_p % 101, 100),
        ("every sample in cell (0, 7)", one_t, one_p, CM_CLASSES),
        ("two cells, (3, 5) and (8, 9) at random", torch.where(pick, 3, 8).int(),
         torch.where(pick, 5, 9).int(), CM_CLASSES),
        ("N=100003, not a multiple of the block", cm_t[:100_003], cm_p[:100_003], CM_CLASSES),
        ("int64 labels, read in place", cm_t.long(), cm_p.long(), CM_CLASSES),
        ("int32 target, int64 prediction", cm_t, cm_p.long(), CM_CLASSES),
        ("labels not 16-byte aligned, N=100002", cm_t[1:100_003], cm_p[2:100_004], CM_CLASSES),
        ("a non-contiguous int64 view", cm_t.long()[::2], cm_p.long()[1::2], CM_CLASSES),
        ("N=0", cm_t[:0], cm_p[:0], CM_CLASSES),
    ]:
        got = _slab(st, sp, sc)
        torch.cuda.synchronize()
        want = _confusion_slab_plain(st, sp, sc)
        if slab_err is None:
            slab_err = int((got - want).abs().max())
        plan = slab_plan(st.contiguous(), sp.contiguous()).describe() if st.numel() else "no launch"
        check(torch.equal(got, want) and int(got.sum()) == st.numel(),
              f"confusion_slab bit-equal to plain: {label} [{plan}]")
    del pick

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
    # The same lifecycle on int64 labels (PyTorch's default integer): the
    # slab reads them in place, so its call runs the zero fill and the
    # kernel and no cast.
    p_chunks32, y_chunks32 = p_chunks, y_chunks
    p_chunks, y_chunks = [x.long() for x in p_chunks32], [x.long() for x in y_chunks32]
    cm_pair64 = (MulticlassConfusionMatrix(num_classes=CM_CLASSES),
                 MulticlassF1Score(num_classes=CM_CLASSES, average="macro"))
    (cm_out64, f1_out64), _ = counted(
        "1000-class CM + F1 lifecycle, int64 labels", cm_f1_lifecycle, cm_pair64,
        "confusion_slab", times=2 * NUM_UPDATES)
    check(torch.equal(cm_out64, cm_out) and torch.equal(f1_out64, f1_out),
          "the int64-label lifecycle's matrix and F1 bit-equal to the int32 one's")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _slab(p_chunks[0], y_chunks[0], CM_CLASSES)
        torch.cuda.synchronize()
    slab_ops = [e.key for e in device_events(torch, prof)]
    print(f"device ops of one slab call on int64 labels: {[k[:60] for k in slab_ops]}",
          flush=True)
    check(any("cm_slab_kernel" in k for k in slab_ops)
          and not any("copy" in k.lower() or "cast" in k.lower() for k in slab_ops),
          "a slab call on int64 labels launches the kernel and no cast or copy")
    p_chunks, y_chunks = p_chunks32, y_chunks32
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
    c100_t, c100_p = cm_t % 101, cm_p % 101
    slab_calls = {
        **slab_calls,
        "int64 labels": lambda: _slab(cm_t64, cm_p64, CM_CLASSES),
        "C=100": lambda: _slab(c100_t, c100_p, 100),
        "C=100 plain": lambda: _confusion_slab_plain(c100_t, c100_p, 100),
    }
    cm_t64, cm_p64 = cm_t.long(), cm_p.long()
    slab_dev = {k: device_ms(torch, fn) for k, fn in slab_calls.items()}
    slab_wall = {k: median_ms(fn) for k, fn in slab_calls.items()}
    slab_ms, slab_plain_ms, slab_lib_ms = (slab_dev[k] for k in ("kernel", "plain", "library"))
    slab_bound, slab_by = bound(m * 8 + (CM_CLASSES + 1) ** 2 * 4, m)
    print(f"time {card}: confusion_slab ({m},) C={CM_CLASSES}, device time per call: "
          f"kernel {slab_ms:.4f} ms, plain {slab_plain_ms:.4f} ms, library {slab_lib_ms:.4f} ms "
          f"(torch.bincount), bound {slab_bound:.4f} ms ({slab_by}); every sample in one "
          f"cell {slab_dev['one cell']:.4f} ms; int64 labels {slab_dev['int64 labels']:.4f} ms "
          f"(bound {bound(m * 16 + (CM_CLASSES + 1) ** 2 * 4, m)[0]:.4f} ms)", flush=True)
    print(f"time {card}: confusion_slab ({m},) C=100 [{slab_plan(c100_t, c100_p).describe()}], "
          f"device time per call: kernel {slab_dev['C=100']:.4f} ms, plain "
          f"{slab_dev['C=100 plain']:.4f} ms, bound {bound(m * 8 + 101**2 * 4, m)[0]:.4f} ms",
          flush=True)
    print(f"time {card}: confusion_slab, CUDA events around one call: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in slab_wall.items()), flush=True)
    cm_life_ms = host_median_ms(lambda: cm_f1_lifecycle(cm_pair))
    os.environ["TORCHEVAL_TPU_TORCH_SKIP_VALUE_CHECKS"] = "1"
    try:
        cm_life_skip_ms = host_median_ms(lambda: cm_f1_lifecycle(cm_pair))
    finally:
        del os.environ["TORCHEVAL_TPU_TORCH_SKIP_VALUE_CHECKS"]
    p_chunks, y_chunks = [x.long() for x in p_chunks32], [x.long() for x in y_chunks32]
    cm_life64_ms = host_median_ms(lambda: cm_f1_lifecycle(cm_pair64))
    p_chunks, y_chunks = p_chunks32, y_chunks32
    print(f"time {card}: 1000-class CM + F1 lifecycle (8 updates + 2 computes): "
          f"{cm_life_ms:.3f} ms; with value checks skipped {cm_life_skip_ms:.3f} ms; on int64 "
          f"labels, no cast before the slab, {cm_life64_ms:.3f} ms", flush=True)
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
    from torcheval_tpu_torch.ops.binned import (
        _binned_counts_plain,
        binned_count_plan,
        binned_counts,
    )
    from torcheval_tpu_torch.ops.ustat import (
        _rank_hist_counts_plain,
        rank_hist_counts,
        rank_hist_plan,
    )

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

    print(f"rank_hist_counts at the headline: {rank_hist_plan(s_all.T, table).describe()}",
          flush=True)
    for label, q, tab in [
        ("ties on a 1/8 grid, half-pad tables, (64, 2^16) strided, cap 256",
         grid8((2**16, 64)).T, rand_tables(64, 256, 128)),
        ("N = 100003 (not a multiple of the tile), (250, N) strided, cap 512",
         grid8((100_003, 250)).T, rand_tables(250, 512, 200)),
        ("37 contiguous rows, (37, 50000), cap 64", grid8((37, 50_000)),
         rand_tables(37, 64, 10)),
        ("pinned cap 4096 (tables and counts in global memory), (64, 50000) strided",
         grid8((50_000, 64)).T, rand_tables(64, 4096, 1000)),
        ("cap 784, the first cap past shared memory, (33, 3000) strided",
         grid8((3000, 33)).T, rand_tables(33, 784, 300)),
        ("cap 80, not a power of two (guarded steps), (40, 5000) strided",
         grid8((5000, 40)).T, rand_tables(40, 80, 20)),
        ("31 rows, N = 63, less than one tile", grid8((63, 31)).T, rand_tables(31, 256, 128)),
        ("33 rows, N = 65, a tile and one sample", grid8((65, 33)).T, rand_tables(33, 256, 128)),
        ("C = 999, a row pitch that is not 16-byte aligned, N = 20001",
         grid8((20_001, 999)).T, rand_tables(999, 256, 128)),
        ("scores[:, 1:] of the headline, a base that is not 16-byte aligned",
         s_all[:, 1:].T, rand_tables(999, 256, 128)),
        ("scores[:, :999] of the headline, a partial last 16-byte copy",
         s_all[:, :999].T, rand_tables(999, 256, 128)),
        ("2 contiguous rows, N = 2047, less than one tile", grid8((2, 2047)),
         rand_tables(2, 256, 100)),
        *[(f"cap {cap}, the fixed steps of that cap, (33, 3000) strided",
           grid8((3000, 33)).T, rand_tables(33, cap, cap // 4)) for cap in (16, 32, 64, 128)],
        *[(f"2 contiguous rows, N = 5000, cap {cap}", grid8((2, 5000)),
           rand_tables(2, cap, cap // 4)) for cap in (16, 32)],
    ]:
        got = rank_hist_counts(q, tab)
        torch.cuda.synchronize()
        check(torch.equal(got, _rank_hist_counts_plain(q, tab)) and int(got[0].sum()) == 0,
              f"rank_hist_counts bit-equal to plain: {label} [{rank_hist_plan(q, tab).describe()}]")

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
        ("two bins at random, (1, 2^19) x 10000",
         torch.where(torch.rand_like(upd_s) < 0.5, 0.37, 0.81), upd_h, grid10k),
        ("scores[:, 1:] of (2, 100003), not 16-byte aligned, N % 4 != 0", special[:, 1:],
         hits2[:, 1:], grid200),
        ("a geometric grid of 1000 (slot_of's binary search), (2, 100003)", special.abs(), hits2,
         torch.logspace(-6, 0, 1000, device=dev)),
        ("T = 1", special, hits2, _create_threshold_tensor(1, dev)),
        ("N = 0", special[:, :0], hits2[:, :0], grid200),
    ]:
        got = binned_counts(bs, bh, bt)
        torch.cuda.synchronize()
        want = _binned_counts_plain(bs, bh, bt)
        if bin_err is None:
            bin_err = max(int((g - w).abs().max()) for g, w in zip(got, want))
        plan = binned_count_plan(bs, bh, bt.numel()).describe() if bs.numel() else "no launch"
        check(all(g.dtype == torch.int32 and torch.equal(g, w) for g, w in zip(got, want)),
              f"binned_counts bit-equal to plain: {label} [{plan}]")
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
    hist_floor = issue_floor_ms(n * c, 256, extra=2)  # and a shared-memory atomic
    print(f"time {card}: rank_hist_counts ({c}, {n}) cap 256: kernel {hist_ms:.4f} ms, "
          f"plain {hist_plain_ms:.4f} ms, library none, bound {hist_bound:.4f} ms ({hist_by}), "
          f"issue floor {hist_floor:.4f} ms", flush=True)
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

    def split_text(fn):
        return ", ".join(f"{k} {v:.4f} ms" for k, v in sorted(device_split(torch, fn).items()))

    print(f"time {card}: binned_counts (1, {m_bin}) x {BINNED_THRESHOLDS} "
          f"[{binned_count_plan(upd_s, upd_h, BINNED_THRESHOLDS).describe()}], device time per "
          f"call: kernel {bin_ms:.4f} ms, plain {bin_plain_ms:.4f} ms, library none, bound "
          f"{bin_bound:.4f} ms ({bin_by}); every score in one bin {bin_dev['one bin']:.4f} ms; "
          "CUDA events around one call: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in bin_wall.items()), flush=True)
    print(f"time {card}: binned_counts (1, {m_bin}) x {BINNED_THRESHOLDS}, device time per call "
          f"by kernel: {split_text(bin_calls['kernel'])}; every score in one bin: "
          f"{split_text(bin_calls['one bin'])}", flush=True)
    g32_s, g32_h = s_chunks[0].T, class_hits(t_chunks[0], NUM_CLASSES)
    g32 = lambda: binned_counts(g32_s, g32_h, grid200)  # noqa: E731
    g32_bound = bound(g32_s.numel() * 5 + 200 * 4 + (2 * NUM_CLASSES * 200 + 2 * NUM_CLASSES) * 4,
                      g32_s.numel() * 8)[0]
    print(f"time {card}: binned_counts ({NUM_CLASSES}, {n // NUM_UPDATES}) strided x 200 "
          f"[{binned_count_plan(g32_s, g32_h, 200).describe()}]: device time per call "
          f"{device_ms(torch, g32):.4f} ms ({split_text(g32)}), bound {g32_bound:.4f} ms",
          flush=True)
    del g32_h
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
    from torcheval_tpu_torch.metrics._bucket import bucket_size
    from torcheval_tpu_torch.metrics.toolkit import sync_and_compute
    from torcheval_tpu_torch.ops._mega_plan import plan_for
    from torcheval_tpu_torch.ops.mega import _mega_counts_plain, launch_plans, mega_counts

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

    def plans_of(plan, x):
        return "; ".join(lp.describe() for lp in launch_plans(
            plan, x.shape[0], sms, x.data_ptr() % 16 == 0 or plan.features == 0))

    os.environ["TORCHEVAL_TPU_TORCH_MEGAKERNEL"] = "1"  # plan single members too
    try:
        main_plan, main_ops = mega_case(five(COL_CLASSES), col_x[0], col_y[0])
        ok, mega_err = mega_equal(main_plan, main_ops)
        check(ok, f"mega_counts bit-equal to plain at the main path's update "
                  f"({COL_SAMPLES // NUM_UPDATES}, {COL_CLASSES}), five members "
                  f"[{plans_of(main_plan, col_x[0])}]")
        for m in (1, 31, 33, 128, 512, 513, 4096, 4097):
            ex = torch.rand(m, SLICED_CLASSES, device=dev, generator=gen)
            ey = torch.randint(-2, SLICED_CLASSES + 2, (m,), device=dev, generator=gen,
                               dtype=torch.int32)
            emask = (torch.rand(m, device=dev, generator=gen) < 0.8).to(torch.int32)
            eids = torch.randint(-1, SLICES + 1, (m,), device=dev, generator=gen,
                                 dtype=torch.int32)
            plan, ops = mega_case(five(SLICED_CLASSES), ex, ey, emask, eids, SLICES)
            ok, _ = mega_equal(plan, ops)
            check(ok, f"mega_counts bit-equal to plain: n={m}, C={SLICED_CLASSES}, "
                      f"{SLICES} slices, a mask [{plans_of(plan, ex)}]")
        many = {f"acc{i}": MulticlassAccuracy(num_classes=5, average="macro") for i in range(70)}
        for m in (300, 9000):
            ex = torch.randn(m, 5, device=dev, generator=gen)
            ey = torch.randint(0, 5, (m,), device=dev, generator=gen, dtype=torch.int32)
            eids = torch.randint(0, 2, (m,), device=dev, generator=gen, dtype=torch.int32)
            plan, ops = mega_case(many, ex, ey, None, eids, 2)
            _build.reset_counts()
            ok, _ = mega_equal(plan, ops)
            check(ok and _build.LAUNCHES["mega_counts"] == 2,
                  f"mega_counts bit-equal to plain: 70 members, two launches, n={m} "
                  f"[{plans_of(plan, ex)}]")
        unaligned = torch.empty(col_x[0].numel() + 1, device=dev)
        unaligned[1:].copy_(col_x[0].flatten())
        ux = unaligned[1:].view(col_x[0].shape)
        ok, _ = mega_equal(main_plan, (ux, col_y[0], None, None, []))
        check(ok, f"mega_counts bit-equal to plain: the main path's update, scores not "
                  f"16-byte aligned [{plans_of(main_plan, ux)}]")
        del unaligned, ux
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
        sl_plan, sl_ops = mega_case(five(SLICED_CLASSES), sl, sl_y, sl_mask, sl_ids, SLICES)
        sl_counter_bytes = sum(t.numel() * 4 for pair in mega_counts(sl_plan, *sl_ops)
                               for t in pair if t is not None)
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

    # mega.cu at the sliced stream's batches: its device time over the 96
    # fused_update, divided by its own count of launches there.
    from torch.profiler import ProfilerActivity, profile

    sliced_updates()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sliced_updates()
        torch.cuda.synchronize()
    mega_rows = [e for e in device_events(torch, prof) if "mega_kernel" in e.key]
    sl_launches = sum(e.count for e in mega_rows)
    sl_mega_ms = (sum(device_us(e) for e in mega_rows) / 1e3 / sl_launches
                  if sl_launches else None)
    sl_in_bytes = sum(bucket_size(b) * (SLICED_CLASSES * 4 + 12) for b in sizes) / len(sizes)
    sl_bound, sl_by = bound(sl_in_bytes + sl_counter_bytes, 0)
    print(f"time {card}: mega_counts at the sliced stream's batches (C={SLICED_CLASSES}, "
          f"{SLICES} slices, bucket=True), device time a launch: "
          f"{'not measured' if sl_mega_ms is None else f'{sl_mega_ms:.4f} ms'} over "
          f"{sl_launches} launches of {len(sizes)} fused_update; bound {sl_bound:.6f} ms "
          f"({sl_by}: {sl_in_bytes:.0f} B of batch, {sl_counter_bytes} B of counters)",
          flush=True)
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
        _BAND_ROWS,
        _edit_distance_kernel,
        _edit_distance_native,
        _edit_distance_plain,
        _strip_rows,
        _wavefront_plan,
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
        if n_pairs:
            rows = torch.minimum(la, lb).cpu().numpy()
            blocks, scratch_len = _wavefront_plan(n_pairs, a.shape[1], b.shape[1])
            print(f"   route: a warp a pair, rows a lane R in "
                  f"{sorted({_strip_rows(int(m)) for m in rows})}, bands up to "
                  f"{max(1, -(-int(rows.max()) // _BAND_ROWS))}, {blocks} blocks, carry scratch "
                  f"{scratch_len} int32", flush=True)
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
    # The warp-a-pair geometry's edges: each strip height R at 32 R rows and
    # one past, two and three bands of 256 rows, each side far longer.
    for la_e, lb_e in [(31, 40), (32, 32), (33, 90), (64, 70), (65, 65), (128, 128), (129, 129),
                       (255, 256), (256, 300), (257, 257), (512, 512), (513, 700), (5, 4000),
                       (4000, 5)]:
        wave_case(f"exact lengths ({la_e}, {lb_e}), 7 pairs from 5",
                  wrng.integers(0, 5, (7, la_e)).astype(np.int32),
                  wrng.integers(0, 5, (7, lb_e)).astype(np.int32))
    mix_la = np.array([0, 1, 4096, 0, 1, 4096, 300, 4096, 17, 2], np.int32)
    mix_lb = np.array([0, 0, 4096, 4096, 1, 1, 4096, 257, 4096, 4000], np.int32)
    mix_a = wrng.integers(0, 30, (10, 4096)).astype(np.int32)
    mix_b = wrng.integers(0, 30, (10, 4096)).astype(np.int32)
    mix_a[np.arange(4096)[None, :] >= mix_la[:, None]] = -1
    mix_b[np.arange(4096)[None, :] >= mix_lb[:, None]] = -1
    wave_case("a mixed batch of empty, one-token and 4096-token pairs", mix_a, mix_b)

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
    lm_x, lm_t = lm_batches[0]
    lm_ids = lm_x.argmax(dim=-1).to(torch.int32)
    lm_ref = lm_t.to(torch.int32)
    lm_dev_ms = device_ms(torch, lambda: edit_distance_tokens(lm_ids, lm_ref))
    print(f"time {card}: edit_distance_tokens ({per}, 256) x ({per}, 256), {cells} DP cells: "
          f"kernel {wave_ms:.4f} ms, plain {wave_plain_ms:.4f} ms, library none, bound "
          f"{wave_bound:.4f} ms ({wave_by}: {CELL_OPS} int32 operations a cell at "
          f"{INT32_OPS_PER_S:.3g}/s; the bytes alone {by_bytes * 1e3:.4f} ms); at the WER "
          f"stream's largest batch {tuple(big_h.shape)} x {tuple(big_r.shape)}, device time per "
          f"call (lengths, kernel) {st_dev_ms:.4f} ms; at an LM logits update's argmax "
          f"{tuple(lm_ids.shape)} x {tuple(lm_ref.shape)} {lm_dev_ms:.4f} ms", flush=True)
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
        _fixed_point_exponent,
        _weight_range,
        _weight_range_plain,
        binned_weighted_counts,
    )

    def fixed_exponent(w):
        return _fixed_point_exponent(*_weight_range(w), w.shape[0])
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
    # Each kernel's total over its own count of calls: a profile that
    # misses a call's kernel must not divide what it saw by every call.
    split = sorted(((e.key, device_us(e) / 1e3 / e.count, e.count)
                    for e in device_events(torch, prof)), key=lambda r: -r[1])
    print(f"   device time a call by kernel: " + "; ".join(
        f"{key[:48]} {ms:.4f} ms (x{count})" for key, ms, count in split[:5]), flush=True)
    edge_s = torch.rand(2, 100_003, device=dev, generator=gen)
    edge_s[0, :6] = torch.tensor([float("nan"), float("inf"), -float("inf"), -1.0, 2.0, 0.5])
    edge_h = torch.rand(2, 100_003, device=dev, generator=gen) < 0.4
    edge_w = torch.rand(100_003, device=dev, generator=gen) + 0.5
    mixed_w = (edge_w - 1.0) * 3.0
    mixed_w[::7] = 0.0
    view_s = torch.rand(4096 * 3 + 7, NUM_CLASSES // 10, device=dev, generator=gen)
    view_y = torch.randint(0, NUM_CLASSES // 10, (4096 * 3 + 7,), device=dev, generator=gen)
    view_w = torch.rand(4096 * 3 + 7, device=dev, generator=gen) + 0.5
    # The fixed-point range over 100 003 samples: q = 2^(1 + 17 - 62) for
    # max|w| in [1, 2), down to min|w| = 2^21 q = 2^-23.  The tiny weights
    # score 1.0: they alone fill the top slot's cells.
    edge_s_top = edge_s.clone()
    edge_s_top[:, 6:56] = 1.0
    low_w, past_w = edge_w.clone(), edge_w.clone()
    low_w[6:56], low_w[56] = 2.0**-23, 1.5
    past_w[6:56], past_w[56] = 2.0**-23 * (1 - 2.0**-20), 1.5
    high_w = torch.full_like(edge_w, 1.9999999)
    check(fixed_exponent(low_w) == -44 and fixed_exponent(past_w) is None,
          "the range's low edge takes the fixed point (q = 2^-44), just past it the f64 route")
    nonfinite_w = edge_w.clone()
    nonfinite_w[3], nonfinite_w[9] = float("inf"), float("nan")
    range_pairs = [(_weight_range(x), _weight_range_plain(x)) for x in (
        edge_w, mixed_w, low_w, past_w, high_w, torch.zeros_like(edge_w), nonfinite_w,
        wh_w)]
    check(all(str(a) == str(b) for a, b in range_pairs),
          "the weights' range (max |w|, smallest finite nonzero |w|) from the range kernel "
          "equal to its plain version on 8 weight vectors (NaN, inf and all-zero among them)")
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
        ("weights at the low edge of the fixed-point range (min |w| = 2^21 q = 2^-23), alone "
         "in the top slot", edge_s_top, edge_h, low_w, _create_threshold_tensor(200, dev)),
        ("weights just past it (2^-23 (1 - 2^-20)): the f64 route", edge_s_top, edge_h, past_w,
         _create_threshold_tensor(200, dev)),
        ("weights at the high edge (N max|w| just under 2^62 q)", edge_s, edge_h, high_w,
         _create_threshold_tensor(200, dev)),
        ("one row (1, 2^20) x 16384 (slot windows)", edge_s[:1].repeat(1, 11)[:, :2**20],
         edge_h[:1].repeat(1, 11)[:, :2**20], edge_w.repeat(11)[:2**20],
         _create_threshold_tensor(16_384, dev)),
    ]:
        _build.reset_counts()
        got = binned_weighted_counts(es, eh, ew, et)
        torch.cuda.synchronize()
        routes = dict(_build.LAUNCHES)
        launched = sum(routes.values())
        ok, err = within(got, _binned_weighted_counts_plain(es, eh, ew, et),
                         _binned_weighted_counts_plain(es, eh, ew.abs(), et))
        twice = all(torch.equal(a, b) for a, b in zip(got, binned_weighted_counts(es, eh, ew, et)))
        unit = all(torch.equal(a, b.to(torch.float32)) for a, b in zip(
            binned_weighted_counts(es, eh, torch.ones_like(ew), et), binned_counts(es, eh, et)))
        check(ok and twice and unit and launched == (0 if es.shape[1] == 0 else 1),
              f"binned_weighted_counts: {label}: within tolerance of plain (max err {err:.3e}), "
              f"same bits twice, unit weights bit-equal to binned_counts, {launched} launch(es)")
        print(f"   route: {routes or 'none'}", flush=True)
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

    def world_launches(label, size, fn, want):
        """``world(size, fn)`` with the counters zeroed just before it;
        fails unless it launched exactly ``want`` and no plain version."""
        _build.reset_counts()
        out = world(size, fn)
        launches, plain = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
        check(launches == want and not plain, f"{label}: launches {launches}, no plain call")
        return out

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
        _build.reset_counts()
        got = binned_weighted_counts(s, h, w, grid)
        torch.cuda.synchronize()
        print(f"   route: {dict(_build.LAUNCHES)}", flush=True)
        ok, err = within(got, _binned_weighted_counts_plain(s, h, w, grid),
                         _binned_weighted_counts_plain(s, h, w.abs(), grid))
        twice = all(torch.equal(a, b) for a, b in zip(got, binned_weighted_counts(s, h, w, grid)))
        unit = all(torch.equal(a, b.to(torch.float32)) for a, b in zip(
            binned_weighted_counts(s, h, torch.ones_like(w), grid), counts))
        check(ok and twice and unit,
              f"binned_weighted_counts on {label}: within 1e-6 x sum|w| of plain (max err "
              f"{err:.3e}), same bits twice, unit weights bit-equal to binned_counts")
        rows, n_block = s.shape
        t_block = grid.numel()
        counts_call = lambda: binned_counts(s, h, grid)  # noqa: E731
        counts_bound, counts_by = bound(
            rows * n_block * 5 + t_block * 4 + (2 * rows * t_block + 2 * rows) * 4,
            rows * n_block * int(np.ceil(np.log2(t_block + 1))))
        print(f"time {card}: binned_counts on {label} "
              f"[{binned_count_plan(s, h, t_block).describe()}]: device time per call "
              f"{device_ms(torch, counts_call):.4f} ms "
              f"({', '.join(f'{k} {v:.4f} ms' for k, v in sorted(device_split(torch, counts_call).items()))}), "
              f"CUDA events {median_ms(counts_call):.4f} ms, bound {counts_bound:.4f} ms ({counts_by})",
              flush=True)
        block_ms = median_ms(lambda: binned_weighted_counts(s, h, w, grid))
        block_bound, block_by = bound(
            rows * n_block * 5 + n_block * 4 + t_block * 4 + (2 * rows * t_block + 2 * rows) * 4,
            rows * n_block * (int(np.ceil(np.log2(t_block + 1))) + 2))
        print(f"time {card}: binned_weighted_counts on {label}: kernel {block_ms:.4f} ms, bound "
              f"{block_bound:.4f} ms ({block_by})", flush=True)
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
    ns_auroc = world_launches(
        f"sharded_multiclass_auroc_histogram ({NUM_SAMPLES}, {NUM_CLASSES}) x {ns_bins}, "
        "LocalWorld(4), unweighted", 4, ns_call(), {"binned_counts": 4})
    ns_wauroc = world_launches(
        "the same, weighted", 4, ns_call(ns_w), {"binned_weighted_counts": 4})
    ns_wlaunches = _build.LAUNCHES["binned_weighted_counts"]
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
        bs_out[name] = world_launches(f"{name} 2^22 x {bs_bins}, LocalWorld(4), unweighted",
                                      4, bs_call(fn), {"binned_counts": 4})
        bs_out[name + " weighted"] = world_launches(
            f"{name}, weighted", 4, bs_call(fn, bs_w), {"binned_weighted_counts": 4})
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

    # ------------------------------ 30. the 1M-sample windowed AUROC (sort route)
    from concurrent.futures import ThreadPoolExecutor

    from torcheval_tpu_torch.metrics import (
        FrechetInceptionDistance,
        PeakSignalNoiseRatio,
        StructuralSimilarity,
        WindowedBinaryAUROC,
        WindowedBinaryNormalizedEntropy,
        WindowedClickThroughRate,
        WindowedMeanSquaredError,
        WindowedWeightedCalibration,
    )
    from torcheval_tpu_torch.metrics.functional.image._precision import full_f32
    from torcheval_tpu_torch.metrics.functional.image.ssim import _gaussian_1d, _gaussian_window
    from torcheval_tpu_torch.metrics.toolkit import clone_metric
    from torcheval_tpu_torch.metrics.window.auroc import _ring_insert
    from torcheval_tpu_torch.ops.ustat import binary_ustat_route

    def ring_model(batches, w):
        """A numpy ring over the last axis: each batch written at the cursor
        mod ``w``; a batch of ``w`` or more keeps its last ``w``."""
        ring = np.zeros(batches[0].shape[:-1] + (w,), np.float32)
        cur = valid = 0
        for b in batches:
            n = b.shape[-1]
            if n >= w:
                ring[...] = b[..., -w:]
                cur, valid = 0, w
            else:
                ring[..., (cur + np.arange(n)) % w] = b
                cur, valid = (cur + n) % w, min(valid + n, w)
        return ring, cur, valid

    def window_lifecycle(batches):
        def run(metric):
            metric.reset()
            for s, t in batches:
                metric.update(s, t)
            return metric.compute()
        return run

    def ring_equal(metric, s_batches, t_batches, w):
        want_s, cur, valid = ring_model(s_batches, w)
        want_t, _, _ = ring_model(t_batches, w)
        rows = metric.inputs.shape[0]
        return (np.array_equal(metric.inputs.cpu().numpy(), want_s.reshape(rows, w))
                and np.array_equal(metric.targets.cpu().numpy(), want_t.reshape(rows, w))
                and (metric.next_inserted, metric._num_valid) == (cur, valid))

    win_rng = np.random.default_rng(14)  # benchmarks/workloads.py's bench_windowed_auroc
    win_w, win_batch, win_updates = 2**20, 2**16, 32
    win_s_np = win_rng.random(win_batch * win_updates, dtype=np.float32)
    win_t_np = (win_rng.random(win_batch * win_updates) > 0.5).astype(np.float32)
    win_s, win_t = torch.from_numpy(win_s_np).to(dev), torch.from_numpy(win_t_np).to(dev)
    win_batches = list(zip(win_s.split(win_batch), win_t.split(win_batch)))
    win = WindowedBinaryAUROC(max_num_samples=win_w)
    win_auc, win_launches = counted(
        f"WindowedBinaryAUROC(max_num_samples=2^20), {win_updates} updates of 2^16 "
        "(the window wraps twice)", window_lifecycle(win_batches), win, "auc_from_sorted")
    check(binary_ustat_route(win.inputs, win.targets) is None,
          "the balanced 2^20 window is past the rank route's cap: the sort route")
    check(ring_equal(win, np.split(win_s_np, win_updates), np.split(win_t_np, win_updates), win_w),
          "the 2^20 ring (scores, targets, cursor, fill) bit-equal to the numpy ring model")
    win_want = oracle_auc(win_s_np[-win_w:], win_t_np[-win_w:] == 1)
    win_err = abs(float(win_auc) - win_want)
    check(win_err <= TOL, f"windowed AUROC {float(win_auc)!r} vs float64 Mann-Whitney over the "
          f"last 2^20 samples {win_want!r}: err {win_err:.3e}")
    # The kernel at the compute's own operands, against its plain version.
    win_th, win_hh = sort_desc(win.inputs, win.targets)
    check(torch.equal(auc_from_sorted(win_th, win_hh), _auc_from_sorted_plain(win_th, win_hh)),
          f"auc_from_sorted bit-equal to plain on the window's sorted (1, 2^20) operands "
          f"[{auc_plan(win_th, win_hh, sms).describe()}]")
    # Batches that do not divide the window: inserts that wrap past its end
    # (two slice copies), then one batch larger than the window.
    odd_n = 3 * 2**15 + 1
    odd_cuts = list(range(odd_n, win_s.numel(), odd_n))
    odd_s, odd_t = np.split(win_s_np, odd_cuts), np.split(win_t_np, odd_cuts)
    odd = WindowedBinaryAUROC(max_num_samples=win_w)
    odd_auc, _ = counted(f"WindowedBinaryAUROC 2^20, {len(odd_s)} updates of {odd_n} (wrapped "
                         "inserts)", window_lifecycle(
                             [(torch.from_numpy(s).to(dev), torch.from_numpy(t).to(dev))
                              for s, t in zip(odd_s, odd_t)]), odd, "auc_from_sorted")
    check(ring_equal(odd, odd_s, odd_t, win_w) and torch.equal(odd_auc, win_auc),
          "wrapped inserts: the ring bit-equal to the numpy model, the same AUROC bits")
    big = clone_metric(odd).update(win_s[:win_w + 5], win_t[:win_w + 5])
    check(ring_equal(big, odd_s + [win_s_np[:win_w + 5]], odd_t + [win_t_np[:win_w + 5]], win_w),
          "a batch of 2^20 + 5 keeps its last 2^20 samples and resets the cursor")
    # Merge: the window of the stream's first million into the last million's.
    early = WindowedBinaryAUROC(max_num_samples=win_w)
    for s, t in win_batches[:win_updates // 2]:
        early.update(s, t)
    merged = clone_metric(win).merge_state([early])
    _build.reset_counts()
    merged_auc = merged.compute()
    torch.cuda.synchronize()
    print(f"merged windows, compute: launches {dict(_build.LAUNCHES)}, plain calls "
          f"{dict(_build.PLAIN_CALLS)}", flush=True)
    check(dict(_build.LAUNCHES) == {"auc_from_sorted": 1} and not _build.PLAIN_CALLS,
          "the merged window's compute launched auc_from_sorted once, no plain version")
    check(merged.max_num_samples == 2 * win_w and merged._num_valid == 2 * win_w
          and torch.equal(merged.inputs[0], torch.cat([win.inputs[0], early.inputs[0]])),
          "merge grew the window to 2^21 and packed both rings")
    merged_want = oracle_auc(win_s_np, win_t_np == 1)
    merged_err = abs(float(merged_auc) - merged_want)
    check(merged_err <= TOL, f"merged 2^21 window AUROC vs float64 Mann-Whitney over the whole "
          f"stream: err {merged_err:.3e}")
    del big, merged, early

    # -------------------- 31. a rare-positive windowed AUROC (rank-sum route)
    rare_rng = np.random.default_rng(17)
    rare_tasks, rare_w, rare_batch, rare_updates = 16, 2**17, 2**13, 32
    rare_s_np = rare_rng.random((rare_tasks, rare_batch * rare_updates), dtype=np.float32)
    rare_t_np = (rare_rng.random(rare_s_np.shape) < 1 / 512).astype(np.float32)
    rare_batches = list(zip(torch.from_numpy(rare_s_np).to(dev).split(rare_batch, dim=1),
                            torch.from_numpy(rare_t_np).to(dev).split(rare_batch, dim=1)))
    rare = WindowedBinaryAUROC(num_tasks=rare_tasks, max_num_samples=rare_w)
    rare_auc, rare_launches = counted(
        f"WindowedBinaryAUROC(num_tasks=16, max_num_samples=2^17), positives 1/512, "
        f"{rare_updates} updates of 2^13", window_lifecycle(rare_batches), rare,
        "rank_sum_counts")
    rare_route = binary_ustat_route(rare.inputs, rare.targets)
    print(f"rare window: rank route {rare_route}, positives a task "
          f"{rare.targets.sum(dim=1).int().tolist()}", flush=True)
    check(ring_equal(rare, np.split(rare_s_np, rare_updates, axis=1),
                     np.split(rare_t_np, rare_updates, axis=1), rare_w),
          "the (16, 2^17) rings bit-equal to the numpy ring model")
    rare_want = np.array([oracle_auc(rare_s_np[k, -rare_w:], rare_t_np[k, -rare_w:] == 1)
                          for k in range(rare_tasks)])
    rare_err = float(np.abs(rare_auc.cpu().numpy().astype(np.float64) - rare_want).max())
    check(rare_err <= TOL, f"rank route, 16 tasks vs float64 Mann-Whitney: max err {rare_err:.3e}")
    # One count moves a task's AUROC by 1/(p q), about 3e-8 here, so the
    # oracle alone cannot see a miscount: the kernel at the compute's own
    # operands (the stacked (32, 2^17) form), against its plain version.
    rare_cap = rare_route[1]
    rare_counts, rare_table = _pack_row_tables(rare.inputs, rare.targets == 1, rare_cap)
    rare_tables = torch.cat([rare_table, -rare_table.flip(1)])
    check(torch.equal(rank_sum_counts(rare.inputs, rare_tables, negate=True),
                      _rank_sum_counts_plain(rare.inputs, rare_tables, negate=True)),
          f"rank_sum_counts bit-equal to plain on the window's operands, cap {rare_cap} "
          f"[{rank_sum_plan(rare.inputs, rare_tables, negate=True).describe()}]")
    rare_th, rare_hh = sort_desc(rare.inputs, rare.targets)
    check(torch.equal(auc_from_sorted(rare_th, rare_hh), _auc_from_sorted_plain(rare_th, rare_hh)),
          f"auc_from_sorted bit-equal to plain on the window's sorted (16, 2^17) operands "
          f"[{auc_plan(rare_th, rare_hh, sms).describe()}]")
    del rare_th, rare_hh
    os.environ["TORCHEVAL_TPU_TORCH_DISABLE_USTAT"] = "1"
    try:
        rare_sorted, _ = counted("the same window with TORCHEVAL_TPU_TORCH_DISABLE_USTAT=1",
                                 window_lifecycle(rare_batches), rare, "auc_from_sorted")
    finally:
        del os.environ["TORCHEVAL_TPU_TORCH_DISABLE_USTAT"]
    rare_gap = float((rare_sorted - rare_auc).abs().max())
    rare_sort_err = float(np.abs(rare_sorted.cpu().numpy().astype(np.float64) - rare_want).max())
    check(rare_gap <= TOL and rare_sort_err <= TOL,
          f"sort route: within {rare_gap:.3e} of the rank route, {rare_sort_err:.3e} of the oracle")

    # ------------- 32. the four windowed members on click-prediction traffic
    # Each update is one (8, 2^16) batch of 8 tasks: the model's predicted
    # click probability p and the 0/1 click, each member fed as its users
    # feed it.  NE (from probabilities) and weighted calibration both take
    # (p, click), so they run in one MetricCollection through update(); CTR
    # takes the clicks alone; MSE takes (prediction, target) as (2^16, 8):
    # 2^16 samples of 8 outputs (raw_values), each task's Brier score.
    from torcheval_tpu_torch.metrics import MetricCollection

    cw_rng = np.random.default_rng(32)
    cw_tasks, cw_n, cw_updates, cw_w = 8, 2**16, 250, 100
    cw_eps = float(np.finfo(np.float32).eps)
    cw_stats = {k: [] for k in ("ne", "ctr", "wc", "mse")}
    cw_batches = []
    for _ in range(cw_updates):
        p = (0.01 + 0.19 * cw_rng.random((cw_tasks, cw_n), dtype=np.float32)).astype(np.float32)
        click = (cw_rng.random((cw_tasks, cw_n)) < p).astype(np.float32)
        x, y = p.astype(np.float64), click.astype(np.float64)
        ce = -(y * np.log(x) + (1 - y) * np.log1p(-x))
        cw_stats["ne"].append([ce.sum(1), np.full(cw_tasks, cw_n, np.float64), y.sum(1)])
        cw_stats["ctr"].append([y.sum(1), np.full(cw_tasks, cw_n, np.float64)])
        cw_stats["wc"].append([x.sum(1), y.sum(1)])
        cw_stats["mse"].append([((x - y) ** 2).sum(1), np.full(cw_tasks, cw_n, np.float64)])
        p_dev, click_dev = torch.from_numpy(p).to(dev), torch.from_numpy(click).to(dev)
        cw_batches.append((p_dev, click_dev, p_dev.T.contiguous(), click_dev.T.contiguous()))
    cw_stats = {k: np.asarray(v) for k, v in cw_stats.items()}

    def baseline(q):
        q = np.clip(q, cw_eps, 1 - cw_eps)
        return -q * np.log(q) - (1 - q) * np.log1p(-q)

    def cw_figures(sl):
        ent, ex, pos = cw_stats["ne"][sl].sum(0)
        return {"ne": (ent / ex) / baseline(pos / ex),
                **{k: np.divide(*cw_stats[k][sl].sum(0)) for k in ("ctr", "wc", "mse")}}

    kw = {"max_num_updates": cw_w}
    cw_col = MetricCollection({
        "ne": WindowedBinaryNormalizedEntropy(num_tasks=cw_tasks, **kw),
        "wc": WindowedWeightedCalibration(num_tasks=cw_tasks, **kw),
    })
    cw_ctr = WindowedClickThroughRate(num_tasks=cw_tasks, **kw)
    cw_mse = WindowedMeanSquaredError(multioutput="raw_values", **kw)

    def cw_lifecycle():
        for m in (cw_col, cw_ctr, cw_mse):
            m.reset()
        for p, click, p_rows, click_rows in cw_batches:
            cw_col.update(p, click)
            cw_ctr.update(click)
            cw_mse.update(p_rows, click_rows)
        return {**cw_col.compute(), "ctr": cw_ctr.compute(), "mse": cw_mse.compute()}

    _build.reset_counts()
    cw_out = cw_lifecycle()
    torch.cuda.synchronize()
    check(not _build.LAUNCHES and not _build.PLAIN_CALLS,
          f"the windowed members ({cw_updates} updates) ran no kernel wrapper and no plain version")
    want_life, want_win = cw_figures(slice(None)), cw_figures(slice(-cw_w, None))
    for name in ("ne", "ctr", "wc", "mse"):
        life, window = (t.cpu().numpy().astype(np.float64) for t in cw_out[name])
        err = max(float(np.max(np.abs(life - want_life[name]) / np.abs(want_life[name]))),
                  float(np.max(np.abs(window - want_win[name]) / np.abs(want_win[name]))))
        check(life.shape == window.shape == (cw_tasks,) and err <= 1e-5,
              f"windowed {name}: lifetime {life.shape} and window figures vs float64 numpy over "
              f"the same columns: max relative err {err:.3e}")
    check(cw_mse.windowed_sum_squared_error.shape == (cw_tasks, cw_w)
          and all(m.max_num_updates == cw_w and m.total_updates == cw_updates
                  for m in (cw_col["ne"], cw_col["wc"], cw_ctr, cw_mse)),
          f"every ring holds {cw_w} columns after {cw_updates} updates; MSE's grew to {cw_tasks} rows")
    try:
        cw_col.fused_update(*cw_batches[0][:2])
    except ValueError as exc:
        cw_refusal = str(exc)
    else:
        cw_refusal = ""
    check("windowed member 'ne'" in cw_refusal and cw_col["ne"].total_updates == cw_updates,
          f"fused_update refuses and names the windowed member, writing nothing: {cw_refusal!r}")

    # ----------------------------------------- 33. PSNR and SSIM, full width
    img_rng = np.random.default_rng(33)
    img_shape, img_updates = (16, 3, 512, 512), 8
    g64 = _gaussian_1d(11, 1.5)

    def blur64(z):
        """A separable valid gaussian window in float64: rows, then columns."""
        k, h, w = g64.size, z.shape[-2] - g64.size + 1, z.shape[-1] - g64.size + 1
        rows = g64[0] * z[..., 0:h, :]
        for i in range(1, k):
            rows += g64[i] * z[..., i:i + h, :]
        out = g64[0] * rows[..., 0:w]
        for j in range(1, k):
            out += g64[j] * rows[..., j:j + w]
        return out

    def ssim64(x, y, pool):
        mu_x, mu_y, xx, yy, xy = (f.result() for f in [
            pool.submit(blur64, z) for z in (x, y, x * x, y * y, x * y)])
        c1, c2 = 0.01**2, 0.03**2
        sx, sy, sxy = xx - mu_x**2, yy - mu_y**2, xy - mu_x * mu_y
        smap = ((2 * mu_x * mu_y + c1) * (2 * sxy + c2)) / (
            (mu_x**2 + mu_y**2 + c1) * (sx + sy + c2))
        return smap.mean(axis=(1, 2, 3))

    img_batches, sse64, count64, lo64, hi64, ssim_parts = [], 0.0, 0, np.inf, -np.inf, []
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=5) as pool:
        for _ in range(img_updates):
            x = img_rng.random(img_shape, dtype=np.float32)
            y = np.clip(x + 0.05 * img_rng.standard_normal(img_shape, dtype=np.float32),
                        0.0, 1.0).astype(np.float32)
            img_batches.append((torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)))
            x64, y64 = x.astype(np.float64), y.astype(np.float64)
            sse64 += float(((x64 - y64) ** 2).sum())
            count64 += x.size
            lo64, hi64 = min(lo64, float(y.min())), max(hi64, float(y.max()))
            ssim_parts.append(ssim64(x64, y64, pool))
    print(f"image oracles: {time.perf_counter() - t0:.1f} s on the host", flush=True)
    psnr_want = 10 * np.log10((hi64 - lo64) ** 2 / (sse64 / count64))
    psnr1_want = 10 * np.log10(1.0 / (sse64 / count64))
    ssim_want = float(np.concatenate(ssim_parts).mean())

    def image_lifecycle(metric):
        metric.reset()
        for x, y in img_batches:
            metric.update(x, y)
        return metric.compute()

    psnr, psnr1 = PeakSignalNoiseRatio(), PeakSignalNoiseRatio(data_range=1.0)
    ssim = StructuralSimilarity(kernel_size=11, sigma=1.5, data_range=1.0)
    _build.reset_counts()
    img_out = {name: image_lifecycle(m) for name, m in
               (("psnr", psnr), ("psnr1", psnr1), ("ssim", ssim))}
    torch.cuda.synchronize()
    check(not _build.LAUNCHES and not _build.PLAIN_CALLS,
          "the image lifecycles ran no kernel wrapper and no plain version")
    for name, want in (("psnr", psnr_want), ("psnr1", psnr1_want)):
        rel = abs(float(img_out[name]) - want) / abs(want)
        check(rel <= 1e-5, f"PSNR{' data_range=1' if name == 'psnr1' else ''} over 8 x "
              f"{img_shape}: {float(img_out[name])!r} vs float64 {want!r}, relative {rel:.3e}")
    ssim_err = abs(float(img_out["ssim"]) - ssim_want)
    check(ssim_err <= 1e-5, f"SSIM 11 x 11, sigma 1.5 over 8 x {img_shape}: "
          f"{float(img_out['ssim'])!r} vs float64 separable window {ssim_want!r}, err {ssim_err:.3e}")
    tf32_saved = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ssim_tf32 = image_lifecycle(ssim)
        check(torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32,
              "SSIM left the caller's TF32 settings on")
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_saved
    check(torch.equal(ssim_tf32, img_out["ssim"]),
          "SSIM: the same bits with cudnn.allow_tf32 and matmul.allow_tf32 set True globally")

    # ------------------------------------- 34. FID at InceptionV3's pool width
    from scipy.linalg import sqrtm as scipy_sqrtm

    fid_dim, fid_n, fid_batch = 2048, 10_000, 1250

    class FeatureNet(torch.nn.Module):
        """A small feature extractor made from numpy seed 34: (3, 32, 32)
        images, a linear map of the flattened pixels to 2048 features, then
        ReLU (non-negative, as InceptionV3's pool features are)."""

        def __init__(self):
            super().__init__()
            frng = np.random.default_rng(34)
            self.fc = torch.nn.Linear(3 * 32 * 32, fid_dim, device=dev)
            with torch.no_grad():
                self.fc.weight.copy_(torch.from_numpy(
                    (frng.standard_normal((fid_dim, 3072)) / np.sqrt(3072)).astype(np.float32)))
                self.fc.bias.copy_(torch.from_numpy(
                    (0.1 * frng.standard_normal(fid_dim)).astype(np.float32)))
            self.record = None

        def forward(self, images):
            feats = torch.relu(self.fc(images.flatten(1)))
            if self.record is not None:
                self.record.append(feats.double().cpu().numpy())
            return feats

    fid_rng = np.random.default_rng(35)
    fid_real = torch.from_numpy(fid_rng.random((fid_n, 3, 32, 32), dtype=np.float32)).to(dev)
    fid_fake = torch.from_numpy(
        (fid_rng.random((fid_n, 3, 32, 32), dtype=np.float32) ** 1.2).astype(np.float32)).to(dev)
    net = FeatureNet()

    def fid_lifecycle(metric):
        metric.reset()
        for r, f in zip(fid_real.split(fid_batch), fid_fake.split(fid_batch)):
            metric.update(r, is_real=True)
            metric.update(f, is_real=False)
        return metric.compute()

    fid = FrechetInceptionDistance(net, feature_dim=fid_dim)
    net.record = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fid_base = torch.cuda.memory_allocated()
    _build.reset_counts()
    fid_val = fid_lifecycle(fid)
    torch.cuda.synchronize()
    fid_peak = torch.cuda.max_memory_allocated()
    check(not _build.LAUNCHES and not _build.PLAIN_CALLS,
          "the FID lifecycle ran no kernel wrapper and no plain version")
    feats64 = np.concatenate(net.record)
    net.record = None
    real64, fake64 = feats64.reshape(-1, 2, fid_batch, fid_dim).transpose(1, 0, 2, 3).reshape(
        2, fid_n, fid_dim)
    t0 = time.perf_counter()
    mu_r, mu_f = real64.mean(0), fake64.mean(0)
    cov_r, cov_f = np.cov(real64, rowvar=False), np.cov(fake64, rowvar=False)
    root = scipy_sqrtm(cov_r @ cov_f)
    fid_want = float(((mu_r - mu_f) ** 2).sum() + np.trace(cov_r) + np.trace(cov_f)
                     - 2 * np.trace(root.real))
    print(f"FID oracle (float64, scipy.linalg.sqrtm at {fid_dim}): {time.perf_counter() - t0:.1f} s "
          f"on the host; peak device memory {fid_peak / 2**30:.2f} GiB, of which the lifecycle's own "
          f"{(fid_peak - fid_base) / 2**30:.3f} GiB over the {fid_base / 2**30:.2f} GiB allocated "
          "before it (images and earlier phases)", flush=True)
    del feats64, real64, fake64
    fid_rel = abs(float(fid_val) - fid_want) / abs(fid_want)
    check(fid_rel <= FID_RTOL, f"FID, D = {fid_dim}, {fid_n} real and {fid_n} fake images in "
          f"updates of {fid_batch}: {float(fid_val)!r} vs float64 oracle {fid_want!r}, relative "
          f"{fid_rel:.3e}")
    # TF32: the extractor is the caller's and rounds its own product under
    # TF32, so FID's own path is held on fixed features: the net's, taken
    # once with TF32 off, through an identity extractor.
    fid_feats = [(net(r), net(f)) for r, f in zip(fid_real.split(fid_batch),
                                                   fid_fake.split(fid_batch))]

    def feats_lifecycle(metric):
        metric.reset()
        for fr, ff in fid_feats:
            metric.update(fr, is_real=True)
            metric.update(ff, is_real=False)
        return metric.compute()

    fid_ident = FrechetInceptionDistance(lambda feats: feats, feature_dim=fid_dim)
    fid_ident_val = feats_lifecycle(fid_ident)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        fid_tf32 = feats_lifecycle(fid_ident)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = tf32_saved
    check(torch.equal(fid_tf32, fid_ident_val) and abs(float(fid_ident_val) - fid_want)
          <= FID_RTOL * abs(fid_want),
          "FID statistics and compute: the same bits with cudnn.allow_tf32 and matmul.allow_tf32 "
          "set True globally")
    del fid_feats

    # ----------------------------------------------- 35. times of phases 30-34
    win_ms = host_median_ms(lambda: window_lifecycle(win_batches)(win))
    rare_ms = host_median_ms(lambda: window_lifecycle(rare_batches)(rare))
    os.environ["TORCHEVAL_TPU_TORCH_DISABLE_USTAT"] = "1"
    try:
        rare_sort_ms = host_median_ms(lambda: window_lifecycle(rare_batches)(rare))
    finally:
        del os.environ["TORCHEVAL_TPU_TORCH_DISABLE_USTAT"]
    cw_ms = host_median_ms(cw_lifecycle)
    psnr_ms = host_median_ms(lambda: image_lifecycle(psnr))
    ssim_ms = host_median_ms(lambda: image_lifecycle(ssim))
    fid_ms = host_median_ms(lambda: fid_lifecycle(fid))
    for label, ms in [
        ("WindowedBinaryAUROC 2^20 lifecycle (32 updates + compute, sort route)", win_ms),
        ("WindowedBinaryAUROC (16, 2^17) rare positives (32 updates + compute, rank route)",
         rare_ms),
        ("the same, TORCHEVAL_TPU_TORCH_DISABLE_USTAT=1 (sort route)", rare_sort_ms),
        ("click-prediction windows: NE + weighted calibration in one MetricCollection, CTR, "
         "MSE (8 outputs), 250 updates of (8, 2^16) each + compute", cw_ms),
        ("PeakSignalNoiseRatio (8 updates of (16, 3, 512, 512) + compute)", psnr_ms),
        ("StructuralSimilarity (8 updates of (16, 3, 512, 512) + compute)", ssim_ms),
        ("FrechetInceptionDistance D = 2048 (16 updates of 1250 + compute)", fid_ms),
    ]:
        print(f"time {card}: {label}: {ms:.3f} ms (median of 5)", flush=True)
    # The window's two kernels on this run's operands.
    win_auc_dev_ms = device_ms(torch, lambda: auc_from_sorted(win_th, win_hh))
    win_auc_ms = median_ms(lambda: auc_from_sorted(win_th, win_hh))
    win_auc_bound, win_auc_by = bound(win_w * 5 + 4, 3 * win_w)
    rare_dev_ms = device_ms(torch, lambda: rank_sum_counts(rare.inputs, rare_tables, negate=True))
    rare_k_ms = median_ms(lambda: rank_sum_counts(rare.inputs, rare_tables, negate=True))
    rare_bound, rare_by = bound(
        rare_tasks * rare_w * 4 + rare_tables.numel() * 4 + rare_tables.shape[0] * 4,
        2 * rare_tasks * rare_w * rare_cap.bit_length())
    rare_floor = issue_floor_ms(2 * rare_tasks * rare_w, rare_cap)
    print(f"time {card}: auc_from_sorted a windowed compute, (1, 2^20): device "
          f"{win_auc_dev_ms:.4f} ms, events {win_auc_ms:.4f} ms, bound {win_auc_bound:.4f} ms "
          f"({win_auc_by})", flush=True)
    print(f"time {card}: rank_sum_counts a windowed compute, (32, 2^17) queries, cap {rare_cap}: "
          f"device {rare_dev_ms:.4f} ms, events {rare_k_ms:.4f} ms, bound {rare_bound:.4f} ms "
          f"({rare_by}), issue floor {rare_floor:.4f} ms", flush=True)
    ring_buf = win.inputs.clone()
    ring_batch = win_s[:win_batch].view(1, -1)
    ring_ms = device_ms(torch, lambda: _ring_insert(ring_buf, ring_batch, win_w - win_batch // 2))
    ring_bound, _ = bound(2 * win_batch * 4, 0)
    print(f"time {card}: ring insert of 2^16 f32 wrapping past the end of a 2^20 ring (two slice "
          f"copies): device {ring_ms:.4f} ms, bound {ring_bound:.5f} ms (bytes)", flush=True)
    x0, y0 = img_batches[0]
    window = _gaussian_window(3, 11, 1.5, dev)
    conv_ms = device_ms(torch, lambda: torch.nn.functional.conv2d(x0, window, groups=3))
    conv_bound, conv_by = bound(x0.numel() * 4 * 2, 2 * 121 * x0.shape[0] * 3 * 502 * 502)
    ssim_upd_ms = device_ms(torch, lambda: ssim.update(x0, y0), reps=5)
    print(f"time {card}: SSIM's depthwise 11 x 11 conv2d on (16, 3, 512, 512) f32: device "
          f"{conv_ms:.4f} ms a call (5 a update), bound {conv_bound:.4f} ms ({conv_by}); a whole "
          f"SSIM update {ssim_upd_ms:.4f} ms device", flush=True)
    feats0 = net(fid_real[:fid_batch])
    cov0 = fid.real_cov_sum / fid_n
    with full_f32():
        fid_mm_ms = device_ms(torch, lambda: feats0.T @ feats0)
        fid_mm_ev_ms = median_ms(lambda: feats0.T @ feats0)
        fid_mm_split = device_split(torch, lambda: feats0.T @ feats0)
    fid_mm_bound, fid_mm_by = bound((feats0.numel() + fid_dim**2) * 4, 2 * fid_batch * fid_dim**2)
    eigh_ms = median_ms(lambda: torch.linalg.eigh(cov0), reps=5)
    eigvalsh_ms = median_ms(lambda: torch.linalg.eigvalsh(cov0), reps=5)
    eigh_dev_ms = device_ms(torch, lambda: torch.linalg.eigh(cov0), reps=5)
    fid_compute_ms = median_ms(fid.compute, reps=5)
    print(f"time {card}: FID at D = {fid_dim}: feats.T @ feats (1250 x 2048) device "
          f"{fid_mm_ms:.4f} ms (events {fid_mm_ev_ms:.4f} ms; by kernel "
          f"{ {k: round(v, 4) for k, v in fid_mm_split.items()} }), bound {fid_mm_bound:.4f} ms "
          f"({fid_mm_by}); torch.linalg.eigh "
          f"{eigh_ms:.3f} ms (device {eigh_dev_ms:.3f}), eigvalsh {eigvalsh_ms:.3f} ms; "
          f"compute {fid_compute_ms:.3f} ms (events)", flush=True)

    if profile_phase:
        profile_lifecycle(torch, card, "WindowedBinaryAUROC 2^20 lifecycle",
                          lambda: window_lifecycle(win_batches)(win), host_ops=True)
        profile_lifecycle(torch, card, "WindowedBinaryAUROC (16, 2^17) rare positives, rank route",
                          lambda: window_lifecycle(rare_batches)(rare), host_ops=True)
        os.environ["TORCHEVAL_TPU_TORCH_DISABLE_USTAT"] = "1"
        try:
            profile_lifecycle(torch, card, "the same, sort route",
                              lambda: window_lifecycle(rare_batches)(rare), host_ops=True)
        finally:
            del os.environ["TORCHEVAL_TPU_TORCH_DISABLE_USTAT"]
        profile_lifecycle(torch, card, "click-prediction windows (NE + WC collection, CTR, MSE; "
                          "250 updates)", cw_lifecycle, repeats=1, host_ops=True)
        profile_lifecycle(torch, card, "StructuralSimilarity lifecycle",
                          lambda: image_lifecycle(ssim))
        profile_lifecycle(torch, card, "PeakSignalNoiseRatio lifecycle",
                          lambda: image_lifecycle(psnr))
        profile_lifecycle(torch, card, "FrechetInceptionDistance D = 2048 lifecycle",
                          lambda: fid_lifecycle(fid), host_ops=True)
    del img_batches, fid_real, fid_fake, cw_batches

    # --------------- 36. the sharded multiclass ustat at the repository's workload
    from torcheval_tpu_torch.metrics.functional import binary_auprc, binary_auroc, multiclass_auroc
    from torcheval_tpu_torch.parallel import (
        sharded_binary_auprc_exact,
        sharded_binary_auprc_ustat,
        sharded_binary_auroc_exact,
        sharded_binary_auroc_ustat,
        sharded_multiclass_auroc_exact,
        sharded_multiclass_auroc_ustat,
        sharded_multitask_auprc_exact,
        sharded_multitask_auroc_exact,
    )
    from torcheval_tpu_torch.parallel.exact import (
        _pack_class_runs,
        _ring,
        _ustat_kernel_table,
        eager_ustat_pin,
    )

    ex_rng = np.random.default_rng(8)  # benchmarks/workloads.py's bench_sharded_multiclass_exact
    ex_n, ex_c = 2**16, 1000
    ex_s_np = ex_rng.random((ex_n, ex_c), dtype=np.float32)
    ex_t_np = ex_rng.integers(0, ex_c, ex_n).astype(np.int32)
    ex_s, ex_t = torch.from_numpy(ex_s_np).to(dev), torch.from_numpy(ex_t_np).to(dev)

    def mc_ustat(**kw):
        return lambda mesh: sharded_multiclass_auroc_ustat(
            *shard_batch(mesh, ex_s, ex_t), mesh, num_classes=ex_c, **kw)

    ex_label = f"sharded_multiclass_auroc_ustat ({ex_n}, {ex_c}), LocalWorld(4)"
    ex_macro = world_launches(f"{ex_label}, defaults (cap autotuned in the call)", 4, mc_ustat(),
                              {"rank_sum_counts": 4})
    ex_launches = _build.LAUNCHES["rank_sum_counts"]
    ex_pc = world_launches(f"{ex_label}, average=None", 4, mc_ustat(average=None),
                           {"rank_sum_counts": 4})
    check(torch.equal(ex_macro, ex_pc.mean()), "the macro AUROC is the mean of the per-class ones")
    ex_most = max(int(np.bincount(b, minlength=ex_c).max()) for b in np.split(ex_t_np, 4))
    ex_cap, ex_kernel = eager_ustat_pin(ex_s, ex_t, ex_c, 4)
    check((ex_cap, ex_kernel, ex_most) == (64, "pallas", 31),
          f"eager_ustat_pin: cap {ex_cap}, kernel {ex_kernel!r} (a block's largest class "
          f"count {ex_most})")
    pinned = world_launches(f"{ex_label}, pinned by eager_ustat_pin", 4,
                            mc_ustat(average=None, max_class_count_per_shard=ex_cap,
                                     _kernel=ex_kernel), {"rank_sum_counts": 4})
    check(torch.equal(pinned, ex_pc), "pinned: bit-equal to the autotuned call, every class")
    ring_pc = world_launches(f"{ex_label}, comm='ring'", 4, mc_ustat(average=None, comm="ring"),
                             {"rank_sum_counts": 16})
    check(torch.equal(ring_pc, ex_pc), "ring: bit-equal to the gather, every class")
    one_pc = world_launches("the same on LocalWorld(1), the whole array", 1,
                            mc_ustat(average=None), {"rank_sum_counts": 1})
    check(torch.equal(one_pc, ex_pc),
          "LocalWorld(4) bit-equal to LocalWorld(1) on the whole array, every class")
    t0 = time.perf_counter()
    ex_want = np.array([oracle_auc(ex_s_np[:, k], ex_t_np == k) for k in range(ex_c)])
    ex_err = float(np.abs(ex_pc.cpu().numpy().astype(np.float64) - ex_want).max())
    check(ex_err <= TOL, f"{ex_label}: all {ex_c} classes vs float64 Mann-Whitney, max err "
          f"{ex_err:.3e} ({time.perf_counter() - t0:.1f} s of oracle on the host)")
    os.environ["TORCHEVAL_TPU_TORCH_DISABLE_USTAT"] = "1"
    try:
        ss_pc = world_launches(f"{ex_label}, TORCHEVAL_TPU_TORCH_DISABLE_USTAT=1 (searchsorted)",
                               4, mc_ustat(average=None), {})
    finally:
        del os.environ["TORCHEVAL_TPU_TORCH_DISABLE_USTAT"]
    ss_gap = float((ss_pc - ex_pc).abs().max())
    check(ss_gap <= TOL, f"searchsorted within {ss_gap:.3e} of the rank-sum kernel, every class")
    # rank_sum.cu on rank 1's own operands: its (1000, 16384) strided block
    # against the gathered table and against a ring chunk.
    ex_blocks = [(ex_s[r * ex_n // 4:(r + 1) * ex_n // 4], ex_t[r * ex_n // 4:(r + 1) * ex_n // 4])
                 for r in range(4)]
    ex_packs = [_pack_class_runs(s, t, ex_c, ex_cap) for s, t in ex_blocks]
    ex_q = ex_blocks[1][0].T
    ex_tables = {}
    ex_rank_err = 0
    for label, rows in [("the gathered table", _ustat_kernel_table(torch.cat(ex_packs, dim=1))),
                        ("a ring chunk", _ustat_kernel_table(ex_packs[0]))]:
        tabs = torch.cat([rows, -rows.flip(-1)])
        got = rank_sum_counts(ex_q, tabs, negate=True)
        torch.cuda.synchronize()
        plain = _rank_sum_counts_plain(ex_q, tabs, negate=True)
        ex_rank_err = max(ex_rank_err, int((got - plain).abs().max()))
        check(torch.equal(got, plain),
              f"rank_sum_counts bit-equal to plain on rank 1's {tuple(ex_q.shape)} strided block "
              f"against {label} {tuple(tabs.shape)} "
              f"[{rank_sum_plan(ex_q, tabs, negate=True).describe()}]")
        ex_tables[label] = tabs
    del ex_packs, ss_pc, one_pc, pinned

    # ------------------------------------ 37. gather-exact at the same data
    exact_pc = world_launches(
        f"sharded_multiclass_auroc_exact ({ex_n}, {ex_c}), LocalWorld(4), average=None", 4,
        lambda m: sharded_multiclass_auroc_exact(*shard_batch(m, ex_s, ex_t), m,
                                                 num_classes=ex_c, average=None),
        {"rank_sum_counts": 4})
    _build.reset_counts()
    whole_pc = multiclass_auroc(ex_s, ex_t, num_classes=ex_c, average=None)
    torch.cuda.synchronize()
    check(dict(_build.LAUNCHES) == {"rank_sum_counts": 1} and torch.equal(exact_pc, whole_pc),
          "sharded_multiclass_auroc_exact bit-equal to multiclass_auroc on the whole array (one "
          f"rank_sum_counts launch, cap {ustat_route_cap(ex_s, ex_t, ex_c)})")
    check(torch.equal(exact_pc, ex_pc), "gather-exact bit-equal to the ustat, every class (the "
          "same integer U, the same f32 cast and division)")
    del whole_pc

    def exact_call(fn, s, t, dim=0):
        return lambda m: fn(*shard_batch(m, s, t, dim=dim), m)

    br_t_np = np.zeros(bs_n, np.float32)  # phase 28's scores, 48 positives: a rare variant
    br_t_np[np.random.default_rng(38).choice(bs_n, 48, replace=False)] = 1
    br_t = torch.from_numpy(br_t_np).to(dev)
    bx = {}
    call_launches = {}  # each gather-exact call's launches, for the kernels line
    for label, t_dev, routes in [
        ("phase 28's 2^22 balanced", bs_t, ({"auc_from_sorted": 4}, {})),
        ("phase 28's scores, 48 positives", br_t,
         ({"rank_sum_counts": 4}, {"rank_hist_counts": 4})),
    ]:
        for fn, whole_fn, want in [(sharded_binary_auroc_exact, binary_auroc, routes[0]),
                                   (sharded_binary_auprc_exact, binary_auprc, routes[1])]:
            got = world_launches(f"{fn.__name__} on {label}, LocalWorld(4)", 4,
                                 exact_call(fn, bs_s, t_dev), want)
            call_launches[fn.__name__, label] = dict(_build.LAUNCHES)
            check(torch.equal(got, whole_fn(bs_s, t_dev)),
                  f"{fn.__name__} on {label}: bit-equal to {whole_fn.__name__} on the whole")
            bx[fn.__name__, label] = got
    mt_rng = np.random.default_rng(17)  # phase 31's shape: 16 tasks, positives at 1/512
    mt_s = torch.from_numpy(mt_rng.random((16, 2**17), dtype=np.float32)).to(dev)
    mt_t = torch.from_numpy((mt_rng.random((16, 2**17)) < 1 / 512).astype(np.float32)).to(dev)
    for fn, whole_fn, want in [(sharded_multitask_auroc_exact, binary_auroc, "rank_sum_counts"),
                               (sharded_multitask_auprc_exact, binary_auprc, "rank_hist_counts")]:
        got = world_launches(f"{fn.__name__} (16, 2^17), positives 1/512, LocalWorld(4)", 4,
                             exact_call(fn, mt_s, mt_t, dim=1), {want: 4})
        call_launches[fn.__name__, "multitask"] = dict(_build.LAUNCHES)
        check(torch.equal(got, whole_fn(mt_s, mt_t, num_tasks=16)),
              f"{fn.__name__}: bit-equal to {whole_fn.__name__}(num_tasks=16) on the whole")

    # ------------------------------- 38. the binary ustat at phase 28's data
    for label, t_dev, t_np, cap in [("phase 28's 2^22 balanced", bs_t, bs_t_np, None),
                                    ("phase 28's scores, 48 positives", br_t, br_t_np, 64)]:
        hits = t_np == 1
        want_auc = oracle_auc(bs_s_np, hits)
        want_ap = float(oracle_ap(np.stack([bs_s_np, bs_s_np], 1), hits.astype(np.int64), 2)[1])
        out = {}
        for fn, kw in [(sharded_binary_auroc_ustat, "max_minority_count_per_shard"),
                       (sharded_binary_auprc_ustat, "max_positive_count_per_shard")]:
            for comm in ("gather", "ring"):
                out[fn, comm] = world_launches(
                    f"{fn.__name__} on {label}, {kw}={cap}, comm={comm!r}", 4,
                    lambda m: fn(*shard_batch(m, bs_s, t_dev), m, comm=comm, **{kw: cap}), {})
        auc_g, auc_r = (out[sharded_binary_auroc_ustat, comm] for comm in ("gather", "ring"))
        ap_g, ap_r = (out[sharded_binary_auprc_ustat, comm] for comm in ("gather", "ring"))
        exact_auc = float(bx["sharded_binary_auroc_exact", label])
        exact_ap = float(bx["sharded_binary_auprc_exact", label])
        errs = [abs(float(auc_g) - exact_auc), abs(float(auc_g) - want_auc),
                abs(float(ap_g) - exact_ap), abs(float(ap_g) - want_ap),
                abs(float(ap_r) - float(ap_g))]
        check(torch.equal(auc_g, auc_r) and max(errs) <= TOL,
              f"binary ustat on {label}: AUROC {float(auc_g)!r} (ring bit-equal), within "
              f"{errs[0]:.3e} of gather-exact and {errs[1]:.3e} of float64; AP {float(ap_g)!r} "
              f"within {errs[2]:.3e} / {errs[3]:.3e}, ring within {errs[4]:.3e}")
    per_block = br_t_np.reshape(4, -1).sum(1).astype(int).tolist()
    tight = max(per_block) - 1

    def overflow(group, rank):
        mesh = make_mesh(group=group)
        try:
            sharded_binary_auroc_ustat(*shard_batch(mesh, bs_s, br_t), mesh,
                                       max_minority_count_per_shard=tight)
        except ValueError as e:  # each rank's own error is the result checked below
            return str(e)
        return None

    msgs = LocalWorld(4).run(overflow)
    check(all(isinstance(m, str) for m in msgs) and len(set(msgs)) == 1
          and "minority-class samples" in msgs[0],
          f"max_minority_count_per_shard={tight} (blocks hold {per_block} positives): the same "
          f"ValueError on every rank: {msgs[0]!r}")

    # ------------------------------------------------ 39. times of phases 36-38
    # Each call's collectives alone, in the shapes parallel/exact.py sends:
    # the stats all-reduce (bounds, the block's shape row, sums, maxes and
    # the ring's tag), the packs, the sums.
    shape_row = torch.zeros(1, 10, dtype=torch.int64)
    ex_stats = [torch.zeros(1, dtype=torch.float64), torch.zeros(1, dtype=torch.float64),
                shape_row, torch.zeros(ex_c, dtype=torch.int64),
                torch.zeros(2, dtype=torch.int64)]
    stat_ops = ["min", "max", "concat", "sum", "max"]
    ex_k = torch.zeros(2 * ex_c, dtype=torch.int32, device=dev)
    ex_chunk = torch.zeros(ex_c, ex_cap, device=dev)

    def mc_gather_collectives(m):
        m.all_reduce_many(ex_stats, stat_ops, "dp")
        m.all_reduce_many([ex_chunk.T], ["concat"], "dp")
        return m.all_reduce_many([ex_k], ["sum"], "dp")

    def mc_ring_collectives(m):
        m.all_reduce_many(ex_stats, stat_ops, "dp")
        _ring(m, "time", (ex_chunk,), lambda p: p)
        return m.all_reduce_many([ex_k], ["sum"], "dp")

    def exact_collective(s, t, dim=0):
        return lambda m: m.group.all_gather_object([shape_row, *shard_batch(m, s, t, dim=dim)])

    def ustat_collectives(run_len):
        run = torch.zeros(run_len, device=dev)
        u = torch.zeros((), device=dev)
        return lambda m: (m.all_reduce_many(ex_stats[:3] + [torch.zeros(1, dtype=torch.int64),
                                                             torch.zeros(3, dtype=torch.int64)],
                                            stat_ops, "dp"),
                          m.all_reduce_many([run], ["concat"], "dp"),
                          m.all_reduce_many([u], ["sum"], "dp"))

    for label, fn, alone, reps in [
        (f"{ex_label}, defaults (gather)", mc_ustat(), mc_gather_collectives, 5),
        (f"{ex_label}, comm='ring'", mc_ustat(comm="ring"), mc_ring_collectives, 5),
        (f"sharded_multiclass_auroc_exact ({ex_n}, {ex_c}) (3 calls: 4 x 65.5 MB pickled a call)",
         lambda m: sharded_multiclass_auroc_exact(*shard_batch(m, ex_s, ex_t), m, num_classes=ex_c),
         exact_collective(ex_s, ex_t), 3),
        ("sharded_binary_auroc_exact 2^22 balanced",
         exact_call(sharded_binary_auroc_exact, bs_s, bs_t), exact_collective(bs_s, bs_t), 5),
        ("sharded_binary_auroc_ustat 2^22 balanced (whole blocks)",
         lambda m: sharded_binary_auroc_ustat(*shard_batch(m, bs_s, bs_t), m),
         ustat_collectives(bs_n // 4), 5),
        ("sharded_binary_auroc_ustat 48 positives, cap 64",
         lambda m: sharded_binary_auroc_ustat(*shard_batch(m, bs_s, br_t), m,
                                              max_minority_count_per_shard=64),
         ustat_collectives(64), 5),
        ("sharded_binary_auprc_ustat 48 positives, cap 64",
         lambda m: sharded_binary_auprc_ustat(*shard_batch(m, bs_s, br_t), m,
                                              max_positive_count_per_shard=64),
         ustat_collectives(64), 5),
    ]:
        call_ms = host_median_ms(
            lambda: LocalWorld(4).run(lambda g, r: fn(make_mesh(group=g))), reps)
        coll_ms = host_median_ms(
            lambda: LocalWorld(4).run(lambda g, r: alone(make_mesh(group=g))), reps)
        print(f"time {card}: {label}, LocalWorld(4) on one card, wall clock of the call (median "
              f"of {reps}): {call_ms:.3f} ms; its collectives alone (pickled through the CPU) "
              f"{coll_ms:.3f} ms, {100 * coll_ms / call_ms:.0f} % of the call", flush=True)
    ex_dev = {}
    for label, tabs in ex_tables.items():
        cap_t = tabs.shape[1]
        dev_t = device_ms(torch, lambda: rank_sum_counts(ex_q, tabs, negate=True))
        ev_t = median_ms(lambda: rank_sum_counts(ex_q, tabs, negate=True))
        searches = 2 * ex_q.numel()
        bnd, by = bound(ex_q.numel() * 4 + tabs.numel() * 4 + tabs.shape[0] * 4,
                        searches * int(np.log2(cap_t)))
        print(f"time {card}: rank_sum_counts a rank, {tuple(ex_q.shape)} strided queries against "
              f"{label} {tuple(tabs.shape)}: device {dev_t:.4f} ms, events {ev_t:.4f} ms, bound "
              f"{bnd:.4f} ms ({by}), issue floor {issue_floor_ms(searches, cap_t):.4f} ms",
              flush=True)
        ex_dev[label] = dev_t
    ex_dev_ms = ex_dev["the gathered table"]
    # The rank kernels at the operands the gathered wholes of phase 37 give
    # them (the single-device routes), held against their plain versions:
    # first the multiclass whole, each rank's (1000, 65536) strided queries
    # against the whole's own table at its route's cap.
    whole_cap = ustat_route_cap(ex_s, ex_t, ex_c)
    _, whole_tab = _pack_positive_tables(ex_s, ex_t, ex_c, whole_cap)
    whole_tabs = torch.cat([whole_tab, -whole_tab.flip(1)])
    whole_q = ex_s.T
    got = rank_sum_counts(whole_q, whole_tabs, negate=True)
    torch.cuda.synchronize()
    plain = _rank_sum_counts_plain(whole_q, whole_tabs, negate=True)
    ex_rank_err = max(ex_rank_err, int((got - plain).abs().max()))
    check(torch.equal(got, plain),
          f"rank_sum_counts bit-equal to plain on the multiclass whole: {tuple(whole_q.shape)} "
          f"strided queries against {tuple(whole_tabs.shape)}, cap {whole_cap} "
          f"[{rank_sum_plan(whole_q, whole_tabs, negate=True).describe()}]")
    searches = 2 * whole_q.numel()
    bnd, by = bound(whole_q.numel() * 4 + whole_tabs.numel() * 4 + got.numel() * 4,
                    searches * int(np.log2(whole_cap)))
    print(f"time {card}: rank_sum_counts on the multiclass whole, cap {whole_cap}: device "
          f"{device_ms(torch, lambda: rank_sum_counts(whole_q, whole_tabs, negate=True)):.4f} "
          f"ms, bound {bnd:.4f} ms ({by}), issue floor "
          f"{issue_floor_ms(searches, whole_cap):.4f} ms", flush=True)
    del whole_tab, whole_tabs, got, plain
    mt_hist_dev_ms = None
    for label, rows, hits in [("the 48-positive 2^22 whole", bs_s[None], (br_t == 1)[None]),
                              ("the multitask whole", mt_s, mt_t == 1)]:
        _, cap_r = binary_ustat_route(rows, hits.to(torch.int32), need_pos=True)
        _, tab = _pack_row_tables(rows, hits, cap_r)
        tabs = torch.cat([tab, -tab.flip(1)])
        for name, call, plain_call, searches, extra in [
            ("rank_sum_counts", lambda: rank_sum_counts(rows, tabs, negate=True),
             lambda: _rank_sum_counts_plain(rows, tabs, negate=True), 2 * rows.numel(), 0),
            ("rank_hist_counts", lambda: rank_hist_counts(rows, tab),
             lambda: _rank_hist_counts_plain(rows, tab), rows.numel(), 2),
        ]:
            got = call()
            torch.cuda.synchronize()
            check(torch.equal(got, plain_call()),
                  f"{name} bit-equal to plain on {label} {tuple(rows.shape)}, cap {cap_r}")
            dev_t = device_ms(torch, call)
            bnd, by = bound(rows.numel() * 4 + tabs.numel() * 4 + got.numel() * 4,
                            searches * int(np.log2(cap_r)))
            print(f"time {card}: {name} on {label} {tuple(rows.shape)}, cap {cap_r}: device "
                  f"{dev_t:.4f} ms, bound {bnd:.4f} ms ({by}), issue floor "
                  f"{issue_floor_ms(searches, cap_r, extra):.4f} ms", flush=True)
            if name == "rank_hist_counts" and label == "the multitask whole":
                mt_hist_dev_ms = dev_t
    if profile_phase:
        profile_lifecycle(torch, card, f"{ex_label}, defaults",
                          lambda: LocalWorld(4).run(lambda g, r: mc_ustat()(make_mesh(group=g))),
                          host_ops=True)
    del ex_s, ex_t, ex_blocks, ex_q, ex_tables, mt_s, mt_t, whole_q

    # ------------------------------- 40. data health on the collection lifecycle
    import io
    import shutil
    import tempfile
    import threading

    from torcheval_tpu_torch.convert import state_from_jax
    from torcheval_tpu_torch.distributed import SingleProcessGroup
    from torcheval_tpu_torch.metrics.functional.classification.confusion_matrix import (
        _confusion_matrix_update,
    )
    from torcheval_tpu_torch.resilience import (
        CheckpointManager,
        CollectiveTimeoutError,
        FaultPlan,
        InjectedFault,
        ResilientGroup,
        RetryPolicy,
        faults,
    )
    from torcheval_tpu_torch.telemetry import events as bus
    from torcheval_tpu_torch.telemetry import export as bus_export
    from torcheval_tpu_torch.telemetry import flightrec, health
    from torcheval_tpu_torch.telemetry import trace as bus_trace

    def states_equal(a, b):
        sa, sb = a.state_dict(), b.state_dict()
        return sa.keys() == sb.keys() and all(
            sa[k].dtype == sb[k].dtype and torch.equal(sa[k], sb[k]) for k in sa)

    def health_on(fn, raise_on_corrupt=False):
        health.enable(raise_on_corrupt=raise_on_corrupt)
        try:
            return fn()
        finally:
            health.disable()
            health.RAISE_ON_CORRUPT = False

    def turns_ms(fns, reps=5):
        """Host wall clock (ending in a device sync) of each of ``fns``, run
        in turns, the order reversed every round (a b, b a, ...), after one
        warm-up call each: the per-function lists in ms."""
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        out = [[] for _ in fns]
        for i in range(reps):
            order = list(range(len(fns)))
            for j in (order if i % 2 == 0 else order[::-1]):
                t0 = time.perf_counter()
                fns[j]()
                torch.cuda.synchronize()
                out[j].append((time.perf_counter() - t0) * 1e3)
        return out

    def spread(ms):
        return f"{statistics.median(ms):.3f} ms ({min(ms):.3f}-{max(ms):.3f})"

    reads = []
    real_to_host = health._to_host

    def counting_to_host(t):
        reads.append(1)
        return real_to_host(t)

    col_ref = MetricCollection(five(COL_CLASSES))
    ref_out = fused_lifecycle(col_ref)
    col_health = MetricCollection(five(COL_CLASSES))
    bus.clear()
    health._to_host = counting_to_host
    try:
        health_out, health_launches = health_on(lambda: counted(
            "collection lifecycle (fused_update x 8) with the data-health monitor on",
            fused_lifecycle, col_health, "mega_counts", times=NUM_UPDATES))
    finally:
        health._to_host = real_to_host
    check(states_equal(col_health, col_ref)
          and all(torch.equal(health_out[k], ref_out[k]) for k in ref_out),
          "monitor on: every state and figure bit-equal to the monitor off")
    check(len(reads) == NUM_UPDATES and bus.events("data_health") == [],
          f"monitor on: {len(reads)} read backs for {NUM_UPDATES} updates, no finding on "
          "clean data")
    bad_rng = np.random.default_rng(40)
    bad_x, bad_y = faults.corrupt_batch((col_x[0], col_y[0]))
    bad_y = bad_y.clone()
    bad_rows = bad_rng.choice(bad_y.numel(), 5, replace=False)
    bad_y[torch.from_numpy(bad_rows[:3]).to(dev)] = COL_CLASSES
    bad_y[torch.from_numpy(bad_rows[3:]).to(dev)] = -1
    check(int(col_x[0].isnan().sum()) == 0 and bad_x.device == col_x[0].device,
          "corrupt_batch: a clone on the card, the caller's batch left as it was")
    bad_x_np, bad_y_np = bad_x.cpu().numpy(), bad_y.cpu().numpy()
    want_findings = sorted(
        [("nan", "", int(np.isnan(bad_x_np).sum())),
         ("label_range", "", int((bad_y_np < 0).sum()))]
        + [("label_range", name, int((bad_y_np >= COL_CLASSES).sum())) for name in col_ref])
    col_bad = MetricCollection(five(COL_CLASSES))
    bus.clear()
    _build.reset_counts()
    health_on(lambda: col_bad.fused_update(bad_x, bad_y))
    torch.cuda.synchronize()
    got_findings = sorted((e.check, e.metric, e.count) for e in bus.events("data_health"))
    check(got_findings == want_findings and dict(_build.LAUNCHES) == {"mega_counts": 1},
          f"a corrupt batch: findings {got_findings} equal numpy's, one DataHealthEvent each, "
          "one mega launch")
    col_raise = MetricCollection(five(COL_CLASSES))
    try:
        health_on(lambda: col_raise.fused_update(bad_x, bad_y), raise_on_corrupt=True)
        fail("raise_on_corrupt=True did not raise on the corrupt batch")
    except health.DataCorruptionError as exc:
        raised = str(exc)
    check(states_equal(col_raise, col_bad),
          f"raise_on_corrupt: DataCorruptionError ({raised[:60]}...) after the batch was "
          "applied, states equal to the un-raised run's")
    bus.clear()
    health_off, health_on_times = turns_ms(
        [lambda: fused_lifecycle(col_ref), lambda: health_on(lambda: fused_lifecycle(col_health))])
    print(f"times {card}: collection lifecycle (fused_update x {NUM_UPDATES}, {COL_SAMPLES} x "
          f"{COL_CLASSES}), 5 turns each, median (min-max): health off {spread(health_off)}, "
          f"on {spread(health_on_times)} ({NUM_UPDATES} read backs, one a update)", flush=True)
    if profile_phase:
        for label, fn in (("collection lifecycle, health off", lambda: fused_lifecycle(col_ref)),
                          ("collection lifecycle, health on",
                           lambda: health_on(lambda: fused_lifecycle(col_health)))):
            profile_lifecycle(torch, card, label, fn, host_ops=True)
    del col_health, col_bad, col_raise, bad_x, bad_y

    # ------------------------------------- 41. checkpoint and resume on the card
    ck_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        mgr = CheckpointManager(ck_dir)
        first = MetricCollection(five(COL_CLASSES))
        for x, y in zip(col_x[:4], col_y[:4]):
            first.fused_update(x, y)
        ck_path = mgr.save(first.state_dict(), {"batches_seen": 4})
        ckpt = mgr.load_latest()
        check(ckpt.generation == 0 and ckpt.cursor == {"batches_seen": 4}
              and all(isinstance(v, np.ndarray) for v in ckpt.state.values()),
              f"checkpoint: generation 0, cursor 4, {ckpt.nbytes} bytes of host numpy")
        resumed = MetricCollection(five(COL_CLASSES))
        resumed.load_state_dict(state_from_jax(ckpt.state))
        _build.reset_counts()
        for x, y in zip(col_x[4:], col_y[4:]):
            resumed.fused_update(x, y)
        resumed_out = resumed.compute()
        torch.cuda.synchronize()
        ckpt_launches = _build.LAUNCHES["mega_counts"]
        check(dict(_build.LAUNCHES) == {"mega_counts": NUM_UPDATES - 4} and not _build.PLAIN_CALLS,
              f"resumed on the card: {ckpt_launches} mega launches after the restore")
        check(states_equal(resumed, col_ref)
              and all(torch.equal(resumed_out[k], ref_out[k]) for k in ref_out),
              "resumed lifecycle bit-equal to the uninterrupted one, every state and figure")
        bus.clear()
        bus.enable()
        with FaultPlan([{"site": "checkpoint.write", "action": "tear", "offset": 100}]):
            try:
                mgr.save(resumed.state_dict(), {"batches_seen": NUM_UPDATES})
                fail("a tear rule on checkpoint.write did not raise")
            except InjectedFault:
                pass
        torn = mgr.load_latest()
        bus.disable()
        quarantined = [(e.action, e.generation) for e in bus.events("checkpoint")]
        check(torn.generation == 0 and torn.cursor == {"batches_seen": 4}
              and quarantined == [("quarantine", 1), ("restore", 0)],
              f"a torn generation 1 is quarantined and generation 0 loads: events {quarantined}")
        bus.clear()
        ck_bytes = os.path.getsize(ck_path)
        state_bytes = sum(v.numel() * v.element_size() for v in first.state_dict().values())
        save_ms = host_median_ms(lambda: mgr.save(first.state_dict(), {"batches_seen": 4}))
        load_ms = host_median_ms(lambda: mgr.load_latest())
        restore_ms = host_median_ms(
            lambda: resumed.load_state_dict(state_from_jax(mgr.load_latest().state)))
        print(f"times {card}: checkpoint of the collection ({state_bytes} state bytes on the "
              f"card, {ck_bytes} bytes on disk): save {save_ms:.3f} ms, load {load_ms:.3f} ms, "
              f"load and restore to the card {restore_ms:.3f} ms", flush=True)
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    del first, resumed, col_ref

    # ------------------------------------ 42. retried collectives around kernels
    policy = RetryPolicy(max_attempts=3, base_delay=0.001, jitter=0.0)

    def cm_steps(retry):
        def fn(g, r):
            mesh = make_mesh(group=g)
            step = make_synced_update(
                lambda a, b: _confusion_matrix_update(a, b, CM_CLASSES), mesh, retry=retry)
            total = None
            for p, t in zip(p_chunks, y_chunks):
                out = step(*shard_batch(mesh, p, t))
                total = out if total is None else total + out
            return total

        out = LocalWorld(4).run(fn)
        torch.cuda.synchronize()
        if not all(torch.equal(o, out[0]) for o in out[1:]):
            fail("the ranks of LocalWorld(4) hold different bits")
        return out[0]

    def faulted_cm():
        with FaultPlan([{"site": "sync.dispatch", "count": 1}]):
            return cm_steps(policy)

    _build.reset_counts()
    cm_clean = cm_steps(policy)
    clean_cm_launches = dict(_build.LAUNCHES)
    bus.clear()
    bus.enable()
    _build.reset_counts()
    cm_retried = faulted_cm()
    cm_retry_launches = _build.LAUNCHES["confusion_slab"]
    bus.disable()
    retries = bus.events("retry")
    check(clean_cm_launches == {"confusion_slab": 4 * NUM_UPDATES}
          and dict(_build.LAUNCHES) == {"confusion_slab": 4 * NUM_UPDATES + 1}
          and not _build.PLAIN_CALLS and len(retries) == 1,
          f"make_synced_update(retry=) over LocalWorld(4), {NUM_UPDATES} steps: "
          f"{cm_retry_launches} slab launches (4 a step and the failed rank's retry), "
          f"one RetryEvent ({retries[0].error[:40] if retries else None})")
    check(torch.equal(cm_retried, cm_clean) and np.array_equal(cm_retried.cpu().numpy(), cm_oracle),
          "the retried matrix bit-equal to the fault-free call and to phase 8's np.add.at oracle")
    bus.clear()

    ex_s, ex_t = torch.from_numpy(ex_s_np).to(dev), torch.from_numpy(ex_t_np).to(dev)

    def ustat_world(wrap):
        def fn(g, r):
            mesh = make_mesh(group=ResilientGroup(g, policy) if wrap else g)
            return sharded_multiclass_auroc_ustat(
                *shard_batch(mesh, ex_s, ex_t), mesh, num_classes=ex_c, average=None)

        out = LocalWorld(4).run(fn)
        torch.cuda.synchronize()
        if not all(torch.equal(o, out[0]) for o in out[1:]):
            fail("the ranks of LocalWorld(4) hold different bits")
        return out[0]

    def faulted_ustat():
        with FaultPlan([{"site": "collective", "on_attempt": 1, "count": 4}]) as plan:
            out = ustat_world(True)
        if len(plan.fired) != 4:
            fail(f"the collective rule fired {len(plan.fired)} times, not once a rank")
        return out

    _build.reset_counts()
    ustat_retried = faulted_ustat()
    ustat_retry_launches = _build.LAUNCHES["rank_sum_counts"]
    check(dict(_build.LAUNCHES) == {"rank_sum_counts": 4} and not _build.PLAIN_CALLS
          and torch.equal(ustat_retried, ex_pc),
          f"{ex_label} over ResilientGroup ranks, every rank's first attempt failing: "
          f"phase 36's bits, {ustat_retry_launches} rank_sum_counts launches")

    deadline = 1.0
    lonely = LocalWorld(4)
    timeouts = {}

    def lonely_rank(r):
        rg = ResilientGroup(lonely.group(r), RetryPolicy(max_attempts=3, base_delay=0.001,
                                                         deadline=deadline))
        t0 = time.perf_counter()
        try:
            rg.all_reduce(torch.ones(4, device=dev))
        except CollectiveTimeoutError:
            timeouts[r] = time.perf_counter() - t0

    threads = [threading.Thread(target=lonely_rank, args=(r,), daemon=True) for r in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(deadline + 10)
    lonely._barrier.abort()  # frees the abandoned attempts' threads
    check(sorted(timeouts) == [0, 1, 2] and max(timeouts.values()) < deadline + 2,
          f"a rank that never joins: CollectiveTimeoutError on the other three within "
          f"{max(timeouts.values(), default=float('nan')):.3f} s (deadline {deadline} s)")

    cm_plain, cm_clean_t, cm_retried_t = turns_ms(
        [lambda: cm_steps(None), lambda: cm_steps(policy), faulted_cm])
    print(f"times {card}: make_synced_update CM ({NUM_UPDATES} steps of 2^17 pairs, C = "
          f"{CM_CLASSES}, LocalWorld(4)), 5 turns each, median (min-max): no retry "
          f"{spread(cm_plain)}, retry fault-free {spread(cm_clean_t)}, one rank's attempt failed "
          f"{spread(cm_retried_t)}", flush=True)
    us_plain, us_wrapped, us_retried = turns_ms(
        [lambda: ustat_world(False), lambda: ustat_world(True), faulted_ustat])
    print(f"times {card}: {ex_label}, 5 turns each, median (min-max): plain group "
          f"{spread(us_plain)}, ResilientGroup fault-free {spread(us_wrapped)}, every rank's "
          f"first attempt failed {spread(us_retried)}", flush=True)
    del ex_s, ex_t, cm_clean, cm_retried

    # -------------------------- 43. the bus and the flight recorder on the headline
    fr_dir = tempfile.mkdtemp(prefix="chip_smoke_flightrec_")
    try:
        bus.clear()
        bus.enable()
        bus_trace.enable()
        flightrec.enable(dir=fr_dir, cooldown_s=0)
        with bus_trace.activate(bus_trace.root("headline")):
            bus_out, bus_launches = counted(
                "headline MulticlassAUROC with the bus, tracing and the flight recorder on",
                headline_lifecycle, headline, "rank_sum_counts")
        check(torch.equal(bus_out, per_class), "bus on: the headline's AUROC bits unchanged")
        evs = bus.events()
        spans = bus.events("span")
        check([(e.name, e.phase) for e in spans if e.name == "MulticlassAUROC"]
              == [("MulticlassAUROC", "update")] * NUM_UPDATES + [("MulticlassAUROC", "compute")]
              and all(e.trace_id for e in evs),
              f"{len(evs)} events: {NUM_UPDATES} update spans and a compute span, every event "
              "traced")
        buf = io.StringIO()
        bus_export.export_jsonl(buf)
        buf.seek(0)
        check(bus_export.read_jsonl(buf, strict=True) == evs,
              "export_jsonl -> read_jsonl gives the same events")
        perfetto = json.loads(json.dumps(bus_export.to_perfetto(evs)))
        slices = [e for e in perfetto["traceEvents"] if e["ph"] == "X"]
        check(len(slices) == len([e for e in evs if e.kind in ("span", "sync", "checkpoint")]),
              f"to_perfetto: valid JSON, {len(slices)} slices, one a timed event")
        prom = bus_export.prometheus_text()
        for line in prom.splitlines():
            if not line.startswith("#"):
                float(line.rsplit(" ", 1)[1])
        check("torcheval_tpu_span_seconds_count" in prom,
              f"prometheus_text: {len(prom.splitlines())} lines, each parses")
        with FaultPlan([{"site": "collective", "on_attempt": 1}]):
            ResilientGroup(SingleProcessGroup(), policy).all_gather_object("probe")
        bundle = flightrec.last_bundle()
        problems = flightrec.validate_bundle(bundle) if bundle else ["no bundle"]
        check(not problems, f"a fired fault wrote a bundle that validates: "
                            f"{os.path.basename(bundle or '')}")
        bus.disable()
        bus_trace.disable()
        flightrec.disable()
        bus.clear()
        flightrec.reset()
        def bus_on_lifecycle():
            bus.enable()
            bus_trace.enable()
            flightrec.enable(dir=fr_dir)
            try:
                with bus_trace.activate(bus_trace.root("headline")):
                    return headline_lifecycle(headline)
            finally:
                bus.disable()
                bus_trace.disable()
                flightrec.disable()

        bus_off, bus_on_times = turns_ms(
            [lambda: headline_lifecycle(headline), bus_on_lifecycle])
        print(f"times {card}: headline lifecycle, 5 turns each, median (min-max): bus off "
              f"{spread(bus_off)}, bus + trace + flight recorder on {spread(bus_on_times)}",
              flush=True)
        if profile_phase:
            profile_lifecycle(torch, card, "headline lifecycle, bus + trace + flight recorder on",
                              bus_on_lifecycle, host_ops=True)
        # The spans by name beside the kernels, under the profiler.
        from torch.profiler import ProfilerActivity, profile

        bus.enable(annotate=True)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            headline_lifecycle(headline)
            torch.cuda.synchronize()
        bus.enable(annotate=False)
        bus.disable()
        bus.clear()
        named = sorted({e.key for e in prof.key_averages()
                        if e.key.startswith("torcheval_tpu_torch.")})
        kernel_rows = [(e.key, device_us(e)) for e in device_events(torch, prof)
                       if "rank_sum" in e.key]
        check(named == ["torcheval_tpu_torch.MulticlassAUROC.compute",
                        "torcheval_tpu_torch.MulticlassAUROC.update"],
              f"annotate: the spans by name in the profiler trace {named}, beside "
              f"{[(k[:40], round(us, 1)) for k, us in kernel_rows]}")
    finally:
        shutil.rmtree(fr_dir, ignore_errors=True)
        bus.disable()
        bus_trace.disable()
        flightrec.disable()

    # ------------------------------------------------------ the kernels line
    kernels = [
        {
            "name": "rank_sum_counts",
            "route": "cuda",
            "source": "torcheval_tpu_torch/ops/csrc/rank_sum.cu",
            "replaces": "torcheval_tpu/ops/pallas_ustat.py:176",
            "launches": headline_launches,
            "max_abs_err": max(rank_err, ex_rank_err),
            "ms": rank_ms,
            "plain_ms": rank_plain_ms,
            "bound_ms": rank_bound,
            "bound_by": rank_by,
            "library_ms": rank_lib_ms,
            "window_launches": rare_launches,
            "window_device_ms": rare_dev_ms,
            "sharded_launches": ex_launches,
            "sharded_device_ms": ex_dev_ms,
            "retry_launches": ustat_retry_launches,
            "bus_launches": bus_launches,
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
            "device_ms": auc_dev_ms,
            "one_row_ms": auc22_ms,
            "one_row_device_ms": auc22_dev_ms,
            "one_row_launches": binary_launches,
            "window_launches": win_launches,
            "window_device_ms": win_auc_dev_ms,
            "sharded_launches": call_launches[
                "sharded_binary_auroc_exact", "phase 28's 2^22 balanced"]["auc_from_sorted"],
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
            "retry_launches": cm_retry_launches,
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
            "sharded_launches": call_launches[
                "sharded_multitask_auprc_exact", "multitask"]["rank_hist_counts"],
            "sharded_device_ms": mt_hist_dev_ms,
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
            "sliced_ms": sl_mega_ms,
            "sliced_launches": sliced_launches,
            "health_launches": health_launches,
            "checkpoint_launches": ckpt_launches,
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
