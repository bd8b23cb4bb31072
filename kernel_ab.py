"""Time the port's redesigned kernels against another checkout's, in
turns, on one NVIDIA GPU.

    python3 kernel_ab.py --other DIR            # turns: other, this, this, other
    python3 kernel_ab.py --other DIR --only rank    # one family: rank, wavefront, binned, auc, mega, cm
    python3 kernel_ab.py --worker DIR [FAMILY]  # one turn: DIR's package, JSON out

``DIR`` is the root of another checkout of this repository (for example
the parent commit, unpacked with ``git archive`` into a git-ignored
directory).  Each turn is its own process that imports
``torcheval_tpu_torch`` from one root, builds its kernels, and times, on
the same seeded inputs:

- ``edit_distance_tokens`` (``csrc/wavefront.cu``) at the corpus WER
  update, (8192, 256) x (8192, 256) int32 (``chip_smoke.py``'s corpus,
  numpy seed 31), and on random ids at the WER stream's largest batch,
  (64, 32) pairs of 1-20 tokens, and at an LM logits update, (2, 256);
- ``binned_weighted_counts`` (``csrc/binned_wcount.cu``) at the weighted
  histogram, (1000, 2^17) x 2048 (numpy seed 15, as ``chip_smoke.py``
  phase 26), at a north-star rank block, the strided (1000, 2^15) class
  view x 2048 (seed 6, rank 1's quarter), and at a binary rank block,
  (1, 2^20) x 16 384 (seed 5, rank 1's quarter); and ``binned_counts``
  (``csrc/binned_count.cu``) at the binned lifecycle's update, (1, 2^19) x
  10 000 (seed 5, as ``chip_smoke.py`` phase 14), with every score in one
  bin, as four contiguous rows of 2^17 with its scores and with scores in
  two bins, at the G = 32 layout of ``chip_smoke.py`` phase 12 (the headline's
  first update, the strided (1000, 16384) class view x 200) and at the two
  rank blocks; in a checkout whose wrapper passes a launch plan, the
  lifecycle's update again on the private route with a half and a
  quarter of the plan's blocks, and on the atomics route (one histogram
  in L2) with the thresholds in shared memory and in L1/L2, every score
  in one bin on the atomics route, and the G = 32 layout and the
  north-star rank block at 1, 2 and 4 blocks an SM.  Each
  ``binned_counts`` result is held against the plain version once;
- ``confusion_slab`` (``csrc/cm_slab.cu``) at the CM + F1 lifecycle's
  update, 2^17 int32 label pairs in [0, 1000] (C = 1000), with every pair
  in one cell, in one of two cells, with int64 labels, at C = 100 (2^17, 2^20 and 2^22 pairs)
  and at C = 200 (2^22).  Each result is held against the plain version
  once;
- ``rank_sum_counts`` (``csrc/rank_sum.cu``) at the headline, the strided
  (1000, 2^17) view of ``chip_smoke.py``'s headline scores (numpy seed 0)
  against its packed cap-256 tables with ``negate``, and at contiguous
  (4, 2^20) rows on a 1/64 grid with cap 512 (numpy seed 1); and
  ``rank_hist_counts`` (``csrc/rank_hist.cu``) at the headline view with
  cap 256; in a checkout whose wrappers pass a launch plan, each of the
  three again with the plan's query copies forced to 4 bytes.  Each result
  is held against the plain version once;
- ``auc_from_sorted`` (``csrc/auc_scan.cu``) on one sorted row of 2^22
  (``chip_smoke.py`` phase 4's ``BinaryAUROC`` data, numpy seed 2), on
  the headline's (1000, 2^17) class rows sorted (``chip_smoke.py``'s
  headline, numpy seed 0) and at the flagship's (8, 1024) (numpy seed 4),
  each held against the plain version once;
- ``mega_counts`` (``csrc/mega.cu``) at the collection update, five
  100-class members over (65536, 100) f32 (``chip_smoke.py`` phase 17's
  data, numpy seed 6; each call takes the next of its 8 updates, so the
  scores come from device memory), and at the sliced stream's bucketed
  batches, n = 128, 256 and 512, C = 20, 16 slices and a mask (numpy seed
  23), each held against the plain version once.

Each time is the median of 7 CUDA-event timings after a warm-up, beside
the device time a call by kernel from ``torch.profiler`` over 5 calls
(each kernel's total over its own count of calls).  The driver prints the
card's name and power limit, each turn's line, and one JSON object.
"""

import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


FAMILIES = ("wavefront", "binned", "rank", "auc", "mega", "cm")


def worker(root: str, only: str = "") -> dict:
    sys.path.insert(0, root)
    import torch

    import torcheval_tpu_torch
    from torcheval_tpu_torch.ops import _build

    pkg = os.path.dirname(os.path.abspath(torcheval_tpu_torch.__file__))
    assert pkg == os.path.join(os.path.abspath(root), "torcheval_tpu_torch"), pkg
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab.py needs an NVIDIA GPU")
    dev = torch.device("cuda")
    _build.library()
    from torch.profiler import ProfilerActivity, profile

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

    def by_kernel(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out = {}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            us = float(getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0)))
            if us > 0 and not e.key.startswith("Activity Buffer"):
                out[e.key[:60]] = [round(us / 1e3 / e.count, 4), e.count]
        return out

    res = {"root": root}
    if only in ("", "rank"):
        rank_turn(res, dev, median_ms, by_kernel)
    if only in ("", "wavefront"):
        wavefront_turn(res, dev, median_ms, by_kernel)
    if only in ("", "binned"):
        binned_turn(res, dev, median_ms, by_kernel)
    if only in ("", "auc"):
        auc_turn(res, dev, median_ms, by_kernel)
    if only in ("", "mega"):
        mega_turn(res, dev, median_ms, by_kernel)
    if only in ("", "cm"):
        cm_turn(res, dev, median_ms, by_kernel)
    res["launches"] = dict(_build.LAUNCHES)
    return res


def rank_turn(res, dev, median_ms, by_kernel):
    import numpy as np
    import torch

    from torcheval_tpu_torch.ops.ustat import (
        _pack_positive_tables,
        _pack_row_tables,
        _rank_hist_counts_plain,
        _rank_sum_counts_plain,
        rank_hist_counts,
        rank_sum_counts,
    )

    sys.path.insert(0, HERE)
    from chip_smoke import NUM_CLASSES, headline_data

    scores, target = headline_data()
    s = torch.from_numpy(scores).to(dev)
    t = torch.from_numpy(target).to(dev)
    _, table = _pack_positive_tables(s, t, NUM_CLASSES, 256)
    tables2 = torch.cat([table, -table.flip(1)])
    rng = np.random.default_rng(1)
    rows = torch.from_numpy((np.floor(rng.random((4, 2**20)) * 64) / 64).astype(np.float32)).to(dev)
    hits = torch.from_numpy(rng.random((4, 2**20)) < 2e-4).to(dev)
    _, row_table = _pack_row_tables(rows, hits, 512)
    row_tables2 = torch.cat([row_table, -row_table.flip(1)])
    cases = [
        ("rank_sum_counts headline (2000, 2^17) strided, cap 256",
         lambda: rank_sum_counts(s.T, tables2, negate=True),
         lambda: _rank_sum_counts_plain(s.T, tables2, negate=True)),
        ("rank_sum_counts rows (4, 2^20) contiguous, cap 512, negate",
         lambda: rank_sum_counts(rows, row_tables2, negate=True),
         lambda: _rank_sum_counts_plain(rows, row_tables2, negate=True)),
        ("rank_hist_counts headline (1000, 2^17) strided, cap 256",
         lambda: rank_hist_counts(s.T, table),
         lambda: _rank_hist_counts_plain(s.T, table)),
    ]
    from torcheval_tpu_torch.ops import ustat

    if hasattr(ustat, "_launch_rank_sum"):
        # A checkout whose wrappers pass a launch plan: the same cases with
        # the plan's copies forced to 4 bytes, to weigh the 16-byte path.
        sms = torch.cuda.get_device_properties(dev).multi_processor_count

        def four_byte_sum(q, tabs):
            plan = ustat.rank_sum_plan(q, tabs, negate=True, sms=sms)._replace(copy="4 B")
            out = torch.zeros(tabs.shape[0], dtype=torch.int32, device=dev)
            return lambda: ustat._launch_rank_sum(q, tabs, True, plan, out.zero_()) or out

        def four_byte_hist(q, tab):
            plan = ustat.rank_hist_plan(q, tab, sms=sms)._replace(copy="4 B")
            out = torch.zeros(tab.shape, dtype=torch.int32, device=dev)
            return lambda: ustat._launch_rank_hist(q, tab, plan, out.zero_()) or out

        cases += [
            (cases[0][0] + ", 4-byte copies", four_byte_sum(s.T, tables2), cases[0][2]),
            (cases[1][0] + ", 4-byte copies", four_byte_sum(rows, row_tables2), cases[1][2]),
            (cases[2][0] + ", 4-byte copies", four_byte_hist(s.T, table), cases[2][2]),
        ]
    for key, call, plain in cases:
        got = call()
        torch.cuda.synchronize()
        if not torch.equal(got, plain()):
            raise SystemExit(f"{key}: the kernel disagrees with its plain version")
        res[key] = [median_ms(call), by_kernel(call)]


def wavefront_turn(res, dev, median_ms, by_kernel):
    import numpy as np
    import torch

    from torcheval_tpu_torch.metrics.text._tokens import _pack
    from torcheval_tpu_torch.ops.wavefront import _edit_distance_kernel, lens_from_ids

    sys.path.insert(0, HERE)
    from chip_smoke import wer_corpus

    hyp, ref = wer_corpus(np.random.default_rng(31), 2**16)
    a = torch.from_numpy(_pack(hyp[:8192], 16)).to(dev)
    b = torch.from_numpy(_pack(ref[:8192], 16)).to(dev)
    al, bl = lens_from_ids(a), lens_from_ids(b)
    wave = lambda: _edit_distance_kernel(a, b, al, bl)  # noqa: E731
    res["edit_distance_tokens (8192, 256)"] = [median_ms(wave), by_kernel(wave)]
    for n_pairs, width, hi_len, vocab in ((64, 32, 20, 97), (2, 256, 256, 8192)):
        # The WER stream's largest batch, and an LM logits update's argmax.
        rng = np.random.default_rng(width)
        lens = rng.integers(1, hi_len + 1, (2, n_pairs))
        ids = rng.integers(0, vocab, (2, n_pairs, width)).astype(np.int32)
        ids[np.arange(width)[None, None, :] >= lens[..., None]] = -1
        x, y = (torch.from_numpy(v).to(dev) for v in ids)
        xl, yl = lens_from_ids(x), lens_from_ids(y)
        small = lambda: _edit_distance_kernel(x, y, xl, yl)  # noqa: E731
        res[f"edit_distance_tokens ({n_pairs}, {width})"] = [median_ms(small), by_kernel(small)]


def binned_turn(res, dev, median_ms, by_kernel):
    import numpy as np
    import torch

    from torcheval_tpu_torch.metrics.functional.classification._sort_scan import class_hits
    from torcheval_tpu_torch.metrics.functional.classification.binned_precision_recall_curve import (
        _create_threshold_tensor,
    )
    from torcheval_tpu_torch.ops import binned
    from torcheval_tpu_torch.ops.binned import (
        _binned_counts_plain,
        binned_counts,
        binned_weighted_counts,
    )
    from torcheval_tpu_torch.parallel.sync import _grid_np

    sys.path.insert(0, HERE)

    rng = np.random.default_rng(15)
    s = torch.from_numpy(rng.random((1000, 2**17)).astype(np.float32)).to(dev)
    h = torch.from_numpy(rng.random((1000, 2**17)) > 0.4).to(dev)
    w = torch.from_numpy(rng.random(2**17).astype(np.float32) + 0.5).to(dev)
    th = _create_threshold_tensor(2048, dev)
    call = lambda: binned_weighted_counts(s, h, w, th)  # noqa: E731
    res["binned_weighted_counts (1000, 2^17) x 2048"] = [median_ms(call), by_kernel(call)]
    del s, h

    rng = np.random.default_rng(6)
    ns_s = rng.random((2**17, 1000), dtype=np.float32)
    ns_t = rng.integers(0, 1000, 2**17).astype(np.int32)
    ns_w = rng.random(2**17).astype(np.float32) + 0.5
    q = slice(2**15, 2**16)  # rank 1's block of four
    s = torch.from_numpy(ns_s[q]).to(dev).T
    h = class_hits(torch.from_numpy(ns_t[q]).to(dev), 1000)
    w = torch.from_numpy(ns_w[q]).to(dev)
    grid = torch.tensor(_grid_np(2048), device=dev)
    call = lambda: binned_weighted_counts(s, h, w, grid)  # noqa: E731
    res["binned_weighted_counts north-star block (1000, 2^15) strided x 2048"] = [
        median_ms(call), by_kernel(call)]

    rng = np.random.default_rng(5)
    bs_s = rng.random(2**22, dtype=np.float32)
    bs_t = rng.random(2**22) > 0.5
    bs_w = rng.random(2**22).astype(np.float32) + 0.5
    q = slice(2**20, 2**21)
    s = torch.from_numpy(bs_s[q]).to(dev)[None]
    h = torch.from_numpy(bs_t[q]).to(dev)[None]
    w = torch.from_numpy(bs_w[q]).to(dev)
    grid = torch.tensor(_grid_np(16_384), device=dev)
    call = lambda: binned_weighted_counts(s, h, w, grid)  # noqa: E731
    res["binned_weighted_counts binary block (1, 2^20) x 16384"] = [
        median_ms(call), by_kernel(call)]
    counts_cases = [("binned_counts binary block (1, 2^20) x 16384", s, h, grid)]

    s = torch.from_numpy(ns_s[2**15 : 2**16]).to(dev).T
    h = class_hits(torch.from_numpy(ns_t[2**15 : 2**16]).to(dev), 1000)
    counts_cases.append(("binned_counts north-star block (1000, 2^15) strided x 2048", s, h,
                         torch.tensor(_grid_np(2048), device=dev)))
    rng = np.random.default_rng(5)
    upd = torch.from_numpy(rng.random(2**22, dtype=np.float32)[: 2**19]).to(dev)[None]
    upd_h = torch.from_numpy((rng.random(2**22) > 0.5)[: 2**19]).to(dev)[None]
    grid10k = _create_threshold_tensor(10_000, dev)
    counts_cases += [
        ("binned_counts lifecycle update (1, 2^19) x 10000", upd, upd_h, grid10k),
        ("binned_counts every score in one bin (1, 2^19) x 10000", torch.full_like(upd, 0.37),
         upd_h, grid10k),
        ("binned_counts (4, 2^17) contiguous rows x 10000", upd.view(4, 2**17),
         upd_h.view(4, 2**17), grid10k),
        ("binned_counts two bins, (4, 2^17) contiguous rows x 10000",
         torch.where(upd < 0.5, 0.37, 0.81).view(4, 2**17), upd_h.view(4, 2**17), grid10k),
    ]
    from chip_smoke import NUM_CLASSES, NUM_UPDATES, headline_data

    scores, target = headline_data()
    first = scores.shape[0] // NUM_UPDATES
    hs = torch.from_numpy(scores[:first]).to(dev)
    counts_cases.append(("binned_counts G = 32 layout (1000, 16384) strided x 200", hs.T,
                         class_hits(torch.from_numpy(target[:first]).to(dev), NUM_CLASSES),
                         _create_threshold_tensor(200, dev)))
    for key, cs, ch, cg in counts_cases:
        call = lambda: binned_counts(cs, ch, cg)  # noqa: E731
        if not all(torch.equal(a, b) for a, b in zip(call(), _binned_counts_plain(cs, ch, cg))):
            raise SystemExit(f"{key}: the kernel disagrees with its plain version")
        res[key] = [median_ms(call), by_kernel(call, reps=20)]
    if hasattr(binned, "_launch_binned_count"):
        # A checkout whose wrapper passes a launch plan: the lifecycle's
        # update on the private route with fewer blocks and on the atomics
        # route with the thresholds in either home, every score in one bin
        # on the atomics route, and the atomics route's G = 32 and
        # north-star shapes at 1, 2 and 4 blocks an SM.
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plan = binned.binned_count_plan(upd, upd_h, 10_000)
        variants = [
            (f"lifecycle update, private route, {plan.blocks // d} blocks", upd, upd_h, grid10k,
             plan._replace(blocks=plan.blocks // d))
            for d in (2, 4)
        ]
        for smem in (True, False):
            variants.append(("lifecycle update, atomics into one histogram, thresholds in "
                             + ("shared memory" if smem else "L1/L2"), upd, upd_h, grid10k,
                             plan._replace(private=False, smem=smem)))
        one_bin = torch.full_like(upd, 0.37)
        variants.append(("every score in one bin, atomics into one histogram", one_bin, upd_h,
                         grid10k, plan._replace(private=False)))
        for key, cs, ch, cg in counts_cases:
            if "G = 32" not in key and "north-star" not in key:
                continue
            base = binned.binned_count_plan(cs, ch, cg.numel())
            for per_sm in (1, 2, 4):
                blocks = max(1, min(-(-base.tiles // binned._COUNT_WARPS), sms * per_sm))
                variants.append((f"{key[len('binned_counts '):]}, {per_sm} blocks an SM", cs, ch,
                                 cg, base._replace(blocks=blocks)))
        for label, cs, ch, cg, other in variants:
            call = lambda: binned._launch_binned_count(cs, ch, cg, other)  # noqa: E731
            if not all(torch.equal(a, b) for a, b in zip(call(), _binned_counts_plain(cs, ch, cg))):
                raise SystemExit(f"{label}: the kernel disagrees with its plain version")
            res["binned_counts " + label] = [median_ms(call), by_kernel(call, reps=20)]


def auc_turn(res, dev, median_ms, by_kernel):
    import numpy as np
    import torch

    from torcheval_tpu_torch.metrics.functional.classification._sort_scan import (
        class_hits,
        sort_desc,
    )
    from torcheval_tpu_torch.ops.auc import _auc_from_sorted_plain, auc_from_sorted

    sys.path.insert(0, HERE)
    from chip_smoke import NUM_CLASSES, headline_data

    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.random(2**22).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.random(2**22) < 0.5).to(dev)
    scores, target = headline_data()
    s = torch.from_numpy(scores).to(dev)
    t = torch.from_numpy(target).to(dev)
    rng = np.random.default_rng(4)
    f = torch.from_numpy(rng.random((8, 1024)).astype(np.float32)).to(dev)
    fy = torch.from_numpy(rng.random((8, 1024)) < 0.2).to(dev)
    for key, (th, hh) in [
        ("auc_from_sorted (1, 2^22)", sort_desc(x[None], y[None])),
        ("auc_from_sorted headline (1000, 2^17)", sort_desc(s.T, class_hits(t, NUM_CLASSES))),
        ("auc_from_sorted flagship (8, 1024)", sort_desc(f, fy)),
    ]:
        call = lambda: auc_from_sorted(th, hh)  # noqa: E731
        if not torch.equal(call(), _auc_from_sorted_plain(th, hh)):
            raise SystemExit(f"{key}: the kernel disagrees with its plain version")
        res[key] = [median_ms(call), by_kernel(call, reps=20)]


def mega_turn(res, dev, median_ms, by_kernel):
    import numpy as np
    import torch

    from torcheval_tpu_torch import _flags
    from torcheval_tpu_torch import metrics as M
    from torcheval_tpu_torch.ops._mega_plan import plan_for
    from torcheval_tpu_torch.ops.mega import _mega_counts_plain, mega_counts

    def five(c):
        return {
            "acc": M.MulticlassAccuracy(num_classes=c, average="macro"),
            "f1": M.MulticlassF1Score(num_classes=c, average="macro"),
            "cm": M.MulticlassConfusionMatrix(num_classes=c),
            "prec": M.MulticlassPrecision(num_classes=c, average="macro"),
            "rec": M.MulticlassRecall(num_classes=c, average="macro"),
        }

    def check(key, plan, *ops):
        got = mega_counts(plan, *ops)
        torch.cuda.synchronize()
        want = _mega_counts_plain(plan, *ops)
        if not all((a is None and b is None) or torch.equal(a, b)
                   for ga, wa in zip(got, want) for a, b in zip(ga, wa)):
            raise SystemExit(f"{key}: the kernel disagrees with its plain version")

    with _flags.overridden("MEGAKERNEL", "1"):
        rng = np.random.default_rng(6)
        xs = [torch.from_numpy(rng.random((65536, 100), dtype=np.float32)).to(dev)
              for _ in range(8)]
        ys = [torch.from_numpy(rng.integers(0, 100, 65536).astype(np.int32)).to(dev)
              for _ in range(8)]
        plan = plan_for(five(100), (xs[0], ys[0]), {}, None)
        key = "mega_counts collection update (65536, 100), five members"
        check(key, plan, xs[0], ys[0])
        turn = [0]

        def update():
            i = turn[0] = (turn[0] + 1) % 8
            return mega_counts(plan, xs[i], ys[i])

        res[key] = [median_ms(update), by_kernel(update, reps=24)]
        del xs, ys
        rng = np.random.default_rng(23)
        for n in (128, 256, 512):
            x = torch.from_numpy(rng.random((n, 20), dtype=np.float32)).to(dev)
            y = torch.from_numpy(rng.integers(0, 20, n).astype(np.int32)).to(dev)
            mask = torch.from_numpy((rng.random(n) < 0.7).astype(np.int32)).to(dev)
            sids = torch.from_numpy(rng.integers(0, 16, n).astype(np.int32)).to(dev)
            sp = plan_for(five(20), (x, y), {"mask": mask}, 16)
            key = f"mega_counts sliced batch n={n}, C=20, 16 slices, a mask"
            check(key, sp, x, y, mask, sids)
            call = lambda: mega_counts(sp, x, y, mask, sids)  # noqa: E731
            res[key] = [median_ms(call), by_kernel(call, reps=24)]


def cm_turn(res, dev, median_ms, by_kernel):
    import torch

    from torcheval_tpu_torch.ops.cm import _confusion_slab_plain, _slab

    gen = torch.Generator(device=dev).manual_seed(3)
    n = 2**17
    t = torch.randint(0, 1001, (2**22,), device=dev, generator=gen, dtype=torch.int32)
    p = torch.randint(0, 1001, (2**22,), device=dev, generator=gen, dtype=torch.int32)
    cases = [
        ("confusion_slab lifecycle update (2^17,) int32, C = 1000", t[:n], p[:n], 1000),
        ("confusion_slab every pair in one cell (2^17,), C = 1000",
         torch.zeros_like(t[:n]), torch.full_like(p[:n], 7), 1000),
        ("confusion_slab every pair in one of two cells (2^17,), C = 1000",
         torch.where(t[:n] < 500, 3, 8), torch.where(t[:n] < 500, 5, 9), 1000),
        ("confusion_slab (2^17,) int64 labels, C = 1000", t[:n].long(), p[:n].long(), 1000),
        ("confusion_slab (2^17,) int32, C = 100", t[:n] % 101, p[:n] % 101, 100),
        ("confusion_slab (2^20,) int32, C = 100", t[: 2**20] % 101, p[: 2**20] % 101, 100),
        ("confusion_slab (2^22,) int32, C = 100", t % 101, p % 101, 100),
        ("confusion_slab (2^22,) int32, C = 200", t % 201, p % 201, 200),
    ]
    for key, ct, cp, c in cases:
        call = lambda: _slab(ct, cp, c)  # noqa: E731
        if not torch.equal(call(), _confusion_slab_plain(ct, cp, c)):
            raise SystemExit(f"{key}: the kernel disagrees with its plain version")
        res[key] = [median_ms(call), by_kernel(call, reps=20)]


def ptxas(root: str, names=("rank_sum.cu", "rank_hist.cu")) -> list:
    """``nvcc -Xptxas -v``'s lines for the kernels of ``names`` in ``root``:
    each kernel's registers, spills and shared memory, and each source's
    compile time."""
    import shutil
    import tempfile
    import time

    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    lines = []
    csrc = os.path.join(root, "torcheval_tpu_torch", "ops", "csrc")
    with tempfile.TemporaryDirectory() as tmp:
        for name in names:
            start = time.perf_counter()
            proc = subprocess.run(
                [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                 "-Xptxas", "-v", "-c", os.path.join(csrc, name), "-o",
                 os.path.join(tmp, name + ".o")],
                capture_output=True, text=True, timeout=600,
            )
            lines.append(f"{name}: nvcc {time.perf_counter() - start:.1f} s")
            fn = "?"
            for line in proc.stderr.splitlines():
                if "Compiling entry function" in line:
                    fn = line.split("'")[1] if "'" in line else line
                elif "registers" in line or "spill" in line:
                    lines.append(f"{name} {fn}: {line.split(':', 1)[-1].strip()}")
            if proc.returncode != 0:
                lines.append(f"{name}: nvcc failed: {proc.stderr[-2000:]}")
    return lines


def main(argv) -> int:
    if argv[:1] == ["--worker"]:
        print(json.dumps(worker(*argv[1:3])), flush=True)
        return 0
    only = ""
    if argv[2:3] == ["--only"] and len(argv) == 4 and argv[3] in FAMILIES:
        only, argv = argv[3], argv[:2]
    if argv[:1] != ["--other"] or len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(argv[1])
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    sources = {"rank": ("rank_sum.cu", "rank_hist.cu"), "auc": ("auc_scan.cu",),
               "mega": ("mega.cu",), "binned": ("binned_count.cu", "binned_wcount.cu"),
               "cm": ("cm_slab.cu",)}
    for family, names in sources.items():
        if only in ("", family):
            for label, root in [("other", other), ("this", HERE)]:
                for line in ptxas(root, names):
                    print(f"ptxas {label}: {line}", flush=True)
    turns = []
    for label, root in [("other", other), ("this", HERE), ("this", HERE), ("other", other)]:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", root, only],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stdout, proc.stderr, file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["turn"] = label
        turns.append(res)
        for key, val in res.items():
            if isinstance(val, list):
                print(f"{label} [{smi}]: {key}: {val[0]:.4f} ms; by kernel {val[1]}", flush=True)
        print(f"{label}: launches {res['launches']}", flush=True)
    print(json.dumps({"card": smi, "turns": turns}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
