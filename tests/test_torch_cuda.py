"""The port's CUDA kernels on the card: each held bit for bit against its
plain PyTorch version, and a metric on the GPU against the same metric on
the CPU.  A CUDA kernel has no CPU mode, so every test here skips without
a GPU.  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from torcheval_tpu_torch import convert
from torcheval_tpu_torch.distributed import LocalWorld
from torcheval_tpu_torch.flagship import FlagshipMLP, eval_step
from torcheval_tpu_torch.metrics import (
    BinaryAUROC,
    BinaryBinnedAUROC,
    BinaryPrecisionRecallCurve,
    MulticlassAccuracy,
    MulticlassAUPRC,
    MulticlassAUROC,
    MulticlassBinnedAUPRC,
    MulticlassConfusionMatrix,
    MulticlassF1Score,
    MulticlassPrecisionRecallCurve,
    MultilabelRecallAtFixedPrecision,
)
from torcheval_tpu_torch.metrics.functional import (
    binary_auroc,
    multiclass_accuracy,
    multiclass_auroc,
    multiclass_confusion_matrix,
)
from torcheval_tpu_torch.metrics.functional._host_checks import skip_value_checks
from torcheval_tpu_torch.ops import _build, binned, cm, ustat
from torcheval_tpu_torch.ops.auc import _auc_from_sorted_plain, auc_from_sorted, auc_plan
from torcheval_tpu_torch.ops.binned import (
    _binned_counts_plain,
    _binned_weighted_counts_plain,
    binned_counts,
    binned_weighted_counts,
)
from torcheval_tpu_torch.ops.cm import _confusion_slab_plain, confusion_slab
from torcheval_tpu_torch.parallel import (
    make_mesh,
    shard_batch,
    sharded_auroc_histogram,
    sharded_binary_auroc_exact,
    sharded_multiclass_auroc_ustat,
)
from torcheval_tpu_torch.parallel.sync import _grid_np

pytestmark = pytest.mark.cuda

_BIG = 3.0e38


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _tables(rng, r, cap, pad_front=0, pad_back=0):
    t = np.sort((rng.integers(-8, 8, (r, cap)) / 4).astype(np.float32), axis=1)
    if pad_back:
        t[:, cap - pad_back :] = _BIG
    t[:, :pad_front] = -_BIG
    return t


def _rank_queries(layout, rng, rq, n, dev):
    """``(rq, n)`` f32 queries on a 1/4 grid (ties with the tables) in one
    of the kernels' layouts: "columns", the (N, C) buffer's transpose read
    in place (G = 32, 16-byte copies); "rows", contiguous rows (G = 1);
    "pitch", the same with a pitch of ``rq`` floats, not a multiple of four
    (4-byte copies); "offset", ``buf[:, 1:]`` of an (N, rq + 1) buffer (a
    base 4 bytes past 16-byte alignment: 4-byte copies); "narrow",
    ``buf[:, :rq]`` of an (N, rq + 1) buffer, rq + 1 a multiple of four
    (16-byte copies, the last group's last copy zero-filled)."""
    width = rq + 1 if layout in ("offset", "narrow") else rq
    buf = torch.from_numpy((rng.integers(-9, 9, (n, width)) / 4).astype(np.float32)).to(dev)
    if layout == "rows":
        return buf.T.contiguous()
    return {"offset": buf[:, 1:], "narrow": buf[:, :rq]}.get(layout, buf).T


def _check_copy(layout, plan):
    if layout in ("pitch", "offset"):
        assert plan.copy == "4 B"
    if layout == "narrow":
        assert plan.copy == "16 B"


# G = 32 tiles hold 64 samples, G = 1 tiles 2048; tables leave shared
# memory past cap 768 (G = 32, negate) and 24 704 (G = 1, negate).
@pytest.mark.parametrize(
    "layout,rq,n,cap",
    [
        ("columns", 40, 4096 * 2 + 5, 256),  # 32-row groups, shared-memory tables
        ("rows", 3, 70_000, 512),  # one row per block
        ("columns", 33, 50_000, 4096),  # tables read from global memory
        ("columns", 31, 63, 256),  # less than one tile
        ("columns", 33, 65, 128),  # one tile and one sample
        ("columns", 32, 64, 16),  # exactly one tile
        ("columns/no-negate", 33, 1000, 80),  # cap not a power of two: guarded steps
        ("columns/no-negate", 40, 1000, 256),  # one table: guarded steps
        ("rows", 2, 3000, 1024),  # a power of two past the route's: guarded steps
        ("rows", 2, 2048 * 3 - 1, 256),  # a tile short
        ("rows/no-negate", 1, 2048 + 1, 48),
        ("pitch", 999, 4099, 256),  # C = 999: 4-byte copies
        ("offset", 40, 5000, 256),  # scores[:, 1:]: 4-byte copies
        ("narrow", 999, 4099, 256),  # scores[:, :999] of 1000: a partial 16-byte copy
        ("columns", 33, 3000, 768),  # the largest shared-memory cap
        ("columns", 33, 3000, 784),  # one past it: global tables
        ("rows", 2, 3000, 24_704),
        ("rows", 2, 3000, 24_720),
        ("columns", 33, 3000, 32),  # each cap with fixed steps, G = 32
        ("columns", 33, 3000, 64),  # 48 KiB dynamic + the static buffer: opt-in
        ("rows", 2, 5000, 32),  # and G = 1
        ("rows", 2, 3000, 1808),  # G = 1 past 48 KiB only with the static buffer
    ],
)
def test_rank_sum_kernel_bitwise_equals_plain(layout, rq, n, cap):
    dev = _cuda()
    layout, _, flag = layout.partition("/")
    negate = flag != "no-negate"
    rng = np.random.default_rng(rq)
    halves = [_tables(rng, rq, cap, 0, 3), _tables(rng, rq, cap, 3, 0)]
    t = torch.from_numpy(np.concatenate(halves if negate else halves[:1])).to(dev)
    q = _rank_queries(layout, rng, rq, n, dev)
    _build.reset_counts()
    got = ustat.rank_sum_counts(q, t, negate=negate)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["rank_sum_counts"] == 1
    assert torch.equal(got, ustat._rank_sum_counts_plain(q, t, negate=negate))
    plan = ustat.rank_sum_plan(q, t, negate=negate)
    _check_copy(layout, plan)
    assert plan.tables == ("global" if cap in (784, 4096, 24_720) else "shared")
    fixed = negate and plan.tables == "shared" and cap in ustat._FIXED_CAPS
    assert plan.fixed_top == (cap if fixed else 0)


@pytest.mark.parametrize("rows,n", [(5, 4096 * 3 + 17), (1, 100_000)])
def test_auc_kernel_bitwise_equals_plain(rows, n):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(rows)
    t = torch.floor(torch.rand(rows, n, device=dev, generator=gen) * 64) / 64
    t = torch.sort(t, dim=1, descending=True).values
    h = torch.rand(rows, n, device=dev, generator=gen) < 0.3
    _build.reset_counts()
    got = auc_from_sorted(t, h)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["auc_from_sorted"] == 1
    assert torch.equal(got, _auc_from_sorted_plain(t, h))


def _auc_case(case, dev):
    """Sorted (rows, n) scores and hits for one edge of auc_scan.cu's plan."""
    gen = torch.Generator(device=dev).manual_seed(len(case))
    shapes = {"one row 2^22": (1, 2**22), "all tied 2^22": (1, 2**22),
              "chunk edge - 1": (1, 4095), "chunk edge + 1": (1, 4097),
              "2^22 - 1": (1, 2**22 - 1), "2^22 + 3, shifted": (1, 2**22 + 3),
              "tie run over 64 chunks": (1, 2**20), "flagship 8 x 1024": (8, 1024),
              "headline 1000 x 131072": (1000, 131072), "37 rows of 10007": (37, 10_007),
              "unaligned operands": (3, 50_000)}
    rows, n = shapes[case]
    levels = 4 if case.startswith("tie run") else 64
    t = torch.floor(torch.rand(rows, n, device=dev, generator=gen) * levels) / levels
    if case.startswith("all tied"):
        t.fill_(0.5)
    t = torch.sort(t, dim=1, descending=True).values
    h = torch.rand(rows, n, device=dev, generator=gen) < 0.3
    if case == "unaligned operands":
        tb = torch.empty(rows * n + 1, device=dev)
        hb = torch.empty(rows * n + 1, dtype=torch.bool, device=dev)
        tb[1:].copy_(t.flatten())
        hb[1:].copy_(h.flatten())
        t, h = tb[1:].view(rows, n), hb[1:].view(rows, n)
    return t, h


@pytest.mark.parametrize("case", [
    "one row 2^22", "all tied 2^22", "chunk edge - 1", "chunk edge + 1", "2^22 - 1",
    "2^22 + 3, shifted", "tie run over 64 chunks", "flagship 8 x 1024",
    "headline 1000 x 131072", "37 rows of 10007", "unaligned operands",
])
def test_auc_kernel_at_the_plan_edges(case):
    dev = _cuda()
    t, h = _auc_case(case, dev)
    plan = auc_plan(t, h, torch.cuda.get_device_properties(dev).multi_processor_count)
    print(f"auc_from_sorted {case}: {plan.describe()}")
    assert plan.vec == (case != "unaligned operands")
    _build.reset_counts()
    got = auc_from_sorted(t, h)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"auc_from_sorted": 1} and not _build.PLAIN_CALLS
    want = _auc_from_sorted_plain(t, h)
    assert torch.equal(got, want), (case, plan.describe())
    if case.startswith("all tied"):
        assert float(got[0]) == 0.5


@pytest.mark.parametrize("num_classes", [200, 16])
def test_multiclass_metric_on_the_card_equals_the_cpu(num_classes):
    dev = _cuda()
    rng = np.random.default_rng(num_classes)
    s = rng.random((2**15, num_classes)).astype(np.float32)
    y = rng.integers(0, num_classes, 2**15).astype(np.int32)
    on_card = MulticlassAUROC(num_classes=num_classes, average=None)
    assert on_card.device.type == "cuda"
    on_cpu = MulticlassAUROC(num_classes=num_classes, average=None, device="cpu")
    for cs, cy in zip(np.split(s, 8), np.split(y, 8)):
        on_card.update(cs, cy)
        on_cpu.update(cs, cy)
    _build.reset_counts()
    got = on_card.compute()
    assert sum(_build.LAUNCHES.values()) == 1
    assert torch.equal(got.cpu(), on_cpu.compute())


def test_binary_metric_on_the_card_equals_the_cpu():
    dev = _cuda()
    rng = np.random.default_rng(3)
    s = rng.random((2, 2**15)).astype(np.float32)
    y = (rng.random((2, 2**15)) < 0.002).astype(np.int32)  # rare positives
    on_card = BinaryAUROC(num_tasks=2, device=dev).update(s, y)
    on_cpu = BinaryAUROC(num_tasks=2, device="cpu").update(s, y)
    assert torch.equal(on_card.compute().cpu(), on_cpu.compute())


@pytest.mark.parametrize(
    "n,c,one_cell",
    [(2**17, 1000, False), (100_003, 130, False), (2**17, 1000, True), (0, 1000, False), (5, 3, False),
     (2**17, 100, False)],
    ids=["lifecycle-shape", "c130-ragged", "one-cell", "empty", "tiny", "c100"],
)
def test_slab_kernel_bitwise_equals_plain(n, c, one_cell):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(n + c)
    if one_cell:
        t = torch.full((n,), c, dtype=torch.int32, device=dev)  # the sentinel row
        p = torch.full((n,), 7, dtype=torch.int32, device=dev)
    else:
        t = torch.randint(0, c + 1, (n,), device=dev, generator=gen, dtype=torch.int32)
        p = torch.randint(0, c + 1, (n,), device=dev, generator=gen, dtype=torch.int32)
    _build.reset_counts()
    got = confusion_slab(t, p, num_classes=c)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["confusion_slab"] == (1 if n else 0)
    assert torch.equal(got, _confusion_slab_plain(t, p, c))
    assert int(got.sum()) == n


@pytest.mark.parametrize(
    "layout", ["int64", "int32-int64", "int64-int32", "int16", "non-contiguous", "unaligned",
               "two-cell"]
)
def test_slab_kernel_reads_labels_in_place(layout):
    # int32 and int64 labels in place (a template each), other widths
    # widened, views made contiguous; the launch count stays one a call.
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(len(layout))
    n, c = 100_003, 1000
    t = torch.randint(0, c + 1, (2 * n,), device=dev, generator=gen)
    p = torch.randint(0, c + 1, (2 * n,), device=dev, generator=gen)
    if layout == "two-cell":
        pick = torch.rand(2 * n, device=dev, generator=gen) < 0.5
        t, p = torch.where(pick, 3, 8), torch.where(pick, 5, 9)
    t_dtype, p_dtype = {"int64": (torch.int64,) * 2, "int32-int64": (torch.int32, torch.int64),
                        "int64-int32": (torch.int64, torch.int32),
                        "int16": (torch.int16,) * 2}.get(layout, (torch.int32,) * 2)
    t, p = t.to(t_dtype), p.to(p_dtype)
    if layout == "non-contiguous":
        t, p = t[::2], p[1::2]
    elif layout == "unaligned":
        t, p = t[1 : n + 1], p[3 : n + 3]
    else:
        t, p = t[:n], p[:n]
    _build.reset_counts()
    got = confusion_slab(t, p, num_classes=c)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"confusion_slab": 1}
    assert torch.equal(got, _confusion_slab_plain(t, p, c)) and int(got.sum()) == n


@pytest.mark.parametrize("cells", ["spread", "one-cell", "two-cell"])
def test_slab_kernel_plan_variants_bitwise_equal_plain(cells):
    # Both load forms, at one block and at the plan's grid, on spread
    # labels, on rounds all in one cell and on rounds split over two.
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(3)
    n, c = 2**17 + 9, 100
    t = torch.randint(0, c + 1, (n,), device=dev, generator=gen, dtype=torch.int32)
    p = torch.randint(0, c + 1, (n,), device=dev, generator=gen, dtype=torch.int32)
    if cells == "one-cell":
        t.fill_(c)
    elif cells == "two-cell":
        t, p = torch.where(t < 50, 3, 8).int(), torch.where(t < 50, 5, 9).int()
    plan = cm.slab_plan(t, p)
    for variant in {plan, plan._replace(vec=False), plan._replace(blocks=1)}:
        slab = torch.zeros((c + 1, c + 1), dtype=torch.int32, device=dev)
        cm._launch_slab(t, p, c + 1, variant, slab)
        torch.cuda.synchronize()
        assert torch.equal(slab, _confusion_slab_plain(t, p, c)), variant.describe()


def test_counting_metrics_on_the_card_equal_the_cpu():
    _cuda()
    rng = np.random.default_rng(3)
    pred = rng.integers(0, 1000, 2**15).astype(np.int32)
    target = rng.integers(0, 1000, 2**15).astype(np.int32)

    def metrics(device):
        return (
            MulticlassConfusionMatrix(1000, device=device),
            MulticlassF1Score(num_classes=1000, average="macro", device=device),
            MulticlassAccuracy(average="macro", num_classes=1000, device=device),
        )

    on_card, on_cpu = metrics(None), metrics("cpu")
    assert all(m.device.type == "cuda" for m in on_card)
    _build.reset_counts()
    for p, t in zip(np.split(pred, 4), np.split(target, 4)):
        for m in on_card + on_cpu:
            m.update(p, t)
    assert _build.LAUNCHES == {"confusion_slab": 8}
    assert torch.equal(on_card[0].compute().cpu(), on_cpu[0].compute())
    for card, cpu in zip(on_card[1:], on_cpu[1:]):
        # Counts are equal; the macro means are f32 sums in another order.
        for name in card._state_name_to_default:
            assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name))
        torch.testing.assert_close(card.compute().cpu(), cpu.compute(), rtol=1e-6, atol=0)


def test_flagship_on_the_card_equals_the_cpu():
    """The card's logits within 1e-5 of the CPU model's (TF32 off, weights
    from numpy); the card's metrics against the same metrics on the CPU on
    the card's OWN scores (logits 1e-5 apart can reorder near-tied
    scores, so the two devices' AUROCs need not agree to 1e-6)."""
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1024, 32)).astype(np.float32)
    y = rng.integers(0, 8, 1024).astype(np.int32)
    params = convert.params_from_jax({
        "w1": (rng.standard_normal((32, 64)) / np.sqrt(32)).astype(np.float32),
        "b1": np.zeros(64, np.float32),
        "w2": (rng.standard_normal((64, 8)) / np.sqrt(64)).astype(np.float32),
        "b2": np.zeros(8, np.float32),
    })
    cpu_model = FlagshipMLP(device="cpu")
    cpu_model.load_state_dict(params)
    card_model = FlagshipMLP(device=dev)
    card_model.load_state_dict(params)
    _build.reset_counts()
    got = eval_step(card_model, x, y)
    assert dict(_build.LAUNCHES) == {"auc_from_sorted": 1} and not _build.PLAIN_CALLS
    want = eval_step(cpu_model, x, y)
    torch.testing.assert_close(got["logits"].cpu(), want["logits"], rtol=0, atol=1e-5)
    scores = torch.softmax(got["logits"], dim=-1)  # eval_step's own scores, on the card
    target = torch.from_numpy(y)
    on_cpu = {
        "accuracy": multiclass_accuracy(scores.cpu(), target),
        "confusion_matrix": multiclass_confusion_matrix(
            torch.argmax(scores.cpu(), dim=-1), target, num_classes=8),
        "per_class": multiclass_auroc(scores.cpu(), target, num_classes=8, average=None),
    }
    assert float(got["accuracy"]) == float(on_cpu["accuracy"])
    assert torch.equal(got["confusion_matrix"].cpu(), on_cpu["confusion_matrix"])
    per_class = multiclass_auroc(scores, target.to(dev), num_classes=8, average=None)
    assert torch.equal(per_class.cpu(), on_cpu["per_class"])
    # The macro mean sums 8 floats in each device's own order.
    assert abs(float(got["auroc"]) - float(on_cpu["per_class"].mean())) <= 1e-6


def test_sharded_multiclass_ustat_on_the_card_equals_the_cpu():
    """Over LocalWorld(2) on the card: one rank_sum_counts launch a rank on
    the gather, one a ring step, and the same bits as the same call on CPU
    tensors (the kernel's plain version)."""
    dev = _cuda()
    rng = np.random.default_rng(36)
    s = (np.round(rng.random((4096, 64)) * 256) / 256).astype(np.float32)
    t = rng.integers(0, 64, 4096).astype(np.int32)

    def run(device, comm):
        s_dev, t_dev = torch.from_numpy(s).to(device), torch.from_numpy(t).to(device)
        _build.reset_counts()
        out = LocalWorld(2).run(lambda g, r: sharded_multiclass_auroc_ustat(
            *shard_batch(make_mesh(group=g), s_dev, t_dev), make_mesh(group=g),
            num_classes=64, average=None, comm=comm))
        assert torch.equal(out[0], out[1])
        return out[0].cpu(), dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)

    for comm, launches in (("gather", 2), ("ring", 4)):
        card, card_launches, card_plain = run(dev, comm)
        cpu, cpu_launches, cpu_plain = run("cpu", comm)
        assert card_launches == {"rank_sum_counts": launches} and not card_plain
        assert cpu_plain == {"rank_sum_counts": launches} and not cpu_launches
        assert torch.equal(card, cpu), comm


def test_sharded_binary_gather_exact_on_the_card_equals_binary_auroc():
    dev = _cuda()
    rng = np.random.default_rng(37)
    s = torch.from_numpy(rng.random(2**16).astype(np.float32)).to(dev)
    t = torch.from_numpy((rng.random(2**16) < 0.5).astype(np.int32)).to(dev)
    _build.reset_counts()
    out = LocalWorld(2).run(lambda g, r: sharded_binary_auroc_exact(
        *shard_batch(make_mesh(group=g), s, t), make_mesh(group=g)))
    assert dict(_build.LAUNCHES) == {"auc_from_sorted": 2} and not _build.PLAIN_CALLS
    assert torch.equal(out[0], out[1]) and torch.equal(out[0], binary_auroc(s, t))


# Tables and counts leave shared memory past cap 768 (G = 32) and 24 960
# (G = 1).
@pytest.mark.parametrize(
    "layout,rows,n,cap",
    [
        ("columns", 37, 4096 * 2 + 5, 256),  # 32-row groups, shared-memory histograms
        ("rows", 3, 70_000, 512),  # one row per block
        ("columns", 33, 50_000, 4096),  # tables and counts in global memory
        ("columns", 31, 63, 256),  # less than one tile
        ("columns", 33, 65, 128),  # one tile and one sample
        ("columns", 32, 64, 16),  # exactly one tile
        ("columns", 33, 1000, 80),  # cap not a power of two: guarded steps
        ("rows", 2, 3000, 1024),  # a power of two past the route's: guarded steps
        ("rows", 2, 2048 * 3 - 1, 256),  # a tile short
        ("pitch", 999, 4099, 256),  # C = 999: 4-byte copies
        ("offset", 40, 5000, 256),  # scores[:, 1:]: 4-byte copies
        ("narrow", 999, 4099, 256),  # scores[:, :999] of 1000: a partial 16-byte copy
        ("columns", 33, 3000, 768),  # the largest shared-memory cap
        ("columns", 33, 3000, 784),  # one past it: global tables and counts
        ("rows", 2, 3000, 24_960),
        ("rows", 2, 3000, 24_976),
        ("columns", 33, 3000, 32),  # each cap with fixed steps, G = 32
        ("columns", 33, 3000, 64),
        ("rows", 2, 5000, 32),  # and G = 1
    ],
)
def test_rank_hist_kernel_bitwise_equals_plain(layout, rows, n, cap):
    dev = _cuda()
    rng = np.random.default_rng(rows + cap)
    t = _tables(rng, rows, cap, 0, cap // 2)
    t[1] = _BIG  # a row without positives: no bin
    q = _rank_queries(layout, rng, rows, n, dev)
    t = torch.from_numpy(t).to(dev)
    plan = ustat.rank_hist_plan(q, t)
    _check_copy(layout, plan)
    assert plan.tables == ("global" if cap in (784, 4096, 24_976) else "shared")
    fixed = plan.tables == "shared" and cap in ustat._FIXED_CAPS
    assert plan.fixed_top == (cap if fixed else 0)
    _build.reset_counts()
    got = ustat.rank_hist_counts(q, t)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["rank_hist_counts"] == 1
    assert torch.equal(got, ustat._rank_hist_counts_plain(q, t))
    assert int(got[1].sum()) == 0


@pytest.mark.parametrize(
    "kernel,cap,fixed_top,tables",
    [
        ("sum", 80, 80, "shared"),  # no fixed steps at cap 80
        ("sum", 256, 128, "shared"),  # fixed steps of another cap
        ("sum", 784, 784, "global"),  # fixed steps need shared-memory tables
        ("sum/no-negate", 256, 256, "shared"),  # and the stacked form
        ("hist", 80, 80, "shared"),
        ("hist", 256, 512, "shared"),
        ("hist", 784, 784, "global"),
    ],
)
def test_rank_kernels_refuse_a_search_form_they_lack(kernel, cap, fixed_top, tables):
    """The C entries launch the plan's search form or refuse it: no other
    form takes its place."""
    dev = _cuda()
    rng = np.random.default_rng(cap)
    kernel, _, flag = kernel.partition("/")
    negate = kernel == "sum" and flag != "no-negate"
    q = _rank_queries("columns", rng, 33, 3000, dev)
    t = torch.from_numpy(_tables(rng, 66 if negate else 33, cap, 0, 3)).to(dev)
    if kernel == "sum":
        plan = ustat.rank_sum_plan(q, t, negate=negate)._replace(
            fixed_top=fixed_top, tables=tables)
        with pytest.raises(RuntimeError, match="cudaError"):
            ustat._launch_rank_sum(q, t, negate, plan, torch.zeros(t.shape[0], dtype=torch.int32,
                                                                   device=dev))
    else:
        plan = ustat.rank_hist_plan(q, t)._replace(fixed_top=fixed_top, tables=tables)
        with pytest.raises(RuntimeError, match="cudaError"):
            ustat._launch_rank_hist(q, t, plan, torch.zeros_like(t, dtype=torch.int32))
    torch.cuda.synchronize()


_BINNED_CASES = ["strided-classes", "one-row", "one-bin", "specials", "t1", "empty", "wide-grid",
                 "two-bin", "geometric-grid", "unaligned", "strided-g32-1000", "one-row-2^19",
                 "single-row-specials", "single-row-unaligned", "single-row-wide-grid"]


def _binned_case(case, dev):
    gen = torch.Generator(device=dev).manual_seed(len(case))
    t_count = {"t1": 1, "wide-grid": 70_000, "one-row-2^19": 10_000, "strided-g32-1000": 2048,
               "single-row-wide-grid": 30_000}.get(case, 200)
    th = torch.arange(t_count, dtype=torch.float32, device=dev) / max(t_count - 1, 1)
    if case == "geometric-grid":  # far from uniform: slot_of's binary search
        th = torch.logspace(-6, 0, t_count, device=dev)
    if case in ("strided-classes", "strided-g32-1000"):
        n, c = (4096 + 7, 100) if case == "strided-classes" else (2**15 + 5, 1000)
        s = torch.rand(n, c, device=dev, generator=gen).T
        y = torch.randint(0, c, (n,), device=dev, generator=gen)
        h = y[None, :] == torch.arange(c, device=dev)[:, None]
    elif case in ("unaligned", "single-row-unaligned"):  # scores[:, 1:], N % 4 != 0
        rows = 3 if case == "unaligned" else 1
        s = torch.rand(rows, 100_003, device=dev, generator=gen)[:, 1:]
        h = (torch.rand(rows, 100_003, device=dev, generator=gen) < 0.4)[:, 1:]
    else:
        n = {"empty": 0, "one-row-2^19": 2**19}.get(case, 100_003)
        rows = 1 if case.startswith("single-row") or case == "one-row-2^19" else 2
        s = torch.rand(rows, n, device=dev, generator=gen)
        h = torch.rand(rows, n, device=dev, generator=gen) < 0.4
        if case == "one-bin":
            s.fill_(0.37)
        if case == "two-bin":  # every round's lanes in two slots
            s = torch.where(torch.rand(rows, n, device=dev, generator=gen) < 0.5, 0.37, 0.81)
        if case == "specials":
            s[0, :6] = torch.tensor([float("nan"), float("inf"), -float("inf"), -1.0, 2.0, 0.5])
            s[1, : th.numel()] = th  # scores equal to thresholds
        if case == "single-row-specials":
            s[0, :6] = torch.tensor([float("nan"), float("inf"), -float("inf"), -1.0, 2.0, 0.5])
            s[0, 6 : 6 + th.numel()] = th
    return s, h, th


@pytest.mark.parametrize("case", _BINNED_CASES)
def test_binned_kernel_bitwise_equals_plain(case):
    dev = _cuda()
    s, h, th = _binned_case(case, dev)
    _build.reset_counts()
    got = binned_counts(s, h, th)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["binned_counts"] == (0 if case == "empty" else 1)
    for g, w in zip(got, _binned_counts_plain(s, h, th)):
        assert g.dtype == torch.int32 and torch.equal(g, w)


@pytest.mark.parametrize("smem", [True, False], ids=["shared-table", "l2-table"])
@pytest.mark.parametrize("case", [c for c in _BINNED_CASES if "wide-grid" not in c and c != "empty"])
def test_binned_kernel_plan_variants_bitwise_equal_plain(case, smem):
    # Both homes of the thresholds on the L2 route, the private route where
    # one row allows it, and a vector layout that falls back to scalar
    # loads, give the plain version's bits.
    dev = _cuda()
    s, h, th = _binned_case(case, dev)
    plan = binned.binned_count_plan(s, h, th.numel())
    shared = plan._replace(private=False, smem=smem)
    variants = {shared, shared._replace(vec=False)}
    if s.shape[0] == 1 and binned._private_smem(th.numel()) <= binned._MAX_SMEM:
        variants |= {plan._replace(private=True, smem=True), plan._replace(private=True, vec=False)}
    for p in variants:
        got = binned._launch_binned_count(s, h, th, p)
        torch.cuda.synchronize()
        for g, w in zip(got, _binned_counts_plain(s, h, th)):
            assert torch.equal(g, w), p.describe()


def test_binned_kernel_refuses_a_plan_its_operands_do_not_allow():
    dev = _cuda()
    s, h, th = _binned_case("unaligned", dev)
    plan = binned.binned_count_plan(s, h, th.numel())
    with pytest.raises(RuntimeError, match="cudaError"):
        binned._launch_binned_count(s, h, th, plan._replace(vec=True))
    with pytest.raises(RuntimeError, match="cudaError"):  # three rows: no private route
        binned._launch_binned_count(s, h, th, plan._replace(private=True))
    one = torch.rand(1, 2**20, device=dev)  # a block of 2^20 samples: its counts pass 2^16
    with pytest.raises(RuntimeError, match="cudaError"):
        binned._launch_binned_count(one, one < 0.5, th, binned.binned_count_plan(
            one, one < 0.5, th.numel())._replace(blocks=1))
    torch.cuda.synchronize()


def test_auprc_and_binned_metrics_on_the_card_equal_the_cpu():
    _cuda()
    rng = np.random.default_rng(5)
    s = rng.random((2**15, 200)).astype(np.float32)
    y = rng.integers(0, 200, 2**15).astype(np.int32)
    on_card = MulticlassAUPRC(num_classes=200, average=None)
    on_cpu = MulticlassAUPRC(num_classes=200, average=None, device="cpu")
    for cs, cy in zip(np.split(s, 8), np.split(y, 8)):
        on_card.update(cs, cy)
        on_cpu.update(cs, cy)
    _build.reset_counts()
    got = on_card.compute()
    assert dict(_build.LAUNCHES) == {"rank_hist_counts": 1} and not _build.PLAIN_CALLS
    torch.testing.assert_close(got.cpu(), on_cpu.compute(), rtol=0, atol=1e-6)

    binned = [BinaryBinnedAUROC(threshold=10_000), MulticlassBinnedAUPRC(num_classes=200)]
    binned_cpu = [BinaryBinnedAUROC(threshold=10_000, device="cpu"),
                  MulticlassBinnedAUPRC(num_classes=200, device="cpu")]
    _build.reset_counts()
    for cs, cy in zip(np.split(s, 4), np.split(y, 4)):
        binned[0].update(cs[:, 0], cy % 2)
        binned[1].update(cs, cy, mask=(cy % 3 != 0).astype(np.int32))
    assert dict(_build.LAUNCHES) == {"binned_counts": 8} and not _build.PLAIN_CALLS
    for cs, cy in zip(np.split(s, 4), np.split(y, 4)):
        binned_cpu[0].update(cs[:, 0], cy % 2)
        binned_cpu[1].update(cs, cy, mask=(cy % 3 != 0).astype(np.int32))
    for card, cpu in zip(binned, binned_cpu):
        for name in ("threshold", "num_tp", "num_fp", "num_pos", "num_total"):
            assert torch.equal(getattr(card, name).cpu(), getattr(cpu, name))
        torch.testing.assert_close(card.compute()[0].cpu(), cpu.compute()[0], rtol=0, atol=1e-6)


def test_curves_on_the_card_equal_the_cpu():
    # The ragged curves are cut on the host after one read back.
    dev = _cuda()
    rng = np.random.default_rng(6)
    s = (np.floor(rng.random((5000, 4)) * 200) / 200).astype(np.float32)
    y = rng.integers(0, 4, 5000).astype(np.int32)
    multilabel = (rng.random((5000, 4)) < 0.3).astype(np.int32)

    def metrics(device):
        return (
            BinaryPrecisionRecallCurve(device=device).update(s[:, 0], y % 2),
            MulticlassPrecisionRecallCurve(num_classes=4, device=device).update(s, y),
            MultilabelRecallAtFixedPrecision(
                num_labels=4, min_precision=0.3, device=device
            ).update(s, multilabel),
        )

    for card, cpu in zip(metrics(dev), metrics("cpu")):
        got, want = card.compute(), cpu.compute()
        flat_got = [t for part in got for t in (part if isinstance(part, list) else [part])]
        flat_want = [t for part in want for t in (part if isinstance(part, list) else [part])]
        assert len(flat_got) == len(flat_want)
        for g, w in zip(flat_got, flat_want):
            assert g.device.type == "cuda" and g.shape == w.shape
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=1e-6)


def _mega_members(c, device, thresholds=512):
    from torcheval_tpu_torch import metrics as M

    if c == 0:  # the binary + binned set, 1-D scores
        return {
            "bacc": M.BinaryAccuracy(threshold=0.4, device=device),
            "bf1": M.BinaryF1Score(threshold=0.55, device=device),
            "bcm": M.BinaryConfusionMatrix(threshold=0.6, device=device),
            "auroc": M.BinaryBinnedAUROC(threshold=thresholds, device=device),
        }
    return {
        "acc": M.MulticlassAccuracy(num_classes=c, average="macro", device=device),
        "micro": M.MulticlassAccuracy(device=device),
        "f1": M.MulticlassF1Score(num_classes=c, average="macro", device=device),
        "cm": M.MulticlassConfusionMatrix(num_classes=c, device=device),
        "prec": M.MulticlassPrecision(num_classes=c, average="macro", device=device),
        "rec": M.MulticlassRecall(num_classes=c, average="macro", device=device),
    }


@pytest.mark.parametrize(
    "c,n,slices,masked",
    [
        (7, 1000, None, False),  # small shapes
        (20, 313, 16, True),  # the sliced stream's shapes
        (0, 50_003, 16, True),  # binary + binned, T = 512
        (256, 20_001, 3, False),  # the plan bounds: F = C = 256
    ],
)
def test_mega_kernel_bitwise_equals_plain(monkeypatch, c, n, slices, masked):
    from torcheval_tpu_torch.ops._mega_plan import plan_for
    from torcheval_tpu_torch.ops.mega import _mega_counts_plain, mega_counts

    dev = _cuda()
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "1")
    rng = np.random.default_rng(c + n)
    members = _mega_members(c, dev)
    if c:
        x = rng.standard_normal((n, c)).astype(np.float32)
        x[:3, 1] = np.nan  # torch.argmax's first NaN
        y = rng.integers(-c, 2 * c, n).astype(np.int32)  # wrapped and dropped labels
    else:
        x = rng.random(n).astype(np.float32)
        x[:7] = np.nan  # counted at every threshold
        x[7:20] = 0.55
        y = rng.integers(0, 2, n).astype(np.int32)
    x, y = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
    mask = torch.from_numpy((rng.random(n) < 0.8).astype(np.int32)).to(dev) if masked else None
    sids = (torch.from_numpy(rng.integers(-1, (slices or 1) + 1, n).astype(np.int32)).to(dev)
            if slices else None)
    plan = plan_for(members, (x, y), {} if mask is None else {"mask": mask}, slices)
    thr = [members[mp.name].threshold for mp in plan.members if mp.kind == "binned"]
    _build.reset_counts()
    got = mega_counts(plan, x, y, mask, sids, thr)
    torch.cuda.synchronize()
    want = _mega_counts_plain(plan, x, y, mask, sids, thr)
    assert _build.LAUNCHES["mega_counts"] == 1
    for (gm, gc), (wm, wc) in zip(got, want):
        for g, w in ((gm, wm), (gc, wc)):
            assert (g is None and w is None) or (g.dtype == torch.int32 and torch.equal(g, w))


def _mega_check(plan, x, y, mask, sids, thr, launches=1):
    from torcheval_tpu_torch.ops.mega import _mega_counts_plain, mega_counts

    _build.reset_counts()
    got = mega_counts(plan, x, y, mask, sids, thr)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"mega_counts": launches} and not _build.PLAIN_CALLS
    want = _mega_counts_plain(plan, x, y, mask, sids, thr)
    for (gm, gc), (wm, wc) in zip(got, want):
        for g, w in ((gm, wm), (gc, wc)):
            assert (g is None and w is None) or (g.dtype == torch.int32 and torch.equal(g, w))


@pytest.mark.parametrize("n", [1, 31, 33, 128, 512, 513, 4096, 4097])
def test_mega_kernel_at_the_launch_edges(monkeypatch, n):
    """The sliced stream's shapes (C = 20, 16 slices, a mask) on each side
    of a tile and of the split-counter shape's limit."""
    from torcheval_tpu_torch.ops._mega_plan import plan_for
    from torcheval_tpu_torch.ops.mega import launch_plans

    dev = _cuda()
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "1")
    rng = np.random.default_rng(n)
    members = _mega_members(20, dev)
    x = torch.from_numpy(rng.random((n, 20), dtype=np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(-2, 22, n).astype(np.int32)).to(dev)
    mask = torch.from_numpy((rng.random(n) < 0.8).astype(np.int32)).to(dev)
    sids = torch.from_numpy(rng.integers(-1, 17, n).astype(np.int32)).to(dev)
    plan = plan_for(members, (x, y), {"mask": mask}, 16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"mega_counts n={n}: {[lp.describe() for lp in launch_plans(plan, n, sms)]}")
    _mega_check(plan, x, y, mask, sids, [])


def test_mega_kernel_at_the_collection_update(monkeypatch):
    from torcheval_tpu_torch.ops._mega_plan import plan_for
    from torcheval_tpu_torch.ops.mega import launch_plans

    dev = _cuda()
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "1")
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.random((65536, 100), dtype=np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 100, 65536).astype(np.int32)).to(dev)
    members = {k: v for k, v in _mega_members(100, dev).items() if k != "micro"}
    plan = plan_for(members, (x, y), {}, None)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    (launch,) = launch_plans(plan, 65536, sms)
    print(f"mega_counts (65536, 100): {launch.describe()}")
    assert launch.image and launch.blocks == sms
    _mega_check(plan, x, y, None, None, [])
    # scores not 16-byte aligned: 4-byte copies
    xb = torch.empty(65536 * 100 + 1, device=dev)
    xb[1:].copy_(x.flatten())
    _mega_check(plan, xb[1:].view(65536, 100), y, None, None, [])


@pytest.mark.parametrize("n", [300, 9000])
def test_mega_kernel_past_64_members_launches_twice(monkeypatch, n):
    from torcheval_tpu_torch import metrics as M
    from torcheval_tpu_torch.ops._mega_plan import plan_for

    dev = _cuda()
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "1")
    rng = np.random.default_rng(n)
    members = {f"acc{i}": M.MulticlassAccuracy(num_classes=5, average="macro", device=dev)
               for i in range(70)}
    x = torch.from_numpy(rng.standard_normal((n, 5)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 5, n).astype(np.int32)).to(dev)
    sids = torch.from_numpy(rng.integers(0, 2, n).astype(np.int32)).to(dev)
    plan = plan_for(members, (x, y), {}, 2)
    assert len(plan.members) == 70
    _mega_check(plan, x, y, None, sids, [], launches=2)


def test_fused_collection_on_the_card_equals_the_per_member_path(monkeypatch):
    from torcheval_tpu_torch.metrics import MetricCollection

    dev = _cuda()
    rng = np.random.default_rng(9)
    batches = [
        (rng.random((b, 20), dtype=np.float32), rng.integers(0, 20, b).astype(np.int32),
         rng.integers(0, 16, b).astype(np.int32))
        for b in (77, 160, 313, 96)
    ]

    def run(flag):
        monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", flag)
        col = MetricCollection(_mega_members(20, dev), bucket=True, slices=16)
        _build.reset_counts()
        for x, y, s in batches:
            col.fused_update(x, y, slice_ids=s)
        torch.cuda.synchronize()
        return col, dict(_build.LAUNCHES)

    fused, launches = run("1")
    assert launches == {"mega_counts": len(batches)}
    per_member, launches = run("0")
    assert "mega_counts" not in launches
    a, b = fused.state_dict(), per_member.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].device.type == "cuda" and a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _ragged_ids(rng, n, width, lo, hi, vocab):
    lens = rng.integers(lo, hi + 1, n)
    ids = rng.integers(0, vocab, (n, width)).astype(np.int32)
    ids[np.arange(width)[None, :] >= lens[:, None]] = -1
    return ids


@pytest.mark.parametrize(
    "n,wa,wb,lo,vocab",
    [
        (1024, 256, 256, 0, 10_000),  # the corpus update's widths
        (512, 32, 32, 1, 97),  # short sentences
        (257, 16, 256, 0, 5),  # asymmetric widths
        (257, 256, 16, 0, 5),
        (300, 64, 0, 0, 9),  # a reference of width 0
        (300, 0, 64, 0, 9),
        (1, 24, 24, 24, 3),
        (0, 24, 24, 0, 3),  # no launch
        (16, 2048, 2048, 1500, 30),
        (4, 4096, 4096, 3000, 30),  # shared memory past 48 KB
        (2, 12_000, 9000, 8000, 30),  # the diagonals in a global scratch
    ],
)
def test_edit_distance_kernel_bitwise_equals_plain_and_native(n, wa, wb, lo, vocab):
    from torcheval_tpu_torch.ops.wavefront import (
        _edit_distance_native,
        _edit_distance_plain,
        edit_distance_tokens,
        lens_from_ids,
    )

    dev = _cuda()
    rng = np.random.default_rng(n + wa + wb)
    a = _ragged_ids(rng, n, wa, min(lo, wa), wa, vocab)
    b = _ragged_ids(rng, n, wb, min(lo, wb), wb, vocab)
    if n > 8:
        a[0], b[1] = -1, -1  # an empty hypothesis, an empty reference
        a[2], b[2] = -1, -1  # both empty
        b[3, : min(wa, wb)] = a[3, : min(wa, wb)]  # a shared prefix
    ta, tb = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    _build.reset_counts()
    got = edit_distance_tokens(ta, tb)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["edit_distance_tokens"] == (1 if n else 0) and not _build.PLAIN_CALLS
    la, lb = lens_from_ids(ta), lens_from_ids(tb)
    assert got.dtype == torch.int32 and torch.equal(got, _edit_distance_plain(ta, tb, la, lb))
    np.testing.assert_array_equal(got.cpu().numpy(), _edit_distance_native(a, b, la, lb))
    # Pad values never leak: another garbage past the same lengths.
    noisy_a, noisy_b = a.copy(), b.copy()
    noisy_a[a < 0], noisy_b[b < 0] = 3, -17
    again = edit_distance_tokens(
        torch.from_numpy(noisy_a).to(dev), torch.from_numpy(noisy_b).to(dev), la, lb,
        mask=torch.ones(n, device=dev),
    )
    assert torch.equal(again, got)


def _edge_pairs(rng, la, lb, vocab=5):
    """One batch of pairs of exactly ``la`` and ``lb`` tokens (padded to
    their widths), and their mirror."""
    a = rng.integers(0, vocab, (7, max(la, 1))).astype(np.int32)[:, :la]
    b = rng.integers(0, vocab, (7, max(lb, 1))).astype(np.int32)[:, :lb]
    return a, b


# (la, lb): every strip height R (32 R rows a band) at its edge and one
# past, two and three bands, a lane count that is not a multiple of 32
# rows, and each side far longer than the other.
_WAVE_EDGES = [(31, 40), (32, 32), (33, 90), (63, 64), (64, 70), (65, 65), (127, 300),
               (128, 128), (129, 129), (255, 256), (256, 300), (257, 257), (511, 600),
               (512, 512), (513, 700), (769, 800), (5, 4000), (4000, 5), (1, 3000), (100, 37)]


@pytest.mark.parametrize("la,lb", _WAVE_EDGES)
def test_edit_distance_kernel_at_band_edges(la, lb):
    from torcheval_tpu_torch.ops.wavefront import (
        _edit_distance_native,
        _edit_distance_plain,
        _strip_rows,
        edit_distance_tokens,
    )

    dev = _cuda()
    rng = np.random.default_rng(la * 7919 + lb)
    a, b = _edge_pairs(rng, la, lb)
    b[0, : min(la, lb)] = a[0, : min(la, lb)]  # a shared prefix
    print(f"rows {min(la, lb)}: R = {_strip_rows(min(la, lb))}")
    for x, y in ((a, b), (b, a)):
        tx, ty = torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev)
        _build.reset_counts()
        got = edit_distance_tokens(tx, ty)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["edit_distance_tokens"] == 1
        lx = torch.full((7,), x.shape[1], dtype=torch.int32, device=dev)
        ly = torch.full((7,), y.shape[1], dtype=torch.int32, device=dev)
        np.testing.assert_array_equal(got.cpu().numpy(), _edit_distance_native(x, y, lx, ly))
        if max(la, lb) <= 800:
            assert torch.equal(got, _edit_distance_plain(tx, ty, lx, ly))


def test_edit_distance_kernel_on_a_mixed_batch():
    """Empty, one-token and 4096-token pairs in one launch (the carry
    scratch of the widest pairs beside pairs of no band at all)."""
    from torcheval_tpu_torch.ops.wavefront import _edit_distance_native, edit_distance_tokens

    dev = _cuda()
    rng = np.random.default_rng(4096)
    lens_a = np.array([0, 1, 4096, 0, 1, 4096, 300, 4096, 17, 2], np.int32)
    lens_b = np.array([0, 0, 4096, 4096, 1, 1, 4096, 257, 4096, 4000], np.int32)
    a = rng.integers(0, 30, (10, 4096)).astype(np.int32)
    b = rng.integers(0, 30, (10, 4096)).astype(np.int32)
    a[np.arange(4096)[None, :] >= lens_a[:, None]] = -1
    b[np.arange(4096)[None, :] >= lens_b[:, None]] = -1
    _build.reset_counts()
    got = edit_distance_tokens(torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev))
    torch.cuda.synchronize()
    assert _build.LAUNCHES["edit_distance_tokens"] == 1 and not _build.PLAIN_CALLS
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _edit_distance_native(a, b, lens_a, lens_b))


def test_text_lifecycles_on_the_card_equal_the_cpu_and_the_host_path():
    from torcheval_tpu_torch.metrics import (
        MetricCollection,
        Perplexity,
        WordErrorRate,
        WordInformationLost,
        WordInformationPreserved,
    )
    from torcheval_tpu_torch.metrics.text._tokens import WordInterner, tokenize_pairs

    dev = _cuda()
    rng = np.random.default_rng(31)
    words = [f"w{k}" for k in range(97)]

    def sentence():
        return " ".join(rng.choice(words, rng.integers(1, 21)))

    strings = [([sentence() for _ in range(b)], [sentence() for _ in range(b)])
               for b in (48, 64, 32)]
    interner = WordInterner()
    tokens = [tokenize_pairs(h, r, interner=interner) for h, r in strings]

    def members(device):
        return {"wer": WordErrorRate(device=device), "wip": WordInformationPreserved(device=device),
                "wil": WordInformationLost(device=device)}

    on_card, on_cpu, host = (MetricCollection(members(d)) for d in (dev, "cpu", "cpu"))
    _build.reset_counts()
    for (h, r), (hs, rs) in zip(tokens, strings):
        on_card.update(h, r)
        on_cpu.update(h, r)
        host.update(hs, rs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["edit_distance_tokens"] == 3 * len(tokens)
    for k, v in on_card.state_dict().items():
        assert v.device.type == "cuda"
        assert torch.equal(v.cpu(), on_cpu.state_dict()[k]) and torch.equal(v.cpu(), host.state_dict()[k])
    for k, v in on_card.compute().items():
        assert torch.equal(v.cpu(), on_cpu.compute()[k])

    logits = rng.standard_normal((4, 64, 512)).astype(np.float32)
    target = rng.integers(0, 512, (4, 64)).astype(np.int32)
    target[:, 50:] = -1
    lm = {d: MetricCollection({"ppl": Perplexity(ignore_index=-1, device=d),
                               "wer": WordErrorRate(device=d)}) for d in (dev, "cpu")}
    _build.reset_counts()
    for d, col in lm.items():
        for x, t in zip(np.split(logits, 2), np.split(target, 2)):
            col.update(x, t)
    assert _build.LAUNCHES["edit_distance_tokens"] == 2 and _build.LAUNCHES["token_nll"] == 2
    card_out, cpu_out = lm[dev].compute(), lm["cpu"].compute()
    assert torch.equal(card_out["wer"].cpu(), cpu_out["wer"])
    assert torch.equal(lm[dev]["ppl"].num_total.cpu(), lm["cpu"]["ppl"].num_total)
    np.testing.assert_allclose(float(card_out["ppl"]), float(cpu_out["ppl"]), rtol=1e-5)


def _wcount_case(case, dev):
    """(scores, hits, weights, thresholds) of one weighted-kernel case."""
    gen = torch.Generator(device=dev).manual_seed(len(case))
    t_count = {"t1": 1, "wide-smem": 5000, "hist-only": 10_000, "wide-grid": 60_000,
               "one-slot-long": 2048}.get(case, 200)
    th = torch.arange(t_count, dtype=torch.float32, device=dev) / max(t_count - 1, 1)
    if case == "binary-shard":
        # The binary sharded histogram's rank block: one row of 2^20 at the
        # bisected 16 384-bin grid (histograms in the global scratch).
        th = torch.tensor(_grid_np(16_384), device=dev)
        s = torch.rand(1, 2**20, device=dev, generator=gen)
        h = torch.rand(1, 2**20, device=dev, generator=gen) < 0.5
    elif case == "one-slot-long":
        # 2^26 hits of one row in one slot at a constant weight that f32
        # cannot sum exactly: an f32 histogram would drift past 1e-6.
        s = torch.full((1, 2**26), 0.37, device=dev)
        h = torch.ones(1, 2**26, dtype=torch.bool, device=dev)
    elif case == "strided-classes":
        s = torch.rand(4096 * 3 + 7, 37, device=dev, generator=gen).T
        y = torch.randint(0, 37, (4096 * 3 + 7,), device=dev, generator=gen)
        h = y[None, :] == torch.arange(37, device=dev)[:, None]
    else:
        n = 0 if case == "empty" else 100_003
        s = torch.rand(2, n, device=dev, generator=gen)
        h = torch.rand(2, n, device=dev, generator=gen) < 0.4
        if case == "one-bin":
            s.fill_(0.37)
        if case == "specials":
            s[0, :6] = torch.tensor([float("nan"), float("inf"), -float("inf"), -1.0, 2.0, 0.5])
            s[1, : th.numel()] = th
    w = torch.rand(s.shape[1], device=dev, generator=gen) + 0.5
    if case == "mixed-sign":
        w = (w - 1.0) * 3.0
        w[::7] = 0.0
    if case == "one-slot-long":
        w = torch.full_like(w, 0.1)
    if case in ("range-low-edge", "range-past"):
        # The fixed-point route's range over 100 003 samples: q = 2^(1 + 17
        # - 62) for max|w| in [1, 2); it holds down to 2^21 q = 2^-23 and
        # no further.  The tiny weights score 1.0, so they alone fill the
        # top slot's cells (the random scores stay below 1).
        edge = 2.0**-23 if case == "range-low-edge" else 2.0**-23 * (1 - 2.0**-20)
        w[:50] = edge
        w[50] = 1.5
        s[:, :50] = 1.0
    if case == "range-high-edge":
        # The largest |w| of its quantum: N max|w| just under 2^62 q.
        w = torch.full_like(w, 1.9999999)
    return s, h, w, th


_WCASES = ["strided-classes", "one-row", "one-bin", "specials", "mixed-sign", "t1",
           "empty", "wide-smem", "hist-only", "wide-grid", "binary-shard", "one-slot-long",
           "range-low-edge", "range-high-edge", "range-past"]
# Cases past the fixed-point range: the f64 route.
_F64_CASES = ("range-past",)


@pytest.mark.parametrize("case", _WCASES)
def test_weighted_kernel_within_tolerance_of_plain(case):
    dev = _cuda()
    s, h, w, th = _wcount_case(case, dev)
    _build.reset_counts()
    got = binned_weighted_counts(s, h, w, th)
    torch.cuda.synchronize()
    route = "binned_weighted_counts_f64" if case in _F64_CASES else "binned_weighted_counts"
    assert dict(_build.LAUNCHES) == ({} if case == "empty" else {route: 1})
    want = _binned_weighted_counts_plain(s, h, w, th)
    # 1e-6 of the sum of |w| over the samples that reach each cell.
    scale = _binned_weighted_counts_plain(s, h, w.abs(), th)
    for g, x, a in zip(got, want, scale):
        assert g.dtype == torch.float32 and g.shape == x.shape
        assert bool(((g - x).abs() <= 1e-6 * a).all())


@pytest.mark.parametrize("case", _WCASES)
def test_weighted_kernel_under_unit_weights_equals_the_counts(case):
    dev = _cuda()
    s, h, w, th = _wcount_case(case, dev)
    got = binned_weighted_counts(s, h, torch.ones_like(w), th)
    for g, c in zip(got, binned_counts(s, h, th)):
        assert torch.equal(g, c.to(torch.float32))


@pytest.mark.parametrize("case", ["strided-classes", "one-row", "mixed-sign", "wide-grid",
                                  "range-low-edge", "range-past", "binary-shard"])
def test_weighted_kernel_gives_the_same_bits_twice(case):
    dev = _cuda()
    s, h, w, th = _wcount_case(case, dev)
    first = binned_weighted_counts(s, h, w, th)
    second = binned_weighted_counts(s, h, w, th)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("case", ["one-row", "mixed-sign", "range-low-edge", "range-past",
                                  "zeros", "nonfinite", "t1"])
def test_weight_range_kernel_equals_its_plain_version(case):
    from torcheval_tpu_torch.ops.binned import _weight_range, _weight_range_plain

    dev = _cuda()
    _, _, w, _ = _wcount_case(case if case in _WCASES else "one-row", dev)
    if case == "zeros":
        w = torch.zeros_like(w)
    if case == "nonfinite":
        w[3], w[5] = float("-inf"), float("nan")
    assert str(_weight_range(w)) == str(_weight_range_plain(w))


@pytest.mark.parametrize("bad", [float("inf"), float("nan")])
def test_weighted_kernel_takes_the_f64_route_for_a_nonfinite_weight(bad):
    dev = _cuda()
    s, h, w, th = _wcount_case("one-row", dev)
    w[7] = bad
    _build.reset_counts()
    got = binned_weighted_counts(s, h, w, th)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"binned_weighted_counts_f64": 1}
    want = _binned_weighted_counts_plain(s, h, w, th)
    scale = _binned_weighted_counts_plain(s, h, w.abs(), th)
    for g, x, a in zip(got[:3], want[:3], scale[:3]):
        finite = torch.isfinite(x)
        assert torch.equal(torch.isfinite(g), finite)
        assert bool(((g - x).abs() <= 1e-6 * a)[finite].all())


@pytest.mark.parametrize("weighted", [False, True])
def test_sharded_binary_route_under_skip_value_checks(weighted):
    """0/1 targets: the kernel when the gate reads them; under
    skip_value_checks the scatter (no launch) unless assume_01_targets=True."""
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(3)
    s = torch.rand(2**16, device=dev, generator=gen)
    t = (torch.rand(2**16, device=dev, generator=gen) < 0.3).to(torch.float32)
    w = torch.rand(2**16, device=dev, generator=gen) + 0.5 if weighted else None
    kernel = "binned_weighted_counts" if weighted else "binned_counts"
    mesh = make_mesh()
    _build.reset_counts()
    checked = sharded_auroc_histogram(s, t, mesh, num_bins=1024, weights=w)
    assert dict(_build.LAUNCHES) == {kernel: 1} and not _build.PLAIN_CALLS
    with skip_value_checks():
        _build.reset_counts()
        scattered = sharded_auroc_histogram(s, t, mesh, num_bins=1024, weights=w)
        assert not _build.LAUNCHES and not _build.PLAIN_CALLS
        pinned = sharded_auroc_histogram(s, t, mesh, num_bins=1024, weights=w,
                                         assume_01_targets=True)
        assert dict(_build.LAUNCHES) == {kernel: 1}
    assert torch.equal(pinned, checked)
    assert abs(float(scattered) - float(checked)) <= 1e-6


# --------------------------------------------------- windows and images
def _window_batches(rng, tasks, n, updates, p, dev):
    shape = (tasks, n) if tasks > 1 else (n,)
    return [
        (torch.from_numpy(rng.random(shape, dtype=np.float32)).to(dev),
         torch.from_numpy((rng.random(shape) < p).astype(np.float32)).to(dev))
        for _ in range(updates)
    ]


@pytest.mark.parametrize(
    "tasks,window,n,p,route",
    [(1, 2**16, 2**13, 0.5, "auc_from_sorted"), (4, 2**15, 2**12, 1 / 512, "rank_sum_counts")],
    ids=["balanced-sort", "rare-rank"],
)
def test_windowed_auroc_launches_its_route_once_a_compute(tasks, window, n, p, route):
    from torcheval_tpu_torch.metrics import WindowedBinaryAUROC

    dev = _cuda()
    batches = _window_batches(np.random.default_rng(tasks), tasks, n, 12, p, dev)
    metric = WindowedBinaryAUROC(num_tasks=tasks, max_num_samples=window)
    cpu = WindowedBinaryAUROC(num_tasks=tasks, max_num_samples=window, device="cpu")
    for s, t in batches:
        metric.update(s, t)
        cpu.update(s.cpu(), t.cpu())
    assert torch.equal(metric.inputs.cpu(), cpu.inputs)
    _build.reset_counts()
    got = metric.compute()
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {route: 1} and not _build.PLAIN_CALLS
    # The same exact route on the CPU's plain versions: the same bits.
    assert torch.equal(got.cpu(), cpu.compute())


def _tf32(on):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def test_ssim_and_fid_give_the_same_bits_whatever_the_tf32_settings():
    from torcheval_tpu_torch.metrics import FrechetInceptionDistance, StructuralSimilarity

    dev = _cuda()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.random((4, 3, 128, 128), dtype=np.float32)).to(dev)
    y = (x + 0.05 * torch.randn_like(x)).clamp(0, 1)
    feats = [torch.from_numpy(rng.random((300, 256), dtype=np.float32)).to(dev) for _ in range(4)]
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    results = []
    try:
        for on in (False, True):
            _tf32(on)
            ssim = StructuralSimilarity().update(x, y).compute()
            fid = FrechetInceptionDistance(lambda f: f, feature_dim=256)
            for i, f in enumerate(feats):
                fid.update(f, is_real=i % 2 == 0)
            results.append((ssim, fid.compute()))
            assert torch.backends.cuda.matmul.allow_tf32 is on
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    (ssim_off, fid_off), (ssim_on, fid_on) = results
    assert torch.equal(ssim_off, ssim_on) and torch.equal(fid_off, fid_on)


def test_ssim_in_two_threads_gives_the_single_thread_bits_with_tf32_on():
    """Two threads (as LocalWorld's ranks are) run SSIM at once with TF32
    on globally: one thread's exit from its full-f32 block must not turn
    TF32 back on under the other's convolutions."""
    import threading

    from torcheval_tpu_torch.metrics import StructuralSimilarity

    dev = _cuda()
    rng = np.random.default_rng(4)
    pairs = []
    for _ in range(2):
        x = torch.from_numpy(rng.random((4, 3, 256, 256), dtype=np.float32)).to(dev)
        pairs.append((x, (x + 0.05 * torch.randn_like(x)).clamp(0, 1)))
    want = [StructuralSimilarity().update(x, y).compute() for x, y in pairs]
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    got = [[], []]
    start = threading.Barrier(2)

    def rank(i):
        x, y = pairs[i]
        start.wait()
        for _ in range(20):
            got[i].append(StructuralSimilarity().update(x, y).compute())

    try:
        _tf32(True)
        threads = [threading.Thread(target=rank, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    for i in range(2):
        assert len(got[i]) == 20 and all(torch.equal(v, want[i]) for v in got[i])


# ------------------------------------------- health, checkpoint and retry
def test_health_on_equals_off_on_the_card(monkeypatch, tmp_path):
    """The data-health monitor on a card ``fused_update``: the same states
    bit for bit and the same launches as with it off, and its findings."""
    from torcheval_tpu_torch.metrics import MetricCollection
    from torcheval_tpu_torch.telemetry import events, health

    dev = _cuda()
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "1")
    rng = np.random.default_rng(40)
    batches = [(rng.random((b, 20), dtype=np.float32), rng.integers(0, 20, b).astype(np.int32))
               for b in (4096, 777, 5000)]
    batches[1][0][3, 4] = np.nan
    batches[1][1][:2] = [20, -1]

    def run(on):
        col = MetricCollection(_mega_members(20, dev), bucket=True)
        if on:
            health.enable()
        _build.reset_counts()
        try:
            for x, y in batches:
                col.fused_update(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev))
            torch.cuda.synchronize()
        finally:
            health.disable()
        return col.state_dict(), dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)

    events.clear()
    off, off_launches, _ = run(False)
    on, on_launches, on_plain = run(True)
    assert on_launches == off_launches == {"mega_counts": len(batches)} and not on_plain
    for k in off:
        assert on[k].dtype == off[k].dtype and torch.equal(on[k], off[k]), k
    found = sorted((e.check, e.metric, e.count) for e in events.events("data_health"))
    events.clear()
    assert ("nan", "", 1) in found and ("label_range", "", 1) in found
    assert ("label_range", "cm", 1) in found


def test_checkpoint_round_trip_of_card_states(monkeypatch, tmp_path):
    """A card collection saved after two updates and loaded into a fresh
    card collection finishes bit-equal to the uninterrupted run, and the
    collection kernel launches again after the restore."""
    from torcheval_tpu_torch.metrics import MetricCollection
    from torcheval_tpu_torch.resilience import CheckpointManager

    dev = _cuda()
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "1")
    rng = np.random.default_rng(41)
    batches = [(torch.from_numpy(rng.random((3000, 20), dtype=np.float32)).to(dev),
                torch.from_numpy(rng.integers(0, 20, 3000).astype(np.int32)).to(dev))
               for _ in range(4)]
    whole = MetricCollection(_mega_members(20, dev))
    for x, y in batches:
        whole.fused_update(x, y)
    first = MetricCollection(_mega_members(20, dev))
    for x, y in batches[:2]:
        first.fused_update(x, y)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(first.state_dict(), {"batches_seen": 2})
    ckpt = mgr.load_latest()
    assert all(isinstance(v, np.ndarray) for v in ckpt.state.values())
    resumed = MetricCollection(_mega_members(20, dev))
    resumed.load_state_dict(convert.state_from_jax(ckpt.state))
    _build.reset_counts()
    for x, y in batches[2:]:
        resumed.fused_update(x, y)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"mega_counts": 2}
    a, b = whole.state_dict(), resumed.state_dict()
    for k in a:
        assert b[k].device.type == "cuda" and torch.equal(a[k], b[k]), k


def test_resilient_group_retries_around_the_rank_sum_kernel():
    """``sharded_multiclass_auroc_ustat`` over ``ResilientGroup`` ranks with
    every rank's first collective attempt failing: the fault-free bits and
    one rank_sum_counts launch a rank."""
    from torcheval_tpu_torch.resilience import FaultPlan, ResilientGroup, RetryPolicy

    dev = _cuda()
    rng = np.random.default_rng(42)
    s = torch.from_numpy(rng.random((8192, 64), dtype=np.float32)).to(dev)
    t = torch.from_numpy(rng.integers(0, 64, 8192).astype(np.int32)).to(dev)
    policy = RetryPolicy(max_attempts=3, base_delay=0.001, jitter=0.0)

    def run(wrap):
        _build.reset_counts()
        out = LocalWorld(4).run(lambda g, r: sharded_multiclass_auroc_ustat(
            *shard_batch(make_mesh(group=g), s, t),
            make_mesh(group=ResilientGroup(g, policy) if wrap else g),
            num_classes=64, average=None))
        torch.cuda.synchronize()
        return out, dict(_build.LAUNCHES)

    clean, clean_launches = run(False)
    with FaultPlan([{"site": "collective", "on_attempt": 1, "count": 4}]) as plan:
        retried, launches = run(True)
    assert len(plan.fired) == 4
    assert launches == clean_launches == {"rank_sum_counts": 4}
    for a, b in zip(clean, retried):
        assert torch.equal(a, b)


# ------------------------------------------------------------ the engine
def _five(c, device):
    """The collection workload's five counting members."""
    from torcheval_tpu_torch import metrics as M

    return {
        "acc": M.MulticlassAccuracy(num_classes=c, average="macro", device=device),
        "f1": M.MulticlassF1Score(num_classes=c, average="macro", device=device),
        "prec": M.MulticlassPrecision(num_classes=c, average="macro", device=device),
        "rec": M.MulticlassRecall(num_classes=c, average="macro", device=device),
        "cm": M.MulticlassConfusionMatrix(num_classes=c, device=device),
    }


def _engine_case(case):
    """(members factory, collection kwargs, evaluator kwargs, host batches,
    the kernel a step launches and how often) at phases 44, 45 and 47's
    shapes, cut to a few blocks."""
    from torcheval_tpu_torch import metrics as M

    rng = np.random.default_rng({"scan": 16, "sliced": 23, "cm1000": 3}[case])
    if case == "scan":
        sizes = sorted([160, 96, 224, 130, 313, 200, 256, 77] * 2)
        batches = [(rng.random((b, 100), dtype=np.float32),
                    rng.integers(0, 100, b).astype(np.int32)) for b in sizes]
        return (lambda d: _five(100, d)), {"bucket": True}, {"block_size": 8}, batches, \
            ("mega_counts", 1)
    if case == "sliced":
        sizes = sorted([160, 96, 224, 130, 313, 200, 256, 77] * 3)
        batches = [(rng.random((b, 20), dtype=np.float32),
                    rng.integers(0, 20, b).astype(np.int32),
                    rng.integers(0, 16, b).astype(np.int32)) for b in sizes]
        return (lambda d: _five(20, d)), {"bucket": True, "slices": 16}, {"block_size": 8}, \
            batches, ("mega_counts", 1)
    batches = [(rng.integers(0, 1000, 2**14).astype(np.int32),
                rng.integers(0, 1000, 2**14).astype(np.int32)) for _ in range(8)]

    def cm_f1(d):
        return {"cm": M.MulticlassConfusionMatrix(num_classes=1000, device=d),
                "f1": M.MulticlassF1Score(num_classes=1000, average="macro", device=d)}

    return cm_f1, {}, {"block_size": 4, "bucket": False}, batches, ("confusion_slab", 2)


def _per_batch(col, batches, sliced):
    for b in batches:
        if sliced:
            col.fused_update(*b[:-1], slice_ids=b[-1])
        else:
            col.fused_update(*b)


@pytest.mark.parametrize("case", ["scan", "sliced", "cm1000"])
@pytest.mark.parametrize("on_card", [False, True])
def test_engine_graph_equals_the_per_batch_loop_and_the_eager_loop(case, on_card):
    """Every block one graph replay: the states bit-equal to per-batch
    ``fused_update`` on the card and to the engine's eager loop on the CPU,
    one capture a bucket, and the recorded launches counted a replay."""
    from torcheval_tpu_torch import _stats
    from torcheval_tpu_torch.engine import Evaluator
    from torcheval_tpu_torch.metrics import MetricCollection

    dev = _cuda()
    members, col_kw, ev_kw, batches, (kernel, per_step) = _engine_case(case)
    sliced = "slices" in col_kw
    stream = ([tuple(torch.from_numpy(a).to(dev) for a in b) for b in batches]
              if on_card else batches)
    ref = MetricCollection(members(dev), **col_kw)
    _per_batch(ref, [tuple(torch.from_numpy(a).to(dev) for a in b) for b in batches], sliced)
    cpu = MetricCollection(members("cpu"), **col_kw)
    Evaluator(cpu, **ev_kw).run(batches)
    col = MetricCollection(members(dev), **col_kw)
    ev = Evaluator(col, **ev_kw)
    captures = _stats.trace_count()
    _build.reset_counts()
    ev.run(stream)
    torch.cuda.synchronize()
    block = ev_kw["block_size"]
    assert ev.blocks_dispatched == ev.runner.replays == -(-len(batches) // block)
    assert _stats.trace_count() - captures == ev.runner.captures
    # One eager warm-up step before each capture, then the replays.
    assert dict(_build.LAUNCHES) == {
        kernel: per_step * (ev.runner.captures + block * ev.runner.replays)}
    assert not _build.PLAIN_CALLS
    for k, v in ref.state_dict().items():
        got = col.state_dict()[k]
        assert got.device.type == "cuda" and torch.equal(got, v), k
        assert torch.equal(got.cpu(), cpu.state_dict()[k]), k
    if sliced:
        want, got = ref.compute_slices(), col.compute_slices()
        assert all(torch.equal(got[s][m], want[s][m]) for s in want for m in want[s])


def test_engine_captures_once_a_bucket_and_nothing_after_warmup():
    from torcheval_tpu_torch import aot
    from torcheval_tpu_torch.engine import Evaluator
    from torcheval_tpu_torch.metrics import MetricCollection

    dev = _cuda()
    members, col_kw, ev_kw, batches, _ = _engine_case("scan")
    col = MetricCollection(members(dev), **col_kw)
    ev = Evaluator(col, **ev_kw)
    before = aot.trace_count()
    sweep = aot.warmup(ev, batches[0], max_batch=max(b[0].shape[0] for b in batches))
    assert aot.trace_count() - before == len(sweep) == ev.runner.captures
    assert ev.blocks_dispatched == 0 and all(
        int(v.abs().sum()) == 0 for v in col.state_dict().values())
    before = aot.trace_count()
    _build.reset_counts()
    ev.run(batches)
    torch.cuda.synchronize()
    assert aot.trace_count() == before
    assert dict(_build.LAUNCHES) == {"mega_counts": 8 * ev.blocks_dispatched}
    ref = MetricCollection(members(dev), **col_kw)
    _per_batch(ref, [tuple(torch.from_numpy(a).to(dev) for a in b) for b in batches], False)
    assert all(torch.equal(col.state_dict()[k], v) for k, v in ref.state_dict().items())


def test_engine_donation_keeps_the_state_tensors_across_blocks():
    from torcheval_tpu_torch.engine import Evaluator
    from torcheval_tpu_torch.metrics import MetricCollection

    dev = _cuda()
    members, col_kw, _, batches, _ = _engine_case("scan")
    col = MetricCollection(members(dev), donate=True, **col_kw)
    ev = Evaluator(col, block_size=4, prefetch=False)
    ev.run(batches[:4])
    ptr = col["cm"].confusion_matrix.data_ptr()
    ev.run(batches[4:])
    assert col["cm"].confusion_matrix.data_ptr() == ptr
    plain = MetricCollection(members(dev), **col_kw)
    Evaluator(plain, block_size=4, prefetch=False).run(batches)
    assert all(torch.equal(col.state_dict()[k], v) for k, v in plain.state_dict().items())
    assert plain["cm"].confusion_matrix.data_ptr() != ptr


def test_engine_replays_are_device_launches_of_the_kernel():
    """The profiler sees ``mega.cu`` once a step inside the replays."""
    from torch.profiler import ProfilerActivity, profile

    from torcheval_tpu_torch.engine import Evaluator
    from torcheval_tpu_torch.metrics import MetricCollection

    dev = _cuda()
    members, col_kw, ev_kw, batches, _ = _engine_case("scan")
    col = MetricCollection(members(dev), **col_kw)
    ev = Evaluator(col, **ev_kw)
    ev.run(batches)
    col.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ev.run(batches)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if "mega_kernel" in e.key
            and e.device_type == torch.autograd.DeviceType.CUDA]
    if rows:  # the profiler now and then drops device rows
        assert sum(e.count for e in rows) == len(batches)


def test_engine_failed_capture_raises_and_keeps_the_states():
    """A member that reads the card back inside its update cannot be
    captured: the dispatch raises, the states are as they were, and no
    eager or CPU path ran in its place."""
    from torcheval_tpu_torch.engine import Evaluator
    from torcheval_tpu_torch.metrics import MetricCollection, Sum

    class _Reads(Sum):
        def update(self, input, *, weight=1.0):
            float(input.sum())  # a host read: illegal while capturing
            return super().update(input, weight=weight)

    dev = _cuda()
    col = MetricCollection({"s": _Reads(device=dev)})
    ev = Evaluator(col, block_size=2, bucket=False, prefetch=False)
    _build.reset_counts()
    with pytest.raises(RuntimeError):
        ev.run([np.ones(64, np.float32), np.ones(64, np.float32)])
    assert float(col["s"].weighted_sum) == 0.0 and not _build.PLAIN_CALLS
    ok = MetricCollection({"s": Sum(device=dev)})
    assert float(Evaluator(ok, block_size=2, bucket=False).run(
        [np.ones(64, np.float32)] * 4).result()["s"]) == 256.0


def test_engine_health_reads_back_once_a_block_on_the_card(monkeypatch):
    from torcheval_tpu_torch.engine import Evaluator
    from torcheval_tpu_torch.metrics import MetricCollection
    from torcheval_tpu_torch.telemetry import events as port_events
    from torcheval_tpu_torch.telemetry import health

    dev = _cuda()
    members, col_kw, ev_kw, batches, _ = _engine_case("scan")
    batches = [tuple(a.copy() for a in b) for b in batches]
    batches[5][0][3, 7] = np.nan
    batches[5][0][4, 1] = np.inf
    reads = []
    real = health._to_host
    monkeypatch.setattr(health, "_to_host", lambda t: reads.append(1) or real(t))
    port_events.clear()
    health.enable()
    try:
        col = MetricCollection(members(dev), **col_kw)
        ev = Evaluator(col, **ev_kw).run(batches)
    finally:
        health.disable()
    found = sorted((e.check, e.count, e.source) for e in port_events.events("data_health"))
    assert found == [("inf", 1, "engine_block"), ("nan", 1, "engine_block")]
    assert len(reads) == ev.blocks_dispatched
    off = MetricCollection(members(dev), **col_kw)
    Evaluator(off, **ev_kw).run(batches)
    assert all(torch.equal(col.state_dict()[k], v) for k, v in off.state_dict().items())


# ----------------------------------------------------------- the sketch tier
@pytest.mark.parametrize("masked", [False, True])
def test_rank_counts_kernel_bit_equal_to_both_plain_versions_strided(masked):
    """``rank_counts_rows`` on the card at phase 51's strided multiclass
    layout, reduced: the (N, C) batch read as (C, N) in place, 512 edges,
    ties with the edges, NaN and +-inf: one ``binned_count.cu`` launch,
    bit-equal to ``_rank_counts_bincount`` on the CPU and to the binned
    kernel's plain version on the card."""
    from torcheval_tpu_torch.metrics.functional.classification._sort_scan import class_hits
    from torcheval_tpu_torch.ops import rank_sketch

    dev = _cuda()
    rng = np.random.default_rng(51)
    edges = rank_sketch.uniform_edges(512, dev)
    scores = rng.random((4096, 100)).astype(np.float32)
    scores[:64, 3] = edges.cpu().numpy()[:64]
    scores[5, :4] = [np.nan, np.inf, -np.inf, 1.0]
    target = rng.integers(0, 100, 4096).astype(np.int32)
    mask = (rng.random(4096) < 0.75).astype(np.int32) if masked else None
    s = torch.from_numpy(scores).to(dev)
    hits = class_hits(torch.from_numpy(target).to(dev), 100)
    m = None if mask is None else torch.from_numpy(mask).to(dev)
    _build.reset_counts()
    got = rank_sketch.rank_counts_rows(s.T, hits, edges, mask=m)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"binned_counts": 1} and not _build.PLAIN_CALLS
    cpu = rank_sketch._rank_counts_bincount(
        s.T.cpu(), hits.cpu(), edges.cpu(), mask=None if m is None else m.cpu())
    sv, hv = s.T, hits
    if m is not None:
        sv = torch.where(m.bool()[None, :], sv, float("-inf"))
        hv = hits & m.bool()[None, :]
    card_plain = _binned_counts_plain(sv, hv, edges)
    for g, c, p in zip(got, cpu, card_plain[:3]):
        assert torch.equal(g.cpu(), c) and torch.equal(g, p)
    assert torch.equal(got[3].cpu(), cpu[3])


def test_rank_counts_on_a_cuda_tensor_never_runs_the_plain_version(monkeypatch):
    from torcheval_tpu_torch.metrics import BinaryAUPRC
    from torcheval_tpu_torch.ops import rank_sketch

    dev = _cuda()

    def refuse(*_, **__):
        raise AssertionError("the plain version ran on a CUDA tensor")

    monkeypatch.setattr(rank_sketch, "_rank_counts_bincount", refuse)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random((2048, 20)).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.integers(0, 20, 2048).astype(np.int32)).to(dev)
    _build.reset_counts()
    MulticlassAUROC(num_classes=20, sketch=True, device=dev).update(x, y)
    BinaryAUROC(sketch=True, device=dev).update(x[:, 0], (y % 2).int(), mask=(y > 3).int())
    BinaryAUPRC(sketch=True, device=dev).update(x[:, 1], (y % 2).int())
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"binned_counts": 3} and not _build.PLAIN_CALLS
    with pytest.raises(ValueError, match="CPU tensors only"):
        rank_sketch.rank_counts_rows(x.T, y[None].bool().expand(20, -1),
                                     rank_sketch.uniform_edges(64, dev), route="bincount")


def _sketch_members(d, multiclass=False):
    from torcheval_tpu_torch.metrics import BinaryAccuracy, BinaryAUPRC

    out = {"roc": BinaryAUROC(sketch=True, device=d),
           "prc": BinaryAUPRC(sketch=True, device=d),
           "binned": BinaryBinnedAUROC(threshold=512, device=d),
           "acc": BinaryAccuracy(device=d)}
    if multiclass:
        out["mc"] = MulticlassAUROC(num_classes=100, sketch=True, device=d)
    return out


def test_sketch_members_in_a_collection_launch_mega_not_binned_count():
    """Phase 52, reduced: the sketch-mode binary members plan as
    ``mega.cu``'s binned kind (one launch an update, no ``binned_count.cu``)
    and fold the bits of their standalone updates; a multiclass sketch
    member is declined and launches ``binned_count.cu`` itself."""
    from torcheval_tpu_torch.metrics import MetricCollection

    dev = _cuda()
    rng = np.random.default_rng(52)
    s = torch.from_numpy(rng.random(8192).astype(np.float32)).to(dev)
    y = torch.from_numpy((rng.random(8192) < 0.3).astype(np.int32)).to(dev)
    col = MetricCollection(_sketch_members(dev))
    _build.reset_counts()
    col.fused_update(s, y)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"mega_counts": 1} and not _build.PLAIN_CALLS
    solo = _sketch_members(dev)
    for name, m in solo.items():
        m.update(s, y)
        for k, v in m.state_dict().items():
            assert torch.equal(col[name].state_dict()[k], v), (name, k)
    scores = torch.from_numpy(rng.random((8192, 100)).astype(np.float32)).to(dev)
    labels = torch.from_numpy(rng.integers(0, 100, 8192).astype(np.int32)).to(dev)
    mc = MetricCollection({"mc": MulticlassAUROC(num_classes=100, sketch=True, device=dev),
                           "acc": MulticlassAccuracy(num_classes=100, device=dev)})
    _build.reset_counts()
    mc.fused_update(scores, labels)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["binned_counts"] == 1


@pytest.mark.parametrize("case", ["sketch", "sketch_multiclass", "decayed", "window", "digest"])
def test_monitor_and_sketch_members_graph_replay_equals_eager(case):
    """Phases 52-53, reduced: the engine's graph replays bit-equal to the
    eager per-batch ``fused_update`` loop on the card and to the engine's
    eager loop on the CPU, for sketch members (``binned_count.cu`` inside
    the graph for the declined multiclass one), ``Decayed`` around the
    confusion slab, ``SlidingWindow`` with ``advance()`` between runs (and
    against a fresh metric over the window's epochs and numpy's counts),
    and ``StreamDigest``."""
    from torcheval_tpu_torch.engine import Evaluator
    from torcheval_tpu_torch.metrics import BinaryBinnedAUROC as Binned
    from torcheval_tpu_torch.metrics import MetricCollection
    from torcheval_tpu_torch.monitor import Decayed, SlidingWindow, StreamDigest

    dev = _cuda()
    rng = np.random.default_rng(53)
    if case == "sketch":
        members = _sketch_members
        batches = [(rng.random(n).astype(np.float32),
                    (rng.random(n) < 0.4).astype(np.int32)) for n in (2048, 700, 2048, 31)]
        col_kw, ev_kw = {"bucket": True}, {"block_size": 2}
    elif case == "sketch_multiclass":
        members = lambda d: {"mc": MulticlassAUROC(num_classes=100, sketch=True,  # noqa: E731
                                                   device=d),
                             "acc": MulticlassAccuracy(num_classes=100, average="macro",
                                                       device=d),
                             "cm": MulticlassConfusionMatrix(num_classes=100, device=d)}
        batches = [(rng.random((2048, 100)).astype(np.float32),
                    rng.integers(0, 100, 2048).astype(np.int32)) for _ in range(8)]
        col_kw, ev_kw = {}, {"block_size": 8, "bucket": False}
    elif case == "decayed":
        members = lambda d: {"cm": Decayed(MulticlassConfusionMatrix(  # noqa: E731
            num_classes=1000, device=d), half_life_updates=4)}
        batches = [(rng.integers(0, 1000, 2**14).astype(np.int32),
                    rng.integers(0, 1000, 2**14).astype(np.int32)) for _ in range(8)]
        col_kw, ev_kw = {}, {"block_size": 8, "bucket": False}
    elif case == "window":
        members = lambda d: {"w": SlidingWindow(Binned(threshold=512, device=d),  # noqa: E731
                                                buckets=4)}
        batches = [(rng.random(4096).astype(np.float32),
                    (rng.random(4096) < 0.3).astype(np.int32)) for _ in range(16)]
        col_kw, ev_kw = {}, {"block_size": 4, "bucket": False}
    else:
        members = lambda d: {"lat": StreamDigest(device=d)}  # noqa: E731
        batches = [(rng.lognormal(-4.0, 1.5, n).astype(np.float32),) for n in
                   (300, 1000, 77, 513, 64, 900)]
        col_kw, ev_kw = {"bucket": True}, {"block_size": 2}
    cuda_batches = [tuple(torch.from_numpy(a).to(dev) for a in b) for b in batches]
    cols = [MetricCollection(members(d), **col_kw) for d in (dev, dev, "cpu")]
    eng, ref, cpu = cols
    ev, cpu_ev = Evaluator(eng, **ev_kw), Evaluator(cpu, **ev_kw)
    step = ev_kw["block_size"] * (1 if case == "window" else len(batches))
    for lo in range(0, len(batches), step):
        ev.run(cuda_batches[lo:lo + step])
        cpu_ev.run(batches[lo:lo + step])
        _per_batch(ref, cuda_batches[lo:lo + step], False)
        if case == "window":
            for c in cols:
                c["w"].advance()
    torch.cuda.synchronize()
    assert ev.runner.replays >= 1
    want = ref.state_dict()
    for k, v in want.items():
        assert torch.equal(eng.state_dict()[k], v), k
        assert torch.equal(cpu.state_dict()[k], v.cpu()), k
    if case == "window":
        # The oracle: four epochs through buckets=4, so after the last
        # advance() the window holds epochs 2-4 (batches 4-15).  A fresh
        # metric over them, and numpy's `score >= edge` counts.
        fresh = Binned(threshold=512, device=dev)
        for b in cuda_batches[4:]:
            fresh.update(*b)
        got, oracle = eng["w"].compute(), fresh.compute()
        assert torch.equal(got[0], oracle[0]) and torch.equal(got[1], oracle[1])
        edges = got[1].cpu().numpy()
        np.testing.assert_allclose(edges, np.linspace(0, 1, 512), rtol=0, atol=1e-6)
        x = np.concatenate([b[0] for b in batches[4:]])
        y = np.concatenate([b[1] for b in batches[4:]])
        pos, neg = np.sort(x[y == 1]), np.sort(x[y == 0])
        tp = pos.size - np.searchsorted(pos, edges, side="left")
        fp = neg.size - np.searchsorted(neg, edges, side="left")
        np.testing.assert_array_equal(eng["w"].num_tp.sum(0)[0].cpu().numpy(), tp)
        np.testing.assert_array_equal(eng["w"].num_fp.sum(0)[0].cpu().numpy(), fp)


@pytest.mark.parametrize("case", ["accuracy", "binary_accuracy", "precision", "regression",
                                  "mean"])
def test_engine_captures_members_that_build_scalars(case):
    """A member the collection kernel does not take runs its own update
    inside the engine's graph; an update that builds a scalar on the card
    (a count, a zero, a weight) builds it with a fill, not a host copy, so
    the capture holds and the replays give the per-batch bits."""
    from torcheval_tpu_torch.engine import Evaluator
    from torcheval_tpu_torch.metrics import (
        BinaryAccuracy,
        Mean,
        MeanSquaredError,
        MetricCollection,
        MulticlassPrecision,
        R2Score,
    )

    dev = _cuda()
    rng = np.random.default_rng(60)
    if case in ("accuracy", "precision"):
        cls = MulticlassAccuracy if case == "accuracy" else MulticlassPrecision
        members = lambda d: {"m": cls(device=d)}  # noqa: E731  (micro: one member)
        batches = [(rng.random((512, 10)).astype(np.float32),
                    rng.integers(0, 10, 512).astype(np.int32)) for _ in range(4)]
    elif case == "binary_accuracy":
        members = lambda d: {"m": BinaryAccuracy(device=d)}  # noqa: E731
        batches = [(rng.random(512).astype(np.float32),
                    rng.integers(0, 2, 512).astype(np.int32)) for _ in range(4)]
    elif case == "regression":
        members = lambda d: {"mse": MeanSquaredError(device=d),  # noqa: E731
                             "r2": R2Score(device=d)}
        batches = [(rng.random(512).astype(np.float32),
                    rng.random(512).astype(np.float32)) for _ in range(4)]
    else:
        members = lambda d: {"m": Mean(device=d)}  # noqa: E731
        batches = [(rng.random(512).astype(np.float32),) for _ in range(4)]
    eng, ref = (MetricCollection(members(dev)) for _ in range(2))
    Evaluator(eng, block_size=4, bucket=False).run(
        [tuple(torch.from_numpy(a).to(dev) for a in b) for b in batches])
    for b in batches:
        ref.update(*(torch.from_numpy(a).to(dev) for a in b))
    torch.cuda.synchronize()
    for k, v in ref.state_dict().items():
        assert torch.equal(eng.state_dict()[k], v), k


def _fleet_run(world, make, call):
    """``call(metric, group)`` on every rank of ``LocalWorld(world)`` with
    the counters zeroed first (the ranks' updates counted too)."""
    _build.reset_counts()
    out = LocalWorld(world).run(lambda g, r: call(make(r), g))
    torch.cuda.synchronize()
    return out, dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)


def test_exact_fleet_merge_on_the_card_equals_flat_and_the_cpu():
    """Phase 55 at a small size: tree and ring merges of an exact
    MulticlassAUROC over LocalWorld(4) give the flat sync's bits on every
    rank, with one rank_sum.cu launch at the root, and the CPU's bits."""
    from torcheval_tpu_torch.metrics.toolkit import sync_and_compute
    from torcheval_tpu_torch.parallel import MergePolicy, fleet_merge

    dev = _cuda()
    rng = np.random.default_rng(55)
    s = rng.random((2**15, 200)).astype(np.float32)  # per-class counts <= N / 128
    t = rng.integers(0, 200, 2**15).astype(np.int32)

    def make(device):
        def build(rank):
            lo, hi = rank * 2**13, (rank + 1) * 2**13
            # average=None: the card's macro mean adds in another order.
            return MulticlassAUROC(num_classes=200, average=None, device=device).update(
                torch.from_numpy(s[lo:hi]).to(device), torch.from_numpy(t[lo:hi]).to(device))
        return build

    policy = MergePolicy(level_deadline=30.0)
    flat, launches, plain = _fleet_run(4, make(dev), lambda m, g: sync_and_compute(m, g, "all"))
    assert launches == {"rank_sum_counts": 4} and not plain
    for topology in ("tree", "ring"):
        for dst in (0, 2):
            outs, launches, plain = _fleet_run(4, make(dev), lambda m, g: fleet_merge(
                m, g, topology=topology, dst=dst, recipient="all", policy=policy))
            assert launches == {"rank_sum_counts": 1} and not plain, (topology, dst)
            for o in outs:
                assert not o.partial and torch.equal(o.value.to(dev), flat[0])
    cpu, launches, plain = _fleet_run(4, make("cpu"), lambda m, g: fleet_merge(
        m, g, topology="tree", policy=policy))
    assert plain == {"rank_sum_counts": 1} and not launches
    assert torch.equal(cpu[0].value, flat[0].cpu())


def test_rank_sketch_fleet_merge_on_the_card_equals_the_flat_sketch_sync():
    """Phase 56 at a small size: sketch='rank' tree and ring merges of
    sketch-mode MulticlassAUROC ranks, binned_count.cu on every update,
    bit-equal to the flat rank-sketch sync."""
    from torcheval_tpu_torch.metrics.toolkit import sync_and_compute
    from torcheval_tpu_torch.parallel import MergePolicy, fleet_merge

    dev = _cuda()
    rng = np.random.default_rng(56)
    s = torch.from_numpy(rng.random((8192, 16)).astype(np.float32)).to(dev)
    t = torch.from_numpy(rng.integers(0, 16, 8192).astype(np.int32)).to(dev)

    def make(rank):
        m = MulticlassAUROC(num_classes=16, sketch=True, device=dev)
        for i in (2 * rank, 2 * rank + 1):
            m.update(s[i * 1024:(i + 1) * 1024], t[i * 1024:(i + 1) * 1024])
        return m

    flat, launches, _ = _fleet_run(4, make, lambda m, g: sync_and_compute(
        m, g, "all", sketch="rank"))
    assert launches == {"binned_counts": 8}
    for topology in ("tree", "ring"):
        outs, launches, plain = _fleet_run(4, make, lambda m, g: fleet_merge(
            m, g, topology=topology, sketch="rank", recipient="all",
            policy=MergePolicy(level_deadline=30.0)))
        assert launches == {"binned_counts": 8} and not plain
        assert all(torch.equal(o.value.to(dev), flat[0]) for o in outs), topology


def _text_family_card(dev, seq=12, vocab=9):
    from torcheval_tpu_torch.metrics import (
        MetricCollection,
        Perplexity,
        WordErrorRate,
        WordInformationLost,
        WordInformationPreserved,
    )

    return MetricCollection(
        {"wer": WordErrorRate(device=dev), "wip": WordInformationPreserved(device=dev),
         "wil": WordInformationLost(device=dev), "ppl": Perplexity(ignore_index=-1, device=dev)},
        bucket=True,
    )


def test_text_family_replay_launches_the_wavefront_kernel_inside_the_graph():
    """Phase 63 at a small size: WER + WIP + WIL + Perplexity through the
    engine, one capture a bucket, edit_distance_tokens launched inside
    every replay (one a member a step), the states bit-equal to the
    per-batch loop."""
    from torcheval_tpu_torch import _stats
    from torcheval_tpu_torch.engine import Evaluator

    dev = _cuda()
    rng = np.random.default_rng(63)
    batches = []
    for b in (16, 16, 9, 16, 5, 16, 16, 12):
        x = rng.normal(size=(b, 12, 9)).astype(np.float32)
        t = rng.integers(0, 9, (b, 12)).astype(np.int32)
        t[np.arange(12)[None, :] >= rng.integers(1, 13, b)[:, None]] = -1
        batches.append((torch.from_numpy(x).to(dev), torch.from_numpy(t).to(dev)))
    ref = _text_family_card(dev)
    for b in batches:
        ref.fused_update(*b)
    col = _text_family_card(dev)
    ev = Evaluator(col, block_size=4)
    captures = _stats.trace_count()
    _build.reset_counts()
    ev.run(batches)
    torch.cuda.synchronize()
    assert _stats.trace_count() - captures == ev.runner.captures == 1
    assert ev.runner.replays == 2
    # Three word members and Perplexity a step: the eager warm-up step, then
    # 4 steps a replay.
    assert dict(_build.LAUNCHES) == {"edit_distance_tokens": 3 * (1 + 4 * 2),
                                     "token_nll": 1 + 4 * 2}
    assert not _build.PLAIN_CALLS
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        col.reset()
        ev.run(batches)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages() if "wavefront" in e.key]
    if kernels:  # the profiler's device rows, where the sandbox gives them
        assert sum(e.count for e in kernels) == 3 * 4 * 2
    for k, v in ref.state_dict().items():
        assert torch.equal(col.state_dict()[k], v), k


def test_autotune_race_on_the_card_writes_rows_keeps_states_and_takes_no_plain_version(
        monkeypatch, tmp_path):
    """aot.warmup(autotune=True) on the card: race rows for the collection
    kernel (mega.cu against cm_slab.cu) and the one-hot row height, the
    states as they were, and neither the race nor a decided run sends a
    CUDA tensor to a plain version."""
    from torcheval_tpu_torch import aot
    from torcheval_tpu_torch import routing_autotune as ra
    from torcheval_tpu_torch.metrics import MetricCollection

    dev = _cuda()
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_AUTOTUNE_DIR", str(tmp_path))
    for flag in ("MEGAKERNEL", "CM_ROW_CHUNK", "AUTOTUNE"):
        monkeypatch.delenv("TORCHEVAL_TPU_TORCH_" + flag, raising=False)
    ra.clear()
    try:
        rng = np.random.default_rng(17)
        for c in (200, 32):
            col = MetricCollection({
                "cm": MulticlassConfusionMatrix(num_classes=c, device=dev),
                "f1": MulticlassF1Score(num_classes=c, average="macro", device=dev)})
            p = torch.from_numpy(rng.integers(0, c, 2**15)).to(dev)
            y = torch.from_numpy(rng.integers(0, c, 2**15)).to(dev)
            col.update(p, y)
            before = {k: v.clone() for k, v in col.state_dict().items()}
            _build.reset_counts()
            aot.warmup(col, (p, y), autotune=True)
            torch.cuda.synchronize()
            assert not _build.PLAIN_CALLS and _build.LAUNCHES
            assert all(torch.equal(before[k], v) for k, v in col.state_dict().items())
            _build.reset_counts()
            col.fused_update(p, y)  # decided by the measured pick
            torch.cuda.synchronize()
            assert not _build.PLAIN_CALLS
        rows = ra.store_rows()
        assert {r["decision"] for r in rows} == {"megakernel", "cm_row_chunk"}
        assert all(r["device_kind"] == torch.cuda.get_device_name(0) for r in rows)
        assert os.path.exists(ra.store_path())
    finally:
        ra.disable()
        ra.clear()


def test_serve_on_the_card_launches_the_collection_kernel_once_a_dispatch(monkeypatch):
    """A small multi-tenant serve run on the card: each dispatch is one
    mega.cu launch (no plain version), one bundle serves every group, and
    every tenant's states and results are bit-equal to a solo unsliced
    suite on the card over the same batches."""
    from torcheval_tpu_torch.serve import AdmissionController, EvalService

    dev = _cuda()
    monkeypatch.delenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", raising=False)
    c, rows, tenants, steps = 100, 256, 12, 3
    rng = np.random.default_rng(11)

    def suite():
        return {"acc": MulticlassAccuracy(num_classes=c, average="macro", device=dev),
                "f1": MulticlassF1Score(num_classes=c, average="macro", device=dev)}

    svc = EvalService(group_width=8, admission=AdmissionController(
        global_capacity=1024, per_tenant_capacity=32, deadline_s=30.0))
    names = [f"tenant-{i:02d}" for i in range(tenants)]
    streams = {n: [(torch.from_numpy(rng.random((rows, c), dtype=np.float32)).to(dev),
                    torch.from_numpy(rng.integers(0, c, rows).astype(np.int32)).to(dev))
                   for _ in range(steps)] for n in names}
    for n in names:
        svc.open(n, suite())
    torch.cuda.synchronize()
    _build.reset_counts()
    for step in range(steps):
        for n in names:
            svc.submit(n, *streams[n][step])
        svc.pump()
    torch.cuda.synchronize()
    stats = svc.stats()
    assert stats["counts"]["dispatched"] == tenants * steps and stats["counts"]["shed"] == 0
    assert stats["groups"] == 2 and stats["programs"]["misses"] == 1
    assert dict(_build.LAUNCHES) == {"mega_counts": tenants * steps}
    assert not _build.PLAIN_CALLS
    for n in names:
        solo = suite()
        for batch in streams[n]:
            for m in solo.values():
                m.update(*batch)
        got = svc.results(n)
        for name, m in solo.items():
            assert torch.equal(got[name], m.compute()), (n, name)
        seat = svc._registry.seat_state_dict(svc.session(n))
        for name, m in solo.items():
            for state, value in m.state_dict().items():
                assert torch.equal(seat[f"{name}/{state}"], value), (n, name, state)


def _cluster_run(device, spill_dir, names, batches):
    """Two ServeCluster hosts over a LocalWorld, every batch submitted from
    rank 0 (routed to the other host's tenants), stepped from this thread;
    returns each tenant's owner-local results and seat states, and the
    launch counters of the routed run."""
    from torcheval_tpu_torch.serve import EvalService, ServeCluster

    def suite():
        return {"acc": MulticlassAccuracy(num_classes=20, average="macro", device=device),
                "f1": MulticlassF1Score(num_classes=20, average="macro", device=device)}

    # Warm the kernel before any cluster exists.
    warm = EvalService(group_width=8)
    warm.open("warm", suite())
    warm.submit("warm", *batches[0])
    warm.pump()
    warm.results("warm")
    if device.type == "cuda":
        torch.cuda.synchronize()
    world = LocalWorld(2)
    clusters = [ServeCluster(world.group(r), spill_dir=str(spill_dir), heartbeat_s=0.05,
                             death_timeout_s=60.0, group_width=8) for r in range(2)]
    for name in names:
        for cl in clusters:
            assert cl.open(name, suite).action in ("local", "routed")
    _build.reset_counts()
    for batch in batches:
        for name in names:
            assert clusters[0].submit(name, *batch).action in ("local", "routed")
    owner = {n: clusters[clusters[0].placement.owner_of(n)] for n in names}
    assert {c.rank for c in owner.values()} == {0, 1}
    for _ in range(10_000):
        for cl in clusters:
            cl.step()
        if all(owner[n].service.session(n).batches == len(batches) for n in names):
            break
    if device.type == "cuda":
        torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)
    dispatched = sum(cl.service.stats()["counts"]["dispatched"] for cl in clusters)
    out = {}
    for n in names:
        svc = owner[n].service
        out[n] = (owner[n].results(n).value,
                  svc._registry.seat_state_dict(svc.session(n)))
    return out, counts, dispatched


def test_serve_cluster_on_the_card_launches_mega_on_every_owner_dispatch(monkeypatch, tmp_path):
    """A 2-host cluster with cuda metrics: every owner dispatch (local or
    routed) is one mega.cu launch and never a plain version; each tenant
    is bit-equal to a solo suite on the card, and its states bit-equal
    (its figures within 1e-6) to the same run on the CPU."""
    dev = _cuda()
    monkeypatch.delenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", raising=False)
    rng = np.random.default_rng(17)
    host = [(rng.random((64, 20), dtype=np.float32), rng.integers(0, 20, 64).astype(np.int32))
            for _ in range(2)]
    names = [f"tenant-{i:02d}" for i in range(8)]
    on_card, (launches, plain), dispatched = _cluster_run(
        dev, tmp_path / "card", names, [tuple(torch.from_numpy(a).to(dev) for a in b)
                                        for b in host])
    assert dispatched == len(names) * 2
    assert launches == {"mega_counts": len(names) * 2} and not plain
    on_cpu, _, _ = _cluster_run(torch.device("cpu"), tmp_path / "cpu", names,
                                [tuple(torch.from_numpy(a) for a in b) for b in host])
    for n in names:
        solo = {"acc": MulticlassAccuracy(num_classes=20, average="macro", device=dev),
                "f1": MulticlassF1Score(num_classes=20, average="macro", device=dev)}
        for b in host:
            for m in solo.values():
                m.update(*(torch.from_numpy(a).to(dev) for a in b))
        got, seat = on_card[n]
        want, cpu_seat = on_cpu[n]
        for k, m in solo.items():
            assert got[k].device.type == "cuda" and torch.equal(got[k], m.compute()), (n, k)
            torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-6, atol=0)
        assert seat.keys() == cpu_seat.keys()
        for k in seat:
            assert torch.equal(seat[k].cpu(), cpu_seat[k]), (n, k)


def test_pack_frames_of_cuda_tensors_equals_their_cpu_copies():
    from torcheval_tpu_torch.distributed import pack_frames, unpack_frames
    from torcheval_tpu_torch.serve.cluster import _placed

    dev = _cuda()
    rng = np.random.default_rng(5)
    scores = torch.from_numpy(rng.random((64, 20), dtype=np.float32)).to(dev)
    target = torch.from_numpy(rng.integers(0, 20, 64).astype(np.int32)).to(dev)
    mask = scores[:, 0] > 0.5
    args, kwargs = (scores, target, scores.t()[:, ::2]), {"mask": mask}
    payload = pack_frames(args, kwargs)
    assert payload == pack_frames(tuple(a.cpu() for a in args), {"mask": mask.cpu()})
    (s, t, v), kw = _placed(*unpack_frames(payload), dev)
    assert s.device.type == "cuda" and torch.equal(s, scores) and torch.equal(t, target)
    assert torch.equal(v, scores.t()[:, ::2]) and torch.equal(kw["mask"], mask)


_CAPTURE_FIXTURE = """\
import torch


def scale(x):
    return x * x.sum().item()


def capture(g, x, out):
    with torch.cuda.graph(g):
        out.copy_(scale(x))
"""


@pytest.mark.parametrize("host_read", [True, False])
def test_what_tpu003_flags_in_a_capture_fails_on_the_card(host_read, tmp_path):
    """The premise of the port's TPU003: a ``.item()`` in a function reached
    from a ``torch.cuda.graph`` body is flagged, and its capture fails on
    the card; the twin that keeps the sum on the device is not flagged,
    captures, and replays equal to eager."""
    from torcheval_tpu_torch.analysis._core import analyze_files

    src = _CAPTURE_FIXTURE if host_read else _CAPTURE_FIXTURE.replace(
        "x * x.sum().item()", "x * x.sum()")
    path = tmp_path / "fixture.py"
    path.write_text(src)
    findings = analyze_files([(str(path), "torcheval_tpu_torch/fixture.py")]).all_findings
    want = [("TPU003", 5, "scale")] if host_read else []
    assert [(f.code, f.line, f.scope) for f in findings] == want

    dev = _cuda()
    scope = {}
    exec(compile(src, str(path), "exec"), scope)
    x = torch.arange(1, 9, dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        out.copy_(scope["scale"](x))  # warm-up outside the capture
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize(dev)
    g = torch.cuda.CUDAGraph()
    if host_read:
        with pytest.raises(RuntimeError):
            scope["capture"](g, x, out)
        torch.cuda.synchronize(dev)
        assert float((x * 2).sum()) == 72.0  # the card still works
        return
    scope["capture"](g, x, out)
    for k in (1.0, 3.0):
        x.copy_(torch.arange(1, 9, dtype=torch.float32, device=dev) * k)
        g.replay()
        torch.cuda.synchronize(dev)
        assert torch.equal(out, scope["scale"](x))


# ------------------------------------------- MetricCollection.update's graph
def _suite(case, d):
    """The benchmark cells' suites (``portbench/cells/``), cut to test
    sizes: groups of members, each group a collection, with the batch's
    tensors it takes."""
    from torcheval_tpu_torch import metrics as M

    if case == "imagenet":
        return [(("x", "y"), {
            "top1": M.MulticlassAccuracy(device=d),
            "top5": M.MulticlassAccuracy(k=5, device=d),
            "f1": M.MulticlassF1Score(num_classes=1000, average="macro", device=d),
            "cm": M.MulticlassConfusionMatrix(1000, device=d),
            "auroc": M.MulticlassAUROC(num_classes=1000, device=d),
        })]
    if case == "criteo_epoch":
        return [(("x", "y"), {
            "auroc": M.BinaryAUROC(device=d),
            "ne": M.BinaryNormalizedEntropy(device=d),
            "accuracy": M.BinaryAccuracy(device=d),
        }), (("y",), {"ctr": M.ClickThroughRate(device=d)})]
    return [(("x", "y"), {
        "auroc": M.WindowedBinaryAUROC(max_num_samples=8192, device=d),
        "ne": M.WindowedBinaryNormalizedEntropy(max_num_updates=3, device=d),
        "calibration": M.WindowedWeightedCalibration(max_num_updates=3, device=d),
    }), (("y",), {"ctr": M.WindowedClickThroughRate(max_num_updates=3, device=d)})]


def _suite_batches(case, dev, sizes):
    rng = np.random.default_rng({"imagenet": 61, "criteo_epoch": 62, "criteo_window": 63}[case])
    out = []
    for n in sizes:
        if case == "imagenet":
            x = rng.standard_normal((n, 1000)).astype(np.float32)
            y = rng.integers(0, 1000, n)
        else:
            y = (rng.random(n) < 0.034).astype(np.int64)
            x = (1 / (1 + np.exp(-(rng.standard_normal(n) + 1.19 * y - 3.85)))).astype(np.float32)
        out.append({"x": torch.from_numpy(x).to(dev), "y": torch.from_numpy(y).to(dev)})
    return out


@pytest.mark.parametrize("case", ["imagenet", "criteo_epoch", "criteo_window"])
def test_collection_update_replays_the_members_eager_updates_bit_for_bit(case):
    """``MetricCollection.update`` on the card against each member's own
    ``update`` over a stream whose batch size changes: every state
    bit-equal (the windowed suite's rings and cursors too), one capture a
    signature (graph-eligible members only), and each replay counting its
    ``cm_slab.cu`` launches."""
    from torcheval_tpu_torch import _stats
    from torcheval_tpu_torch.metrics import MetricCollection

    dev = _cuda()
    sizes = (256, 80, 256, 256, 80) if case == "imagenet" else (4096, 1000, 4096, 4096, 1000)
    batches = _suite_batches(case, dev, sizes)
    groups = [(args, MetricCollection(members)) for args, members in _suite(case, dev)]
    solo = [(args, members) for args, members in _suite(case, dev)]
    _stats.reset_member_update_counts()
    _build.reset_counts()
    for b in batches:
        for args, col in groups:
            col.update(*(b[a] for a in args))
    torch.cuda.synchronize()
    counts, launches = _stats.member_update_counts(), dict(_build.LAUNCHES)
    for b in batches:
        for args, members in solo:
            for m in members.values():
                m.update(*(b[a] for a in args))
    for (_, col), (_, members) in zip(groups, solo):
        for name, m in members.items():
            for k, v in m.state_dict().items():
                got = col[name].state_dict()[k]
                if isinstance(v, list):
                    assert len(got) == len(v) and all(torch.equal(a, c) for a, c in zip(got, v))
                else:
                    assert got.device == v.device and got.dtype == v.dtype, (name, k)
                    assert torch.equal(got, v), (name, k)
    for (_, col), (_, members) in zip(groups, solo):
        for name, m in members.items():
            if hasattr(m, "next_inserted"):
                assert (col[name].next_inserted, col[name]._num_valid) == (
                    m.next_inserted, m._num_valid), name
    graphed = sum(len(col._graphed) for _, col in groups)
    members = sum(len(m) for _, m in solo)
    calls = len(batches)
    if case == "criteo_window":
        assert graphed == members
    signatures = len(set(sizes))
    assert all(len(col._graphs._programs) == signatures for _, col in groups if col._graphed)
    want = {"capture": graphed * signatures, "replay": graphed * (calls - signatures),
            "eager": (members - graphed) * calls}
    assert counts == {how: n for how, n in want.items() if n}
    if case == "imagenet":
        # F1 and the matrix each launch the slab a call: once in each
        # capture's eager warm-up, then in every replay.
        assert launches.get("confusion_slab") == 2 * (signatures + calls)


def _no_sync_in_replays(col):
    """From the collection's first graph on, every call of its graphs'
    ``run`` raises on a synchronising call, captures excepted (a capture
    begins with one)."""
    graphs = col._graphs
    if graphs is None or "run" in vars(graphs):
        return
    run, capture = graphs.run, graphs._capture

    def strict_run(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return run(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    def lax_capture(*a, **k):
        torch.cuda.set_sync_debug_mode(0)
        try:
            return capture(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("error")

    graphs.run, graphs._capture = strict_run, lax_capture


def test_collection_graph_replays_the_monitor_rings_over_two_turns_without_a_sync():
    """``criteo.window``'s two collections on the graph path against the
    members' own updates: the AUROC ring of 100 000 samples (not a multiple
    of the 8192-sample batch, so batches wrap mid-batch) and rings of 153
    updates, over two full turns of each, with computes between; states,
    cursors and values bit-equal, one capture a signature, every later
    member update a replay, and no synchronising call inside any replay."""
    from torcheval_tpu_torch import _stats
    from torcheval_tpu_torch import metrics as M
    from torcheval_tpu_torch.metrics import MetricCollection

    dev = _cuda()

    def suite():
        return [(("x", "y"), {
            "auroc": M.WindowedBinaryAUROC(max_num_samples=100_000, device=dev),
            "ne": M.WindowedBinaryNormalizedEntropy(max_num_updates=153, device=dev),
            "calibration": M.WindowedWeightedCalibration(max_num_updates=153, device=dev),
        }), (("y",), {"ctr": M.WindowedClickThroughRate(max_num_updates=153, device=dev)})]

    pool = _suite_batches("criteo_window", dev, [8192] * 16)
    groups = [(args, MetricCollection(members)) for args, members in suite()]
    solo = suite()
    _stats.reset_member_update_counts()
    updates = 2 * 153 + 5
    for i in range(updates):
        b = pool[i % len(pool)]
        for args, col in groups:
            _no_sync_in_replays(col)
            col.update(*(b[a] for a in args))
        for args, members in solo:
            for m in members.values():
                m.update(*(b[a] for a in args))
        if i % 50 == 49 or i == updates - 1:
            for (_, col), (_, members) in zip(groups, solo):
                got = col.compute()
                for name, m in members.items():
                    want = m.compute()
                    pairs = zip(got[name], want) if isinstance(want, tuple) else [
                        (got[name], want)]
                    for g, w in pairs:
                        assert torch.equal(g, w), (i, name)
    assert _stats.member_update_counts() == {"capture": 4, "replay": 4 * (updates - 1)}
    assert all(len(col._graphs._programs) == 1 for _, col in groups)
    for (_, col), (_, members) in zip(groups, solo):
        for name, m in members.items():
            for k, v in m.state_dict().items():
                assert torch.equal(col[name].state_dict()[k].to(v.device), v), (name, k)
    assert groups[0][1]["auroc"].total_samples == updates * 8192 > 2 * 100_000


def test_collection_graph_rings_follow_oversized_batches_resets_loads_and_merges():
    """The rings on the graph path, whose start the graph moves on itself,
    against the members' own updates after each thing that moves a cursor
    on the host alone: an oversized batch (a signature of its own), a
    ``reset``, a ``load_state_dict`` mid-wrap, a ``merge_state`` (rings of
    another width: a program of its own), and a switch back to an older
    program; states, cursors and values bit-equal after each, and no
    synchronising call inside a replay (the cursors' copy included)."""
    from torcheval_tpu_torch import metrics as M
    from torcheval_tpu_torch.metrics import MetricCollection

    dev = _cuda()

    def suite():
        return [(("x", "y"), {
            "auroc": M.WindowedBinaryAUROC(max_num_samples=20_000, device=dev),
            "ne": M.WindowedBinaryNormalizedEntropy(max_num_updates=7, device=dev),
            "calibration": M.WindowedWeightedCalibration(max_num_updates=7, device=dev),
        }), (("y",), {"ctr": M.WindowedClickThroughRate(max_num_updates=7, device=dev)})]

    pool = _suite_batches("criteo_window", dev, [4096] * 8 + [24_576])
    groups = [(args, MetricCollection(members)) for args, members in suite()]
    solo = suite()
    donor = suite()
    step = [0]

    def update(k=1, big=False):
        for _ in range(k):
            b = pool[-1] if big else pool[step[0] % 8]
            step[0] += 1
            for args, col in groups:
                _no_sync_in_replays(col)
                col.update(*(b[a] for a in args))
            # The donor sees the regular batches only: its cursors differ.
            for args, members in solo + ([] if big else donor):
                for m in members.values():
                    m.update(*(b[a] for a in args))

    def same(what):
        for (_, col), (_, members) in zip(groups, solo):
            got = col.compute()
            for name, m in members.items():
                want = m.compute()
                for g, w in (zip(got[name], want) if isinstance(want, tuple) else
                             [(got[name], want)]):
                    assert torch.equal(g, w), (what, name)
                for k, v in m.state_dict().items():
                    assert torch.equal(col[name].state_dict()[k].to(v.device), v), (what, name, k)

    update(5)
    same("wrap")
    update(big=True)
    same("oversized")
    update(3)
    same("after the oversized batch")
    for (_, col), (_, members) in zip(groups, solo):
        col.reset()
        for m in members.values():
            m.reset()
    update(4)
    same("reset")
    for (_, col), (_, members), (_, given) in zip(groups, solo, donor):
        for name, m in members.items():
            snapshot = given[name].state_dict()
            m.load_state_dict(snapshot)
            col[name].load_state_dict(snapshot)
    update(3)
    same("load")
    for (_, col), (_, members), (_, given) in zip(groups, solo, donor):
        for name, m in members.items():
            m.merge_state([given[name]])
            col[name].merge_state([given[name]])
    update(4)
    same("merge")
    for (_, col), (_, members) in zip(groups, solo):
        col.reset()
        for m in members.values():
            m.reset()
    update(9)
    same("back to the first program")


def test_collection_graph_honours_replaced_states_and_never_writes_held_ones():
    """States a caller replaces between calls (``reset``,
    ``load_state_dict``, ``merge_state``) are the ones the next replay adds
    to, and a state tensor a caller holds is never written afterwards."""
    from torcheval_tpu_torch.metrics import MetricCollection

    dev = _cuda()
    batches = _suite_batches("imagenet", dev, (256, 256, 80, 256))
    (args, members), = _suite("imagenet", dev)
    col = MetricCollection({k: v for k, v in members.items() if k != "auroc"})

    def eager_after(steps, start=None):
        (_, ref), = _suite("imagenet", dev)
        ref = MetricCollection({k: v for k, v in ref.items() if k != "auroc"})
        if start is not None:
            ref.load_state_dict(start)
        for b in steps:
            for m in ref._metrics.values():
                m.update(b["x"], b["y"])
        return ref.state_dict()

    def same(want):
        got = col.state_dict()
        assert got.keys() == want.keys()
        assert all(torch.equal(got[k], want[k]) for k in want), [
            k for k in want if not torch.equal(got[k], want[k])]

    held = []

    def hold():
        for m in col._metrics.values():
            for s in m._state_name_to_default:
                t = getattr(m, s)
                held.append((t, t.clone()))

    col.update(batches[0]["x"], batches[0]["y"])
    hold()
    col.update(batches[1]["x"], batches[1]["y"])
    same(eager_after(batches[:2]))
    col.reset()
    hold()
    col.update(batches[2]["x"], batches[2]["y"])
    same(eager_after(batches[2:3]))
    snapshot = eager_after(batches[:1])
    col.load_state_dict(snapshot)
    hold()
    col.update(batches[3]["x"], batches[3]["y"])
    same(eager_after(batches[3:4], start=snapshot))
    other = MetricCollection({k: v for k, v in _suite("imagenet", dev)[0][1].items()
                              if k != "auroc"})
    other.update(batches[1]["x"], batches[1]["y"])
    want = eager_after(batches[3:4], start=snapshot)
    merged = MetricCollection({k: v for k, v in _suite("imagenet", dev)[0][1].items()
                               if k != "auroc"})
    merged.load_state_dict(want)
    merged.merge_state([other])
    col.merge_state([other])
    hold()
    col.update(batches[0]["x"], batches[0]["y"])
    same(eager_after(batches[:1], start=merged.state_dict()))
    hold()
    col.update(batches[0]["x"].t().contiguous().t(), batches[0]["y"])  # strided: eager
    torch.cuda.synchronize()
    for t, was in held:
        assert torch.equal(t, was)


def test_collection_graph_checks_first_and_writes_nothing_on_a_bad_batch():
    """A label past the classes raises top-5's message, as the eager path
    does, and writes no graph-eligible member's state (the eager path has
    written top-1 by then)."""
    from torcheval_tpu_torch import _stats
    from torcheval_tpu_torch.metrics import MetricCollection

    dev = _cuda()
    b, = _suite_batches("imagenet", dev, (256,))
    (_, members), = _suite("imagenet", dev)
    col = MetricCollection(members)
    col.update(b["x"], b["y"])
    before = {k: v.clone() for k, v in col.state_dict().items() if not k.startswith("auroc")}
    bad = b["y"].clone()
    bad[7] = 1000
    counts = _stats.member_update_counts()
    with pytest.raises(ValueError) as on_graph:
        col.update(b["x"], bad)
    (_, eager), = _suite("imagenet", dev)
    with pytest.raises(ValueError) as on_eager:
        for m in eager.values():
            m.update(b["x"], bad)
    assert str(on_graph.value) == str(on_eager.value)
    assert _stats.member_update_counts().get("replay", 0) == counts.get("replay", 0)
    after = col.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())


def test_collection_graph_reads_its_members_checks_back_once():
    """The ImageNet suite on the card: top-5's, F1's and the matrix's range
    checks of one target read back once a call, one stacked vector, where
    the members' own updates read back three times; the states bit-equal;
    a negative label raises the members' own message and writes nothing."""
    from torcheval_tpu_torch import _stats
    from torcheval_tpu_torch.metrics import MetricCollection

    def reads(fn):
        before = _stats.readback_counts()
        fn()
        after = _stats.readback_counts()
        return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}

    dev = _cuda()
    (_, members), = _suite("imagenet", dev)
    (_, solo), = _suite("imagenet", dev)
    col = MetricCollection(members)
    for b in _suite_batches("imagenet", dev, (256, 80, 256, 256)):
        _stats.reset_stacked_check_counts()
        assert reads(lambda: col.update(b["x"], b["y"])) == {"collection_checks": 1}
        assert _stats.stacked_check_counts() == {"requests": 3, "reads": 1}
        assert reads(lambda: [m.update(b["x"], b["y"]) for m in solo.values()]) == {
            "accuracy": 1, "f1_score": 1, "confusion_matrix": 1}
    for name, m in solo.items():
        for k, v in m.state_dict().items():
            got = col[name].state_dict()[k]
            if isinstance(v, list):
                assert len(got) == len(v) and all(torch.equal(a, c) for a, c in zip(got, v))
            else:
                assert got.dtype == v.dtype and torch.equal(got, v), (name, k)
    before = {k: v.clone() for k, v in col.state_dict().items() if not k.startswith("auroc")}
    bad = b["y"].clone()
    bad[11], bad[12] = -1, 999
    with pytest.raises(ValueError) as on_graph:
        col.update(b["x"], bad)
    with pytest.raises(ValueError) as on_solo:
        for m in solo.values():
            m.update(b["x"], bad)
    assert str(on_graph.value) == str(on_solo.value)
    assert str(on_graph.value) == "target values should be in [0, 1000), got min -1 max 999."
    after = col.state_dict()
    assert all(torch.equal(after[k], v) for k, v in before.items())


# ------------------------------------------------------------ token_nll.cu
def _lm_batch(rng, n, seq, vocab, dtype, dev, pad_share=0.02):
    x = torch.from_numpy(rng.standard_normal((n, seq, vocab)).astype(np.float32))
    t = rng.integers(0, vocab, (n, seq))
    t[rng.random((n, seq)) < pad_share] = -100
    return x.to(dev).to(dtype), torch.from_numpy(t).to(dev)


# The kernel sums exp2 of float32 values in its own order where the plain
# version runs torch.logsumexp: a few float32 ulps of log(V) ~ 7-12.
_NLL_TOL = {"rtol": 1e-6, "atol": 2e-5}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16], ids=str)
@pytest.mark.parametrize("shape", [(2, 64, 1000), (3, 17, 50257), (2, 5, 7), (1, 3, 1)])
def test_token_nll_kernel_against_the_plain_version(shape, dtype):
    from torcheval_tpu_torch.ops.token_nll import _token_nll_plain, token_nll

    dev = _cuda()
    rng = np.random.default_rng(sum(shape))
    x, t = _lm_batch(rng, *shape, dtype, dev)
    t[0, 0] = shape[2]  # past the vocabulary: NaN
    _build.reset_counts()
    got = token_nll(x, t)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"token_nll": 1} and not _build.PLAIN_CALLS
    want = _token_nll_plain(x, t)
    torch.testing.assert_close(got, want, equal_nan=True, **_NLL_TOL)
    assert torch.isnan(got[0, 0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_token_nll_kernel_on_strided_and_misaligned_rows(dtype):
    from torcheval_tpu_torch.ops.token_nll import _token_nll_plain, token_nll

    dev = _cuda()
    rng = np.random.default_rng(3)
    wide, t = _lm_batch(rng, 3, 40, 1003, dtype, dev)
    t = t[:, :39]
    views = (wide[:, :39, 1:], wide[:, 1:, 2:1001], wide[:, ::2][:, :20, 3:].repeat(1, 2, 1)[:, :39])
    for x in views[:2]:
        assert x.stride(-1) == 1 and not x.is_contiguous()
    for x in views:
        torch.testing.assert_close(token_nll(x, t), _token_nll_plain(x, t), equal_nan=True,
                                   **_NLL_TOL)
    col = wide.transpose(1, 2)  # (3, 1003, 40), the vocabulary strided: copied, then read
    assert col.stride(-1) != 1
    tc = torch.from_numpy(rng.integers(0, 40, (3, 1003))).to(dev)
    torch.testing.assert_close(token_nll(col, tc), _token_nll_plain(col, tc), **_NLL_TOL)


def test_token_nll_kernel_propagates_non_finite_logits():
    from torcheval_tpu_torch.ops.token_nll import _token_nll_plain, token_nll

    dev = _cuda()
    inf, nan = float("inf"), float("nan")
    rows = torch.randn(8, 3000, device=dev)
    rows[0, 2999] = nan
    rows[1, 1500] = inf
    rows[2] = -inf
    rows[3, ::7] = -inf
    rows[4, 10], rows[4, 2000] = inf, nan
    rows[5, 17] = inf
    rows[6, :2048] = -inf
    rows[6, 2100] = nan  # NaN after a run of -inf only
    rows[7, 1] = -inf
    t = torch.tensor([[0, 0, 0, 5, 1, 17, 2500, 1]], device=dev)
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        x = rows.to(dtype)[None]
        got, want = token_nll(x, t), _token_nll_plain(x, t)
        assert torch.equal(got.isnan(), want.isnan()) and torch.equal(got.isinf(), want.isinf())
        torch.testing.assert_close(got, want, equal_nan=True, **_NLL_TOL)


def test_token_nll_kernel_at_one_row_block_of_the_benchmark():
    """(1, 4096, 129 280) bf16: DeepSeek-V3's vocabulary, one sequence."""
    from torcheval_tpu_torch.ops.token_nll import _token_nll_plain, token_nll

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(25)
    x = torch.randn((1, 4096, 129280), generator=g, device=dev).to(torch.bfloat16)
    t = torch.randint(0, 129280, (1, 4096), generator=g, device=dev)
    torch.testing.assert_close(token_nll(x, t), _token_nll_plain(x, t), **_NLL_TOL)


def test_perplexity_on_the_card_counts_a_launch_an_update_and_equals_the_cpu():
    from torcheval_tpu_torch.metrics import Perplexity

    dev = _cuda()
    rng = np.random.default_rng(17)
    batches = [_lm_batch(rng, 2, 64, 5000, torch.bfloat16, dev) for _ in range(3)]
    card = Perplexity(ignore_index=-100, device=dev)
    _build.reset_counts()
    for x, t in batches:
        card.update(x, t)
    torch.cuda.synchronize()
    assert dict(_build.LAUNCHES) == {"token_nll": 3} and not _build.PLAIN_CALLS
    cpu = Perplexity(ignore_index=-100, device="cpu")
    for x, t in batches:
        cpu.update(x.cpu(), t.cpu())
    assert torch.equal(card.num_total.cpu(), cpu.num_total)
    torch.testing.assert_close(card.sum_log_probs.cpu(), cpu.sum_log_probs, rtol=1e-6, atol=0)


def test_perplexity_update_holds_no_logits_sized_temporary():
    """An update at the benchmark's micro-batch, (2, 4096, 129 280) bf16,
    raises the allocator's peak by under 2 % of the logits' bytes."""
    from torcheval_tpu_torch.metrics import Perplexity

    dev = _cuda()
    g = torch.Generator(device=dev).manual_seed(26)
    x = torch.randn((2, 4096, 129280), generator=g, device=dev, dtype=torch.bfloat16)
    t = torch.randint(0, 129280, (2, 4096), generator=g, device=dev)
    m = Perplexity(ignore_index=-100, device=dev)
    m.update(x[:, :8], t[:, :8])  # the library loaded, the states made
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    _build.reset_counts()
    m.update(x, t)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated(dev) - base
    assert _build.LAUNCHES["token_nll"] == 1
    assert rise < 0.02 * x.numel() * x.element_size(), rise
