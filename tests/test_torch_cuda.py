"""The port's CUDA kernels on the card: each held bit for bit against its
plain PyTorch version, and a metric on the GPU against the same metric on
the CPU.  A CUDA kernel has no CPU mode, so every test here skips without
a GPU.  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

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
    assert _build.LAUNCHES["edit_distance_tokens"] == 2
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
