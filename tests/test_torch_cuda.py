"""The port's CUDA kernels on the card: each held bit for bit against its
plain PyTorch version, and a metric on the GPU against the same metric on
the CPU.  A CUDA kernel has no CPU mode, so every test here skips without
a GPU.  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

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
from torcheval_tpu_torch.metrics.functional._host_checks import skip_value_checks
from torcheval_tpu_torch.ops import _build, ustat
from torcheval_tpu_torch.ops.auc import _auc_from_sorted_plain, auc_from_sorted
from torcheval_tpu_torch.ops.binned import (
    _binned_counts_plain,
    _binned_weighted_counts_plain,
    binned_counts,
    binned_weighted_counts,
)
from torcheval_tpu_torch.ops.cm import _confusion_slab_plain, confusion_slab
from torcheval_tpu_torch.parallel import make_mesh, sharded_auroc_histogram
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


@pytest.mark.parametrize(
    "layout,rq,n,cap",
    [
        ("columns", 40, 4096 * 2 + 5, 256),  # 32-row groups, shared-memory tables
        ("rows", 3, 70_000, 512),  # one row per block
        ("columns", 33, 50_000, 4096),  # tables read from global memory
    ],
)
def test_rank_sum_kernel_bitwise_equals_plain(layout, rq, n, cap):
    dev = _cuda()
    rng = np.random.default_rng(rq)
    t = torch.from_numpy(
        np.concatenate([_tables(rng, rq, cap, 0, 3), _tables(rng, rq, cap, 3, 0)])
    ).to(dev)
    q = torch.from_numpy((rng.integers(-9, 9, (n, rq)) / 4).astype(np.float32)).to(dev)
    q = q.T if layout == "columns" else q.T.contiguous()
    _build.reset_counts()
    got = ustat.rank_sum_counts(q, t, negate=True)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["rank_sum_counts"] == 1
    assert torch.equal(got, ustat._rank_sum_counts_plain(q, t, negate=True))


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
    [(2**17, 1000, False), (100_003, 130, False), (2**17, 1000, True), (0, 1000, False), (5, 3, False)],
    ids=["lifecycle-shape", "c130-ragged", "one-cell", "empty", "tiny"],
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
    dev = _cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1024, 32)).astype(np.float32)
    y = rng.integers(0, 8, 1024).astype(np.int32)
    cpu_model = FlagshipMLP(device="cpu")
    card_model = FlagshipMLP(device=dev)
    card_model.load_state_dict(cpu_model.state_dict())
    _build.reset_counts()
    got = eval_step(card_model, x, y)
    assert dict(_build.LAUNCHES) == {"auc_from_sorted": 1} and not _build.PLAIN_CALLS
    want = eval_step(cpu_model, x, y)
    torch.testing.assert_close(got["logits"].cpu(), want["logits"], rtol=0, atol=1e-5)
    assert torch.equal(got["confusion_matrix"].cpu(), want["confusion_matrix"])
    assert float(got["accuracy"]) == float(want["accuracy"])
    assert abs(float(got["auroc"]) - float(want["auroc"])) <= 1e-6


@pytest.mark.parametrize(
    "layout,rows,n,cap",
    [
        ("columns", 37, 4096 * 2 + 5, 256),  # 32-row groups, shared-memory histograms
        ("rows", 3, 70_000, 512),  # one row per block
        ("columns", 33, 50_000, 4096),  # tables and counts in global memory
    ],
)
def test_rank_hist_kernel_bitwise_equals_plain(layout, rows, n, cap):
    dev = _cuda()
    rng = np.random.default_rng(rows + cap)
    t = _tables(rng, rows, cap, 0, cap // 2)
    t[1] = _BIG  # a row without positives: no bin
    q = torch.from_numpy((rng.integers(-9, 9, (n, rows)) / 4).astype(np.float32)).to(dev)
    q = q.T if layout == "columns" else q.T.contiguous()
    t = torch.from_numpy(t).to(dev)
    _build.reset_counts()
    got = ustat.rank_hist_counts(q, t)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["rank_hist_counts"] == 1
    assert torch.equal(got, ustat._rank_hist_counts_plain(q, t))
    assert int(got[1].sum()) == 0


@pytest.mark.parametrize(
    "case", ["strided-classes", "one-row", "one-bin", "specials", "t1", "empty", "wide-grid"]
)
def test_binned_kernel_bitwise_equals_plain(case):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(len(case))
    t_count = {"t1": 1, "wide-grid": 70_000}.get(case, 200)
    th = torch.arange(t_count, dtype=torch.float32, device=dev) / max(t_count - 1, 1)
    if case == "strided-classes":
        s = torch.rand(4096 + 7, 100, device=dev, generator=gen).T
        y = torch.randint(0, 100, (4096 + 7,), device=dev, generator=gen)
        h = y[None, :] == torch.arange(100, device=dev)[:, None]
    else:
        n = 0 if case == "empty" else 100_003
        s = torch.rand(2, n, device=dev, generator=gen)
        h = torch.rand(2, n, device=dev, generator=gen) < 0.4
        if case == "one-bin":
            s.fill_(0.37)
        if case == "specials":
            s[0, :6] = torch.tensor([float("nan"), float("inf"), -float("inf"), -1.0, 2.0, 0.5])
            s[1, : th.numel()] = th  # scores equal to thresholds
    _build.reset_counts()
    got = binned_counts(s, h, th)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["binned_counts"] == (0 if case == "empty" else 1)
    for g, w in zip(got, _binned_counts_plain(s, h, th)):
        assert g.dtype == torch.int32 and torch.equal(g, w)


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
    return s, h, w, th


_WCASES = ["strided-classes", "one-row", "one-bin", "specials", "mixed-sign", "t1",
           "empty", "wide-smem", "hist-only", "wide-grid", "binary-shard", "one-slot-long"]


@pytest.mark.parametrize("case", _WCASES)
def test_weighted_kernel_within_tolerance_of_plain(case):
    dev = _cuda()
    s, h, w, th = _wcount_case(case, dev)
    _build.reset_counts()
    got = binned_weighted_counts(s, h, w, th)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["binned_weighted_counts"] == (0 if case == "empty" else 1)
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


@pytest.mark.parametrize("case", ["strided-classes", "one-row", "mixed-sign", "wide-grid"])
def test_weighted_kernel_gives_the_same_bits_twice(case):
    dev = _cuda()
    s, h, w, th = _wcount_case(case, dev)
    first = binned_weighted_counts(s, h, w, th)
    second = binned_weighted_counts(s, h, w, th)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


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
