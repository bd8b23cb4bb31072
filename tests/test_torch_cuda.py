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
from torcheval_tpu_torch.ops import _build, ustat
from torcheval_tpu_torch.ops.auc import _auc_from_sorted_plain, auc_from_sorted
from torcheval_tpu_torch.ops.binned import _binned_counts_plain, binned_counts
from torcheval_tpu_torch.ops.cm import _confusion_slab_plain, confusion_slab

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
