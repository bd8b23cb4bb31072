"""The port's CUDA kernels on the card: each held bit for bit against its
plain PyTorch version, and a metric on the GPU against the same metric on
the CPU.  A CUDA kernel has no CPU mode, so every test here skips without
a GPU.  This file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from torcheval_tpu_torch.metrics import BinaryAUROC, MulticlassAUROC
from torcheval_tpu_torch.ops import _build, ustat
from torcheval_tpu_torch.ops.auc import _auc_from_sorted_plain, auc_from_sorted

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
