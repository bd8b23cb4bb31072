"""The port's confusion slab (``torcheval_tpu_torch.ops.cm``) against the
JAX package's Pallas kernel run in interpret mode, on the cases of
``tests/ops/test_pallas_cm.py``: counts are integers, so the port's
``(C+1, C+1)`` slab equals the JAX ``(W, W)`` slab's ``[:C+1, :C+1]``
bit for bit (the rest of the JAX slab is its own tile padding)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.ops.pallas_cm import confusion_slab as jax_confusion_slab
from torcheval_tpu_torch.metrics.functional import skip_value_checks
from torcheval_tpu_torch.ops import _build
from torcheval_tpu_torch.ops import cm
from torcheval_tpu_torch.ops.cm import (
    _confusion_slab_plain,
    class_window,
    confusion_slab,
    slab_plan,
)


def _jax_slab(t, p, c):
    got = jax_confusion_slab(jnp.asarray(t), jnp.asarray(p), num_classes=c, interpret=True)
    return np.asarray(got)[: c + 1, : c + 1].astype(np.int32)


def _check(t, p, c):
    _build.reset_counts()
    got = confusion_slab(torch.from_numpy(t), torch.from_numpy(p), num_classes=c)
    assert dict(_build.PLAIN_CALLS) == {"confusion_slab": 1} and not _build.LAUNCHES
    assert got.dtype == torch.int32 and got.shape == (c + 1, c + 1)
    np.testing.assert_array_equal(got.numpy(), _jax_slab(t, p, c))


def _uniform(rng, hi, n):
    return rng.integers(0, hi, n).astype(np.int32)


def _bucket_edges(rng, n):
    t = 64 * rng.integers(0, 15, n) + rng.integers(62, 66, n) % 64
    p = np.where(rng.integers(0, 2, n) == 1, 127, 128)
    return t.astype(np.int32), p.astype(np.int32)


def _mixed(rng, n=8192):
    t = _uniform(rng, 1000, n)
    t[:3000] = 5  # the JAX kernel's overflow tiles, then compact ones
    return t, _uniform(rng, 1000, n)


@pytest.mark.parametrize(
    "case,c,make",
    [
        ("random C=1000 with the sentinel", 1000, lambda r: (_uniform(r, 1001, 5000), _uniform(r, 1001, 5000))),
        ("C=130, the JAX dense window", 130, lambda r: (_uniform(r, 130, 2500), _uniform(r, 130, 2500))),
        ("every sample in one cell", 1000, lambda r: (np.zeros(4096, np.int32), np.full(4096, 7, np.int32))),
        ("mixed skew", 1000, _mixed),
        ("bucket and split edges", 1000, lambda r: _bucket_edges(r, 3000)),
    ],
    ids=["random", "c130", "one-cell", "mixed", "edges"],
)
def test_slab_matches_the_jax_kernel(case, c, make):
    t, p = make(np.random.default_rng(len(case)))
    _check(t, p, c)


@pytest.mark.parametrize("n", [0, 1, 1023, 1024, 1025])
def test_slab_tile_boundaries_and_empty(n):
    rng = np.random.default_rng(n)
    _check(_uniform(rng, 700, n), _uniform(rng, 700, n), 700)


def test_slab_fuzz_shapes_and_skew():
    rng = np.random.default_rng(9)
    for _ in range(4):
        c = int(rng.integers(66, 1150))
        n = int(rng.integers(1, 3000))
        if rng.integers(0, 2):
            t = _uniform(rng, c, n)
        else:  # a few dominant classes
            t = (rng.zipf(1.7, n) % c).astype(np.int32)
        _check(t, _uniform(rng, c + 1, n), c)


def test_class_window_is_labels_plus_the_sentinel():
    assert class_window(1000) == 1001
    assert class_window(2) == 3


def test_unmapped_labels_raise_unless_checks_are_skipped():
    t = torch.tensor([0, 1, 5, -1], dtype=torch.int32)
    p = torch.tensor([0, 9, 1, 2], dtype=torch.int32)
    with pytest.raises(ValueError, match=r"mapped into \[0, 4\]"):
        confusion_slab(t, p, num_classes=4)
    with skip_value_checks():
        got = confusion_slab(t, p, num_classes=4)
    # Pairs with a label outside [0, C] are skipped, as in the kernel.
    want = np.zeros((5, 5), np.int32)
    want[0, 0] = 1
    np.testing.assert_array_equal(got.numpy(), want)


def test_int64_labels_count_the_same():
    rng = np.random.default_rng(3)
    t, p = _uniform(rng, 51, 999), _uniform(rng, 51, 999)
    a = _confusion_slab_plain(torch.from_numpy(t), torch.from_numpy(p), 50)
    b = confusion_slab(torch.from_numpy(t.astype(np.int64)), torch.from_numpy(p.astype(np.int64)), num_classes=50)
    assert torch.equal(a, b)


@pytest.mark.parametrize(
    "t,p,kwargs,exc,match",
    [
        (torch.zeros(3, dtype=torch.int32), torch.zeros(4, dtype=torch.int32), {}, ValueError, "one shape"),
        (torch.zeros(3), torch.zeros(3), {}, TypeError, "integer labels"),
        (torch.zeros(3, dtype=torch.int32), torch.zeros(3, dtype=torch.int32), {"num_classes": 50_000}, ValueError, "int32 cell index"),
    ],
)
def test_bad_arguments_raise(t, p, kwargs, exc, match):
    with pytest.raises(exc, match=match):
        confusion_slab(t, p, **{"num_classes": 4, **kwargs})


def test_non_cuda_devices_are_refused():
    t = torch.zeros(4, dtype=torch.int32, device="meta")
    with skip_value_checks(), pytest.raises(ValueError, match="cuda or cpu"):
        confusion_slab(t, t, num_classes=4)


@pytest.mark.parametrize(
    "t_dtype,p_dtype",
    [(np.int64, np.int64), (np.int32, np.int64), (np.int64, np.int32), (np.int16, np.int32)],
    ids=["int64", "int32-int64", "int64-int32", "int16-int32"],
)
def test_labels_of_either_width_match_the_jax_kernel(t_dtype, p_dtype):
    # The card reads int32 and int64 labels in place (one template each);
    # the CPU's plain version counts the same for every width.
    rng = np.random.default_rng(11)
    t, p = _uniform(rng, 201, 3001), _uniform(rng, 201, 3001)
    t[:500] = 3  # a skew: one cell for a sixth of the pairs
    p[:500] = 4
    _check(t.astype(t_dtype), p.astype(p_dtype), 200)


def test_non_contiguous_labels_match_the_jax_kernel():
    rng = np.random.default_rng(12)
    t, p = _uniform(rng, 101, 4002), _uniform(rng, 101, 4002)
    got = confusion_slab(torch.from_numpy(t)[::2], torch.from_numpy(p.astype(np.int64))[1::2],
                         num_classes=100)
    np.testing.assert_array_equal(got.numpy(), _jax_slab(t[::2], p[1::2], 100))


_SLAB_WARPS, _SLAB_PER = 4, 8  # cm_slab.cu's kWarps, kPer


def test_slab_plan_constants_match_the_kernel_source():
    import re
    from pathlib import Path

    text = (Path(cm.__file__).resolve().parent / "csrc" / "cm_slab.cu").read_text()
    for name, value in (("kWarps", _SLAB_WARPS), ("kPer", _SLAB_PER)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", text).group(1)) == value
    assert (cm._SLAB_WARPS, cm._SLAB_PER_LANE) == (_SLAB_WARPS, _SLAB_PER)


@pytest.mark.parametrize("n", [1, 255, 256, 1000, 4099, 2**17 + 3])
@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("offset", [0, 1])
def test_slab_plan_visits_every_pair_once(n, dtype, offset):
    # cm_slab.cu's schedule: warps grid-stride over tiles of 256 pairs,
    # lane l taking pairs 8l .. 8l + 7 of its tile (16-byte loads when
    # both vectors are aligned, label by label otherwise).
    labels = torch.zeros(n + offset, dtype=dtype)[offset:]
    plan = slab_plan(labels, labels, sms=8)
    assert plan.vec == (labels.data_ptr() % 16 == 0) == (offset == 0)
    assert plan.tiles == -(-n // (32 * _SLAB_PER))
    warps = plan.blocks * _SLAB_WARPS
    assert plan.blocks == max(1, min(-(-plan.tiles // _SLAB_WARPS), 8 * cm._SLAB_BLOCKS_PER_SM))
    tiles = np.concatenate([np.arange(w, plan.tiles, warps) for w in range(warps)])
    q = (tiles[:, None] * 32 * _SLAB_PER + np.arange(32 * _SLAB_PER)).reshape(-1)
    np.testing.assert_array_equal(np.bincount(q[q < n], minlength=n), np.ones(n))


def test_slab_plan_at_the_main_paths_shapes():
    # The CM + F1 update (2^17 pairs) and the C = 100 case of the card's
    # smoke run: one slab in L2, a tile a warp, 16-byte loads where aligned.
    labels = torch.zeros(2**17, dtype=torch.int32)
    plan = slab_plan(labels, labels)
    assert plan == cm.SlabPlan(True, 512, 128)
    assert slab_plan(labels.long(), labels[1:]).vec is False
    assert cm._slab_plan(2**22, True, 132).blocks == 132 * cm._SLAB_BLOCKS_PER_SM
    assert "16-byte label loads, 512 warp tiles, 128 blocks" in plan.describe()
