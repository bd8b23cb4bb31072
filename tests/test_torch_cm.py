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
from torcheval_tpu_torch.ops.cm import (
    _confusion_slab_plain,
    class_window,
    confusion_slab,
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
