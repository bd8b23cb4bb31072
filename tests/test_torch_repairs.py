"""Three faults of the port, each held against the JAX package on the
smallest input that showed it:

* a PR curve over one distinct score (the reversed thresholds kept a
  negative stride that ``torch.from_numpy`` refused), through every
  caller: the binary, multiclass and multilabel curves (functional and
  class) and both ``recall_at_fixed_precision`` forms;
* ``binary_normalized_entropy`` with a bool target (torch refused
  ``1 - target``), functional and class;
* float64 inputs left float64 states and results; the JAX twins hold
  float32 with x64 off, so the port casts float64 to float32 at the entry
  of ``Mean``, ``Sum``, ``Max``, ``Min``, ``Cat``, functional ``mean`` /
  ``sum`` and the PR curves.

Tolerances: curve points and thresholds exact (they are counts' ratios
and the input scores); normalized entropy within 1e-6 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu import metrics as jm
from torcheval_tpu.metrics import functional as jF
from torcheval_tpu_torch import metrics as tm
from torcheval_tpu_torch.metrics import functional as tF


def _eq(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _curves_eq(got, want):
    for g, w in zip(got, want):
        if isinstance(g, (list, tuple)):
            assert len(g) == len(w)
            for gi, wi in zip(g, w):
                _eq(gi, wi)
        else:
            _eq(g, w)


# ------------------------------------------------ one distinct score


@pytest.mark.parametrize(
    "scores,target",
    [([0.3], [1]), ([0.3, 0.3], [1, 0]), ([0.7, 0.7, 0.7], [0, 0, 0])],
)
def test_binary_curve_with_one_distinct_score(scores, target):
    s, t = np.asarray(scores, np.float32), np.asarray(target, np.int32)
    want = jF.binary_precision_recall_curve(jnp.asarray(s), jnp.asarray(t))
    got = tF.binary_precision_recall_curve(torch.from_numpy(s), torch.from_numpy(t))
    _curves_eq(got, want)
    if scores == [0.3]:
        _curves_eq(got, (np.array([1.0, 1.0], np.float32), np.array([1.0, 0.0], np.float32),
                         np.array([0.3], np.float32)))
    metric = tm.BinaryPrecisionRecallCurve(device="cpu")
    metric.update(torch.from_numpy(s), torch.from_numpy(t))
    _curves_eq(metric.compute(), want)


def test_multiclass_and_multilabel_curves_with_a_tied_class():
    # Class / label 1 has one distinct score.
    s = np.array([[0.2, 0.5, 0.3], [0.6, 0.5, 0.1], [0.1, 0.5, 0.9]], np.float32)
    t = np.array([0, 1, 2], np.int32)
    lab = np.array([[1, 0, 0], [0, 1, 1], [1, 0, 1]], np.int32)
    want = jF.multiclass_precision_recall_curve(jnp.asarray(s), jnp.asarray(t), num_classes=3)
    _curves_eq(tF.multiclass_precision_recall_curve(
        torch.from_numpy(s), torch.from_numpy(t), num_classes=3), want)
    mc = tm.MulticlassPrecisionRecallCurve(num_classes=3, device="cpu")
    _curves_eq(mc.update(torch.from_numpy(s), torch.from_numpy(t)).compute(), want)
    want = jF.multilabel_precision_recall_curve(jnp.asarray(s), jnp.asarray(lab), num_labels=3)
    _curves_eq(tF.multilabel_precision_recall_curve(
        torch.from_numpy(s), torch.from_numpy(lab), num_labels=3), want)
    ml = tm.MultilabelPrecisionRecallCurve(num_labels=3, device="cpu")
    _curves_eq(ml.update(torch.from_numpy(s), torch.from_numpy(lab)).compute(), want)


def test_recall_at_fixed_precision_with_one_distinct_score():
    s, t = np.array([0.3, 0.3], np.float32), np.array([1, 0], np.int32)
    want = jF.binary_recall_at_fixed_precision(jnp.asarray(s), jnp.asarray(t), min_precision=0.4)
    got = tF.binary_recall_at_fixed_precision(
        torch.from_numpy(s), torch.from_numpy(t), min_precision=0.4)
    _curves_eq(got, want)
    s2 = np.array([[0.3, 0.1], [0.3, 0.8]], np.float32)
    lab = np.array([[1, 0], [0, 1]], np.int32)
    want = jF.multilabel_recall_at_fixed_precision(
        jnp.asarray(s2), jnp.asarray(lab), num_labels=2, min_precision=0.5)
    got = tF.multilabel_recall_at_fixed_precision(
        torch.from_numpy(s2), torch.from_numpy(lab), num_labels=2, min_precision=0.5)
    _curves_eq(got, want)


# ----------------------------------------------------- bool NE target


def test_normalized_entropy_with_a_bool_target():
    s, t = np.array([0.2, 0.8], np.float32), np.array([False, True])
    want = float(jF.binary_normalized_entropy(jnp.asarray(s), jnp.asarray(t)))
    np.testing.assert_allclose(want, 0.32192808, rtol=1e-6)
    got = tF.binary_normalized_entropy(torch.from_numpy(s), torch.from_numpy(t))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    metric = tm.BinaryNormalizedEntropy(device="cpu")
    metric.update(torch.from_numpy(s), torch.from_numpy(t))
    jmetric = jm.BinaryNormalizedEntropy().update(jnp.asarray(s), jnp.asarray(t))
    np.testing.assert_allclose(np.asarray(metric.compute()), np.asarray(jmetric.compute()),
                               rtol=1e-6)
    weighted = tF.binary_normalized_entropy(
        torch.from_numpy(s), torch.from_numpy(t), weight=torch.tensor([1.0, 2.0]))
    want_w = jF.binary_normalized_entropy(jnp.asarray(s), jnp.asarray(t),
                                          weight=jnp.asarray([1.0, 2.0]))
    np.testing.assert_allclose(float(weighted), float(want_w), rtol=1e-6)


# --------------------------------------------- float64 in, float32 out

_X64 = np.array([0.25, 1.5, -2.0], np.float64)


def _fed(cls, dtype, **kw):
    metric = cls(device="cpu", **kw)
    metric.update(torch.from_numpy(_X64.astype(dtype)))
    return metric


@pytest.mark.parametrize("cls", [tm.Mean, tm.Sum, tm.Max, tm.Min, tm.Cat])
def test_float64_input_keeps_float32_states(cls):
    f64, f32 = _fed(cls, np.float64), _fed(cls, np.float32)
    jmetric = getattr(jm, cls.__name__)().update(jnp.asarray(_X64.astype(np.float32)))
    for name, value in f64.state_dict().items():
        for v in value if isinstance(value, list) else [value]:
            assert v.dtype == torch.float32, (name, v.dtype)
    assert f64.compute().dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(f64.compute()), np.asarray(jmetric.compute()))
    # An f64-fed state_dict loads into an f32-fed metric and reads the same.
    f32.load_state_dict(f64.state_dict())
    assert f32.compute().dtype == torch.float32
    np.testing.assert_array_equal(f32.compute().numpy(), f64.compute().numpy())
    # A merge of an f32 replica and an f64 one stays f32.
    merged = _fed(cls, np.float32).merge_state([_fed(cls, np.float64)])
    for name, value in merged.state_dict().items():
        for v in value if isinstance(value, list) else [value]:
            assert v.dtype == torch.float32, (name, v.dtype)
    assert merged.compute().dtype == torch.float32


def test_float64_functionals_and_curve_thresholds_are_float32():
    x = torch.from_numpy(_X64)
    w = torch.from_numpy(np.array([1.0, 2.0, 0.5]))
    for fn in (tF.mean, tF.sum):
        assert fn(x).dtype == torch.float32
        assert fn(x, w).dtype == torch.float32
    np.testing.assert_allclose(float(tF.mean(x, w)),
                               float(jF.mean(jnp.asarray(_X64, jnp.float32),
                                             jnp.asarray([1.0, 2.0, 0.5]))), rtol=1e-6)
    s = torch.tensor([0.1, 0.4, 0.4, 0.9], dtype=torch.float64)
    t = torch.tensor([0, 1, 0, 1])
    p, r, th = tF.binary_precision_recall_curve(s, t)
    assert p.dtype == r.dtype == th.dtype == torch.float32
    metric = tm.BinaryPrecisionRecallCurve(device="cpu").update(s, t)
    assert metric.inputs[0].dtype == torch.float32
    assert metric.compute()[2].dtype == torch.float32
    _, _, ths = tF.multiclass_precision_recall_curve(
        torch.rand(6, 3, dtype=torch.float64), torch.tensor([0, 1, 2, 0, 1, 2]), num_classes=3)
    assert all(x.dtype == torch.float32 for x in ths)
