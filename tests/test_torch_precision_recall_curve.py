"""Exact precision-recall curves and recall at fixed precision against
the JAX package: thresholds bit-equal, precision and recall within 1e-6,
functional and class metrics, with merge, checkpoints, a JAX state
carried into the port and the error messages."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as jm
import torcheval_tpu.metrics.functional as jf
import torcheval_tpu_torch.metrics as pm
import torcheval_tpu_torch.metrics.functional as pf
from torcheval_tpu_torch.convert import state_from_jax

CPU = "cpu"


def _same_curves(got, want):
    """Curves: the last element of each triple is the thresholds
    (bit-equal), the others within 1e-6; lists compare item by item."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, (list, tuple)):
            _same_curves(g, w)
        else:
            g, w = np.asarray(g), np.asarray(w)
            assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6)


def _binary(seed, n=300):
    rng = np.random.default_rng(seed)
    return (np.floor(rng.random(n) * 40) / 40).astype(np.float32), (rng.random(n) < 0.4).astype(np.int32)


def test_binary_curve_matches_jax():
    s, y = _binary(1)
    got = pf.binary_precision_recall_curve(torch.from_numpy(s), torch.from_numpy(y))
    want = jf.binary_precision_recall_curve(jnp.asarray(s), jnp.asarray(y))
    _same_curves(got, want)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    # no positives: recall NaN → 1.0, as JAX
    _same_curves(pf.binary_precision_recall_curve(torch.from_numpy(s), torch.zeros(300)),
                 jf.binary_precision_recall_curve(jnp.asarray(s), jnp.zeros(300)))
    _same_curves(pf.binary_precision_recall_curve(torch.zeros(0), torch.zeros(0)),
                 jf.binary_precision_recall_curve(jnp.zeros(0), jnp.zeros(0)))


@pytest.mark.parametrize("kind", ["multiclass", "multilabel"])
def test_row_curves_match_jax(kind):
    rng = np.random.default_rng(2)
    s = (np.floor(rng.random((250, 4)) * 30) / 30).astype(np.float32)
    if kind == "multiclass":
        y = rng.integers(0, 4, 250).astype(np.int32)
        y[y == 3] = 0  # a class without samples
        got = pf.multiclass_precision_recall_curve(torch.from_numpy(s), torch.from_numpy(y), num_classes=4)
        want = jf.multiclass_precision_recall_curve(jnp.asarray(s), jnp.asarray(y), num_classes=4)
    else:
        y = (rng.random((250, 4)) < 0.3).astype(np.int32)
        got = pf.multilabel_precision_recall_curve(torch.from_numpy(s), torch.from_numpy(y))
        want = jf.multilabel_precision_recall_curve(jnp.asarray(s), jnp.asarray(y))
    _same_curves(got, want)


@pytest.mark.parametrize("min_precision", [0.0, 0.5, 0.9, 1.0])
def test_recall_at_fixed_precision_matches_jax(min_precision):
    s, y = _binary(3)
    got = pf.binary_recall_at_fixed_precision(torch.from_numpy(s), torch.from_numpy(y),
                                              min_precision=min_precision)
    want = jf.binary_recall_at_fixed_precision(jnp.asarray(s), jnp.asarray(y),
                                               min_precision=min_precision)
    _same_curves(got, want)
    rng = np.random.default_rng(4)
    sm = rng.random((200, 3)).astype(np.float32)
    ym = (rng.random((200, 3)) < 0.3).astype(np.int32)
    ym[:, 2] = 0  # a label without positives
    got = pf.multilabel_recall_at_fixed_precision(torch.from_numpy(sm), torch.from_numpy(ym),
                                                  num_labels=3, min_precision=min_precision)
    want = jf.multilabel_recall_at_fixed_precision(jnp.asarray(sm), jnp.asarray(ym),
                                                   num_labels=3, min_precision=min_precision)
    _same_curves(got, want)


def _numpy_state(jax_metric):
    return {k: [np.asarray(a) for a in v] for k, v in jax_metric.state_dict().items()}


def _class_pair(kind):
    if kind == "binary_curve":
        return pm.BinaryPrecisionRecallCurve(device=CPU), jm.BinaryPrecisionRecallCurve(), (120,)
    if kind == "multiclass_curve":
        return (pm.MulticlassPrecisionRecallCurve(num_classes=3, device=CPU),
                jm.MulticlassPrecisionRecallCurve(num_classes=3), (120, 3))
    if kind == "multilabel_curve":
        return (pm.MultilabelPrecisionRecallCurve(num_labels=3, device=CPU),
                jm.MultilabelPrecisionRecallCurve(num_labels=3), (120, 3))
    if kind == "binary_rafp":
        return (pm.BinaryRecallAtFixedPrecision(min_precision=0.6, device=CPU),
                jm.BinaryRecallAtFixedPrecision(min_precision=0.6), (120,))
    return (pm.MultilabelRecallAtFixedPrecision(num_labels=3, min_precision=0.6, device=CPU),
            jm.MultilabelRecallAtFixedPrecision(num_labels=3, min_precision=0.6), (120, 3))


@pytest.mark.parametrize(
    "kind", ["binary_curve", "multiclass_curve", "multilabel_curve", "binary_rafp", "multilabel_rafp"]
)
def test_classes_match_jax(kind):
    port, ref, shape = _class_pair(kind)
    empty = port.compute()
    assert len(empty) == len(ref.compute())
    rng = np.random.default_rng(len(kind))
    for _ in range(3):
        s = (np.floor(rng.random(shape) * 25) / 25).astype(np.float32)
        y = (rng.integers(0, 3, shape[0]) if kind == "multiclass_curve"
             else rng.random(shape) < 0.4).astype(np.int32)
        port.update(s, y)
        ref.update(jnp.asarray(s), jnp.asarray(y))
    want = ref.compute()
    _same_curves(port.compute(), want)

    twin = _class_pair(kind)[0]
    twin.load_state_dict(state_from_jax(_numpy_state(ref)))
    _same_curves(twin.compute(), want)
    a, b = _class_pair(kind)[0], _class_pair(kind)[0]
    a.update(torch.cat(port.inputs[:1]), torch.cat(port.targets[:1]))
    b.update(torch.cat(port.inputs[1:]), torch.cat(port.targets[1:]))
    b._prepare_for_merge_state()
    _same_curves(a.merge_state([b]).compute(), want)
    port.reset()
    assert port.inputs == []


@pytest.mark.parametrize(
    "call,message",
    [
        (lambda: pf.binary_precision_recall_curve(torch.zeros(3, 2), torch.zeros(3, 2)),
         "input should be a one-dimensional tensor, got shape (3, 2)."),
        (lambda: pf.binary_precision_recall_curve(torch.zeros(3), torch.zeros(4)),
         "The `input` and `target` should have the same shape, got shapes (3,) and (4,)."),
        (lambda: pf.multiclass_precision_recall_curve(torch.zeros(3, 2), torch.zeros(3),
                                                      num_classes=4),
         "input should have shape of (num_sample, num_classes), got (3, 2) and num_classes=4."),
        (lambda: pf.multilabel_precision_recall_curve(torch.zeros(3, 2), torch.zeros(3, 3)),
         "Expected both input.shape and target.shape to have the same shape"),
        (lambda: pf.binary_recall_at_fixed_precision(torch.zeros(3), torch.zeros(3),
                                                     min_precision=1),
         "Expected min_precision to be a float in the [0, 1] range, but got 1."),
        (lambda: pm.BinaryRecallAtFixedPrecision(min_precision=1.5, device=CPU),
         "Expected min_precision to be a float in the [0, 1] range, but got 1.5."),
    ],
)
def test_error_messages(call, message):
    with pytest.raises(ValueError) as err:
        call()
    assert str(err.value).startswith(message)
