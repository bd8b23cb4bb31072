"""The port's precision, recall and F1 (functional and class) against the
JAX package on the same numpy inputs: the count trios are bit-equal on
every route, the ratios within 1e-6 relative (f32 division and reduction
order may differ).  Zero divisions give 0 with the JAX warnings."""

import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.metrics import (
    BinaryF1Score as JaxBinaryF1,
    BinaryPrecision as JaxBinaryPrecision,
    BinaryRecall as JaxBinaryRecall,
    MulticlassF1Score as JaxMulticlassF1,
    MulticlassPrecision as JaxMulticlassPrecision,
    MulticlassRecall as JaxMulticlassRecall,
)
from torcheval_tpu.metrics import functional as jf
from torcheval_tpu_torch.convert import state_from_jax
from torcheval_tpu_torch.metrics import (
    BinaryF1Score,
    BinaryPrecision,
    BinaryRecall,
    MulticlassF1Score,
    MulticlassPrecision,
    MulticlassRecall,
)
from torcheval_tpu_torch.metrics import functional as tf
from torcheval_tpu_torch.ops import _build

RTOL = 1e-6

MULTICLASS = {
    "precision": (tf.multiclass_precision, jf.multiclass_precision, MulticlassPrecision, JaxMulticlassPrecision),
    "recall": (tf.multiclass_recall, jf.multiclass_recall, MulticlassRecall, JaxMulticlassRecall),
    "f1": (tf.multiclass_f1_score, jf.multiclass_f1_score, MulticlassF1Score, JaxMulticlassF1),
}
BINARY = {
    "precision": (tf.binary_precision, jf.binary_precision, BinaryPrecision, JaxBinaryPrecision),
    "recall": (tf.binary_recall, jf.binary_recall, BinaryRecall, JaxBinaryRecall),
    "f1": (tf.binary_f1_score, jf.binary_f1_score, BinaryF1Score, JaxBinaryF1),
}
AVERAGES = ["micro", "macro", "weighted", None]


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _data(seed, n, c, scores):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, c, n).astype(np.int32)
    y[y == c - 1] = 0  # one class never in the target
    if scores:
        return rng.random((n, c)).astype(np.float32), y
    return rng.integers(0, c - 1, n).astype(np.int32), y  # and never predicted


@pytest.mark.parametrize("metric", sorted(MULTICLASS))
@pytest.mark.parametrize("average", AVERAGES)
@pytest.mark.parametrize(
    "c,n,scores,route",
    [(8, 1024, True, None), (6, 400, False, None), (200, 3000, False, "confusion_slab")],
    ids=["matmul-scores", "matmul-labels", "slab"],
)
def test_multiclass_matches_jax(metric, average, c, n, scores, route):
    fn, jax_fn, _, _ = MULTICLASS[metric]
    s, y = _data(c + n, n, c, scores)
    _build.reset_counts()
    got = fn(*_t(s, y), num_classes=c, average=average)
    if average != "micro":
        assert dict(_build.PLAIN_CALLS) == ({route: 1} if route else {})
    _close(got, jax_fn(*_j(s, y), num_classes=c, average=average))


@pytest.mark.parametrize("metric", sorted(BINARY))
@pytest.mark.parametrize("threshold", [0.5, 0.3])
def test_binary_matches_jax(metric, threshold):
    rng = np.random.default_rng(2)
    s = rng.random(500).astype(np.float32)
    y = (rng.random(500) < 0.4).astype(np.int32)
    fn, jax_fn, _, _ = BINARY[metric]
    _close(fn(*_t(s, y), threshold=threshold), jax_fn(*_j(s, y), threshold=threshold))


@pytest.mark.parametrize(
    "metric,message",
    [
        ("precision", "zero instances in both"),
        ("recall", "no ground-truth instances of [5]"),
        ("f1", "Some classes do not exist in the target"),
    ],
)
def test_zero_division_gives_zero_and_warns(metric, message, caplog):
    fn, jax_fn, _, _ = MULTICLASS[metric]
    s, y = _data(3, 300, 6, False)
    with caplog.at_level(logging.WARNING):
        got = fn(*_t(s, y), num_classes=6, average=None)
    assert message in caplog.text
    assert float(got[5]) == 0.0
    _close(got, jax_fn(*_j(s, y), num_classes=6, average=None))


def test_binary_recall_without_positives_warns(caplog):
    s = np.asarray([0.2, 0.9], np.float32)
    y = np.zeros(2, np.int32)
    with caplog.at_level(logging.WARNING):
        got = tf.binary_recall(*_t(s, y))
    assert "No positive instances" in caplog.text and float(got) == 0.0


@pytest.mark.parametrize("metric", sorted(MULTICLASS))
@pytest.mark.parametrize("average", ["macro", None])
def test_out_of_range_labels_under_skip_value_checks_match_jax(metric, average, monkeypatch):
    monkeypatch.setenv("TORCHEVAL_TPU_SKIP_VALUE_CHECKS", "1")
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_SKIP_VALUE_CHECKS", "1")
    pred = np.asarray([0, 1, -6, 2, 9, -1, 700, -1, 3, 4], np.int32)
    target = np.asarray([0, -7, 1, 2, 3, 3, -800, 5, 3, 4], np.int32)
    fn, jax_fn, _, _ = MULTICLASS[metric]
    _close(fn(*_t(pred, target), num_classes=6, average=average),
           jax_fn(*_j(pred, target), num_classes=6, average=average))


def _lifecycle(port, ref, arrays, mask):
    for i, part in enumerate(zip(*(np.array_split(a, 3) for a in arrays))):
        m = np.array_split(mask, 3)[i] if i == 1 else None
        port.update(*_t(*part), mask=None if m is None else torch.from_numpy(m))
        ref.update(*_j(*part), mask=None if m is None else jnp.asarray(m))
    _close(port.compute(), ref.compute())
    for name in port._state_name_to_default:
        _close(getattr(port, name), getattr(ref, name))


@pytest.mark.parametrize("metric", sorted(MULTICLASS))
@pytest.mark.parametrize("average,c", [("micro", 8), ("macro", 8), (None, 300), ("weighted", 300)])
def test_multiclass_class_matches_jax(metric, average, c):
    _, _, cls, jax_cls = MULTICLASS[metric]
    s, y = _data(c, 900, c, False)
    mask = np.random.default_rng(c).random(900) < 0.6
    kw = dict(num_classes=c, average=average)
    _lifecycle(cls(device="cpu", **kw), jax_cls(**kw), (s, y), mask)


@pytest.mark.parametrize("metric", sorted(BINARY))
def test_binary_class_matches_jax(metric):
    _, _, cls, jax_cls = BINARY[metric]
    rng = np.random.default_rng(4)
    s = rng.random(600).astype(np.float32)
    y = (rng.random(600) < 0.5).astype(np.int32)
    _lifecycle(cls(threshold=0.4, device="cpu"), jax_cls(threshold=0.4), (s, y), rng.random(600) < 0.5)


@pytest.mark.parametrize("metric", sorted(MULTICLASS))
def test_class_merge_reset_state_dict_and_jax_state(metric):
    _, _, cls, jax_cls = MULTICLASS[metric]
    s, y = _data(5, 900, 120, False)
    kw = dict(num_classes=120, average="macro")
    parts = [cls(device="cpu", **kw).update(*_t(a, b)) for a, b in zip(np.array_split(s, 3), np.array_split(y, 3))]
    merged = parts[0].merge_state(parts[1:])
    whole = cls(device="cpu", **kw).update(*_t(s, y))
    assert torch.equal(merged.compute(), whole.compute())
    snapshot = whole.state_dict()
    whole.reset()
    assert all(float(getattr(whole, k).sum()) == 0 for k in snapshot)
    whole.load_state_dict(snapshot)
    assert torch.equal(whole.compute(), merged.compute())
    ref = jax_cls(**kw).update(*_j(s[:400], y[:400]))
    port = cls(device="cpu", **kw)
    port.load_state_dict(state_from_jax({k: np.asarray(v) for k, v in ref.state_dict().items()}))
    port.update(*_t(s[400:], y[400:]))
    ref.update(*_j(s[400:], y[400:]))
    _close(port.compute(), ref.compute())


def test_the_1000_class_lifecycle_matches_jax_at_a_small_n():
    # The confusion workload's shape cut to 2^12 rows a batch: both metrics
    # on the slab route, 8 updates, against the JAX classes.
    rng = np.random.default_rng(3)
    pred = rng.integers(0, 1000, 2**15).astype(np.int32)
    target = rng.integers(0, 1000, 2**15).astype(np.int32)
    from torcheval_tpu.metrics import MulticlassConfusionMatrix as JaxCM
    from torcheval_tpu_torch.metrics import MulticlassConfusionMatrix

    port = (MulticlassConfusionMatrix(1000, device="cpu"), MulticlassF1Score(num_classes=1000, average="macro", device="cpu"))
    ref = (JaxCM(1000), JaxMulticlassF1(num_classes=1000, average="macro"))
    _build.reset_counts()
    for p, t in zip(np.split(pred, 8), np.split(target, 8)):
        for m in port:
            m.update(*_t(p, t))
        for m in ref:
            m.update(*_j(p, t))
    assert dict(_build.PLAIN_CALLS) == {"confusion_slab": 16}
    np.testing.assert_array_equal(port[0].compute().numpy(), np.asarray(ref[0].compute()))
    _close(port[1].compute(), ref[1].compute())


def _messages(fn_jax, fn_port, args, kwargs):
    with pytest.raises(ValueError) as want:
        fn_jax(*_j(*args), **kwargs)
    with pytest.raises(ValueError) as got:
        fn_port(*_t(*args), **kwargs)
    assert str(got.value) == str(want.value)


_F, _I = np.float32, np.int32


@pytest.mark.parametrize("metric", sorted(MULTICLASS))
@pytest.mark.parametrize(
    "args,kwargs",
    [
        ((np.zeros(4, _I), np.zeros(5, _I)), {"num_classes": 3}),
        ((np.zeros(4, _I), np.zeros((4, 2), _I)), {"num_classes": 3}),
        ((np.zeros((4, 2), _F), np.zeros(4, _I)), {"num_classes": 3}),
        ((np.zeros(4, _I), np.zeros(4, _I)), {"num_classes": 3, "average": "samples"}),
        ((np.zeros(4, _I), np.zeros(4, _I)), {"average": "macro"}),
        ((np.asarray([0, 3], _I), np.zeros(2, _I)), {"num_classes": 3, "average": "macro"}),
        ((np.zeros(2, _I), np.asarray([-1, 0], _I)), {"num_classes": 3, "average": None}),
    ],
)
def test_multiclass_errors_match_jax(metric, args, kwargs):
    fn, jax_fn, _, _ = MULTICLASS[metric]
    _messages(jax_fn, fn, args, kwargs)


@pytest.mark.parametrize("metric", sorted(BINARY))
@pytest.mark.parametrize("shapes", [((4,), (3,)), ((2, 2), (2, 2))])
def test_binary_errors_match_jax(metric, shapes):
    fn, jax_fn, _, _ = BINARY[metric]
    _messages(jax_fn, fn, (np.zeros(shapes[0], _F), np.zeros(shapes[1], _I)), {})
