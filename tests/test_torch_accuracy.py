"""The port's accuracy family (functional and class) against the JAX
package on the same numpy inputs: counts bit-equal, ratios within 1e-6
relative (f32 division and reduction order may differ)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.metrics import (
    BinaryAccuracy as JaxBinaryAccuracy,
    MulticlassAccuracy as JaxMulticlassAccuracy,
    MultilabelAccuracy as JaxMultilabelAccuracy,
    TopKMultilabelAccuracy as JaxTopKMultilabelAccuracy,
)
from torcheval_tpu.metrics.functional import (
    binary_accuracy as jax_binary_accuracy,
    multiclass_accuracy as jax_multiclass_accuracy,
    multilabel_accuracy as jax_multilabel_accuracy,
    topk_multilabel_accuracy as jax_topk_multilabel_accuracy,
)
from torcheval_tpu_torch.convert import state_from_jax
from torcheval_tpu_torch.metrics import (
    BinaryAccuracy,
    MulticlassAccuracy,
    MultilabelAccuracy,
    TopKMultilabelAccuracy,
)
from torcheval_tpu_torch.metrics.functional import (
    binary_accuracy,
    multiclass_accuracy,
    multilabel_accuracy,
    topk_multilabel_accuracy,
)

RTOL = 1e-6
CRITERIA = ["exact_match", "hamming", "overlap", "contain", "belong"]


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, equal_nan=True)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _multiclass(seed, n=600, c=7):
    rng = np.random.default_rng(seed)
    return rng.random((n, c)).astype(np.float32), rng.integers(0, c, n).astype(np.int32)


@pytest.mark.parametrize("average", ["micro", "macro", None, "none"])
@pytest.mark.parametrize("k,labels", [(1, False), (3, False), (1, True)], ids=["scores", "top3", "labels"])
def test_multiclass_matches_jax(average, k, labels):
    s, y = _multiclass(k)
    if labels:
        s = s.argmax(1).astype(np.int32)
    kw = dict(average=average, num_classes=7, k=k)
    _close(multiclass_accuracy(*_t(s, y), **kw), jax_multiclass_accuracy(*_j(s, y), **kw))


def test_macro_ignores_unseen_classes_like_jax():
    s, y = _multiclass(2, n=200, c=7)
    y = y % 5  # classes 5 and 6 never occur
    for avg in ("macro", None):
        kw = dict(average=avg, num_classes=7)
        _close(multiclass_accuracy(*_t(s, y), **kw), jax_multiclass_accuracy(*_j(s, y), **kw))


def test_argmax_ties_take_the_first_maximum():
    s = np.asarray([[0.5, 0.5, 0.1], [0.2, 0.7, 0.7], [0.3, 0.3, 0.3]], np.float32)
    y = np.asarray([0, 1, 0], np.int32)
    got = multiclass_accuracy(*_t(s, y))
    assert float(got) == 1.0
    _close(got, jax_multiclass_accuracy(*_j(s, y)))


@pytest.mark.parametrize("threshold", [0.5, 0.2])
def test_binary_matches_jax(threshold):
    rng = np.random.default_rng(3)
    s = rng.random(500).astype(np.float32)
    y = (rng.random(500) < 0.5).astype(np.int32)
    _close(binary_accuracy(*_t(s, y), threshold=threshold), jax_binary_accuracy(*_j(s, y), threshold=threshold))


@pytest.mark.parametrize("criteria", CRITERIA)
def test_multilabel_matches_jax(criteria):
    rng = np.random.default_rng(4)
    s = rng.random((300, 5)).astype(np.float32)
    y = (rng.random((300, 5)) < 0.4).astype(np.int32)
    y[:10] = 0
    s[:5] = 0.1  # rows with no label and no prediction
    kw = dict(criteria=criteria, threshold=0.6)
    _close(multilabel_accuracy(*_t(s, y), **kw), jax_multilabel_accuracy(*_j(s, y), **kw))


@pytest.mark.parametrize("criteria", CRITERIA)
@pytest.mark.parametrize("k", [2, 3])
def test_topk_multilabel_matches_jax(criteria, k):
    rng = np.random.default_rng(5 + k)
    s = rng.random((300, 6)).astype(np.float32)
    s[:4] = 0.25  # all tied: the lower indices are the top k, as in jax.lax.top_k
    y = (rng.random((300, 6)) < 0.4).astype(np.int32)
    kw = dict(criteria=criteria, k=k)
    _close(topk_multilabel_accuracy(*_t(s, y), **kw), jax_topk_multilabel_accuracy(*_j(s, y), **kw))


@pytest.mark.parametrize("average,k", [("macro", 1), (None, 1), ("micro", 2), ("macro", 2)])
def test_out_of_range_targets_under_skip_value_checks_match_jax(average, k, monkeypatch):
    monkeypatch.setenv("TORCHEVAL_TPU_SKIP_VALUE_CHECKS", "1")
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_SKIP_VALUE_CHECKS", "1")
    s, y = _multiclass(8, n=40, c=5)
    y[:6] = [-1, -5, -6, 5, 9, -12]  # wrap once, then drop
    kw = dict(average=average, num_classes=5, k=k)
    _close(multiclass_accuracy(*_t(s, y), **kw), jax_multiclass_accuracy(*_j(s, y), **kw))


def _lifecycle(port, ref, arrays, mask=None):
    for i, part in enumerate(zip(*(np.array_split(a, 3) for a in arrays))):
        m = None if mask is None or i != 1 else np.array_split(mask, 3)[1]
        port.update(*_t(*part), mask=None if m is None else torch.from_numpy(m))
        ref.update(*_j(*part), mask=None if m is None else jnp.asarray(m))
    _close(port.compute(), ref.compute())
    for name in ("num_correct", "num_total"):
        _close(getattr(port, name), getattr(ref, name))


@pytest.mark.parametrize("average", ["micro", "macro", None])
@pytest.mark.parametrize("masked", [False, True])
def test_multiclass_class_matches_jax(average, masked):
    s, y = _multiclass(9)
    mask = np.random.default_rng(10).random(600) < 0.6 if masked else None
    kw = dict(average=average, num_classes=7, k=2 if average == "micro" else 1)
    _lifecycle(MulticlassAccuracy(device="cpu", **kw), JaxMulticlassAccuracy(**kw), (s, y), mask)


def test_other_classes_match_jax():
    rng = np.random.default_rng(11)
    s = rng.random(600).astype(np.float32)
    y = (rng.random(600) < 0.5).astype(np.int32)
    mask = rng.random(600) < 0.5
    _lifecycle(BinaryAccuracy(threshold=0.4, device="cpu"), JaxBinaryAccuracy(threshold=0.4), (s, y), mask)
    sm = rng.random((600, 4)).astype(np.float32)
    ym = (rng.random((600, 4)) < 0.5).astype(np.int32)
    _lifecycle(MultilabelAccuracy(criteria="hamming", device="cpu"), JaxMultilabelAccuracy(criteria="hamming"), (sm, ym), mask)
    _lifecycle(TopKMultilabelAccuracy(criteria="overlap", k=2, device="cpu"), JaxTopKMultilabelAccuracy(criteria="overlap", k=2), (sm, ym), mask)


def test_class_merge_reset_state_dict_and_jax_state():
    s, y = _multiclass(12)
    kw = dict(average="macro", num_classes=7)
    parts = [MulticlassAccuracy(device="cpu", **kw).update(*_t(a, b)) for a, b in zip(np.array_split(s, 3), np.array_split(y, 3))]
    merged = parts[0].merge_state(parts[1:])
    whole = MulticlassAccuracy(device="cpu", **kw).update(*_t(s, y))
    assert torch.equal(merged.num_total, whole.num_total) and torch.equal(merged.num_correct, whole.num_correct)
    snapshot = whole.state_dict()
    assert whole.reset().num_total.sum() == 0 and whole.num_total.dtype == torch.float32
    whole.load_state_dict(snapshot)
    assert torch.equal(whole.compute(), merged.compute())
    ref = JaxMulticlassAccuracy(**kw).update(*_j(s[:300], y[:300]))
    port = MulticlassAccuracy(device="cpu", **kw)
    port.load_state_dict(state_from_jax({k: np.asarray(v) for k, v in ref.state_dict().items()}))
    port.update(*_t(s[300:], y[300:]))
    ref.update(*_j(s[300:], y[300:]))
    _close(port.compute(), ref.compute())


def _messages(fn_jax, fn_port, args, kwargs, exc=ValueError):
    with pytest.raises(exc) as want:
        fn_jax(*_j(*args), **kwargs)
    with pytest.raises(exc) as got:
        fn_port(*_t(*args), **kwargs)
    assert str(got.value) == str(want.value)


_F, _I = np.float32, np.int32


@pytest.mark.parametrize(
    "args,kwargs,exc",
    [
        ((np.zeros((4, 3), _F), np.zeros(5, _I)), {}, ValueError),
        ((np.zeros((4, 3), _F), np.zeros((4, 1), _I)), {}, ValueError),
        ((np.zeros(4, _F), np.zeros(4, _I)), {"k": 2}, ValueError),
        ((np.zeros((4, 3), _F), np.zeros(4, _I)), {"num_classes": 4}, ValueError),
        ((np.zeros((4, 3), _F), np.zeros(4, _I)), {"average": "weighted"}, ValueError),
        ((np.zeros((4, 3), _F), np.zeros(4, _I)), {"average": "macro"}, ValueError),
        ((np.zeros((4, 3), _F), np.zeros(4, _I)), {"k": 0}, ValueError),
        ((np.zeros((4, 3), _F), np.zeros(4, _I)), {"k": 1.0}, TypeError),
        ((np.zeros((4, 3), _F), np.asarray([0, 1, 2, 3], _I)), {"average": "macro", "num_classes": 3}, ValueError),
    ],
)
def test_multiclass_errors_match_jax(args, kwargs, exc):
    _messages(jax_multiclass_accuracy, multiclass_accuracy, args, kwargs, exc)


@pytest.mark.parametrize(
    "fn_jax,fn_port,args,kwargs",
    [
        (jax_binary_accuracy, binary_accuracy, (np.zeros(4, _F), np.zeros(3, _I)), {}),
        (jax_binary_accuracy, binary_accuracy, (np.zeros((2, 2), _F), np.zeros((2, 2), _I)), {}),
        (jax_multilabel_accuracy, multilabel_accuracy, (np.zeros((4, 2), _F), np.zeros((4, 3), _I)), {}),
        (jax_multilabel_accuracy, multilabel_accuracy, (np.zeros((4, 2), _F), np.zeros((4, 2), _I)), {"criteria": "any"}),
        (jax_topk_multilabel_accuracy, topk_multilabel_accuracy, (np.zeros((4, 3), _F), np.zeros((4, 3), _I)), {"k": 1}),
        (jax_topk_multilabel_accuracy, topk_multilabel_accuracy, (np.zeros(4, _F), np.zeros(4, _I)), {}),
    ],
)
def test_other_errors_match_jax(fn_jax, fn_port, args, kwargs):
    _messages(fn_jax, fn_port, args, kwargs)
