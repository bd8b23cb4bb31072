"""The port's confusion matrix (functional and class) and the per-class
count trio against the JAX package on the same numpy inputs.  Counts are
bit-equal on every route; normalized matrices are f32 ratios of the same
counts, held within 1e-6 relative."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.metrics import (
    BinaryConfusionMatrix as JaxBinaryCM,
    MulticlassConfusionMatrix as JaxMulticlassCM,
)
from torcheval_tpu.metrics.functional import (
    binary_confusion_matrix as jax_binary_cm,
    multiclass_confusion_matrix as jax_multiclass_cm,
)
from torcheval_tpu.metrics.functional.classification.confusion_matrix import (
    _class_counts as jax_class_counts,
)
from torcheval_tpu_torch.convert import state_from_jax
from torcheval_tpu_torch.metrics import BinaryConfusionMatrix, MulticlassConfusionMatrix
from torcheval_tpu_torch.metrics.functional import (
    binary_confusion_matrix,
    multiclass_confusion_matrix,
    skip_value_checks,
)
from torcheval_tpu_torch.metrics.functional.classification.confusion_matrix import (
    _class_counts,
    _cm_route,
    _counts_route,
)
from torcheval_tpu_torch.ops import _build

RTOL = 1e-6


def _same(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def _labels(seed, n, c):
    rng = np.random.default_rng(seed)
    return rng.integers(0, c, n).astype(np.int32), rng.integers(0, c, n).astype(np.int32)


@pytest.mark.parametrize(
    "c,n,route",
    [(8, 1024, "matmul"), (130, 3000, "pallas"), (1000, 2**17, "pallas"), (2600, 300, "scatter")],
)
def test_routes_are_decided_from_shapes(c, n, route):
    assert _cm_route(c, n) == route
    assert _counts_route(np.zeros((n, 1)), c, "macro") == route
    assert _counts_route(np.zeros((n, 1)), c, "micro") == "scatter"


def test_past_the_int32_sample_bound_takes_the_scatter():
    assert _cm_route(100, 2**31) == "scatter"


@pytest.mark.parametrize("normalize", [None, "none", "all", "pred", "true"])
@pytest.mark.parametrize(
    "c,n,scores,route",
    [
        (8, 1024, True, None),  # the flagship's shape: matmul
        (6, 500, False, None),
        (130, 2000, False, "confusion_slab"),
        (2600, 300, False, None),  # past _MAX_W: scatter
    ],
    ids=["flagship-matmul", "small-matmul", "slab", "scatter"],
)
def test_multiclass_matches_jax(c, n, scores, route, normalize):
    pred, target = _labels(c + n, n, c)
    if scores:
        pred = np.random.default_rng(1).random((n, c)).astype(np.float32)
    _build.reset_counts()
    got = multiclass_confusion_matrix(
        torch.from_numpy(pred), torch.from_numpy(target), c, normalize=normalize
    )
    assert dict(_build.PLAIN_CALLS) == ({route: 1} if route else {})
    _same(got, jax_multiclass_cm(jnp.asarray(pred), jnp.asarray(target), c, normalize=normalize))


def test_row_chunk_flag_keeps_the_counts(monkeypatch):
    pred, target = _labels(5, 1000, 8)
    want = jax_multiclass_cm(jnp.asarray(pred), jnp.asarray(target), 8)
    for chunk in ("64", "100", "not-a-number"):  # 100 and text fall back to 4096
        monkeypatch.setenv("TORCHEVAL_TPU_TORCH_CM_ROW_CHUNK", chunk)
        _same(multiclass_confusion_matrix(torch.from_numpy(pred), torch.from_numpy(target), 8), want)


@pytest.mark.parametrize("normalize", [None, "all", "pred", "true"])
def test_binary_matches_jax(normalize):
    rng = np.random.default_rng(7)
    s = rng.random(700).astype(np.float32)
    y = (rng.random(700) < 0.4).astype(np.int32)
    got = binary_confusion_matrix(torch.from_numpy(s), torch.from_numpy(y), threshold=0.3, normalize=normalize)
    _same(got, jax_binary_cm(jnp.asarray(s), jnp.asarray(y), threshold=0.3, normalize=normalize))


def _jax_trio(pred, target, c, route):
    kw = {"interpret": True} if route == "pallas" else {}
    return [np.asarray(x) for x in jax_class_counts(jnp.asarray(pred), jnp.asarray(target), c, route, **kw)]


@pytest.mark.parametrize("route", ["pallas", "scatter", "matmul"])
@pytest.mark.parametrize("c,n", [(6, 500), (130, 3000), (1000, 4000)])
def test_class_counts_match_jax(route, c, n):
    pred, target = _labels(c, n, c)
    got = _class_counts(torch.from_numpy(pred), torch.from_numpy(target), c, route)
    for g, w in zip(got, _jax_trio(pred, target, c, route)):
        _same(g, w)


@pytest.mark.parametrize("route", ["pallas", "scatter", "matmul"])
def test_class_counts_out_of_range_match_jax(route):
    # Wrap once, drop what is still out of range from its own marginal.
    pred = np.asarray([0, 1, -6, 2, 9, -1, 700, -1], np.int32)
    target = np.asarray([0, -7, 1, 2, 3, 3, -800, 5], np.int32)
    got = _class_counts(torch.from_numpy(pred), torch.from_numpy(target), 6, route)
    for g, w in zip(got, _jax_trio(pred, target, 6, route)):
        _same(g, w)


@pytest.mark.parametrize("c", [6, 130])
def test_out_of_range_labels_under_skip_value_checks_match_jax(c, monkeypatch):
    monkeypatch.setenv("TORCHEVAL_TPU_SKIP_VALUE_CHECKS", "1")
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_SKIP_VALUE_CHECKS", "1")
    pred = np.asarray([0, 1, -6, 2, 9, -1, 700, -1, -c - 3], np.int32)
    target = np.asarray([0, -7, 1, 2, 3, 3, -800, 5, 4], np.int32)
    got = multiclass_confusion_matrix(torch.from_numpy(pred), torch.from_numpy(target), c)
    _same(got, jax_multiclass_cm(jnp.asarray(pred), jnp.asarray(target), c))
    with skip_value_checks():  # the context switch, process flag unset
        monkeypatch.delenv("TORCHEVAL_TPU_TORCH_SKIP_VALUE_CHECKS")
        again = multiclass_confusion_matrix(torch.from_numpy(pred), torch.from_numpy(target), c)
    assert torch.equal(again, got)


def _split(arrays, k):
    return list(zip(*(np.array_split(a, k) for a in arrays)))


@pytest.mark.parametrize("c,n", [(8, 1024), (200, 4000)])
def test_class_lifecycle_matches_jax(c, n):
    pred, target = _labels(11, n, c)
    port = MulticlassConfusionMatrix(c, normalize="true", device="cpu")
    ref = JaxMulticlassCM(c, normalize="true")
    for p, t in _split((pred, target), 4):
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    _same(port.confusion_matrix, ref.confusion_matrix)
    _same(port.compute(), ref.compute())
    _same(port.normalized("pred"), ref.normalized("pred"))
    _same(port.normalized(), ref.normalized())


def test_class_merge_reset_and_state_dict():
    pred, target = _labels(12, 900, 50)
    parts = _split((pred, target), 3)
    metrics = [MulticlassConfusionMatrix(50, device="cpu").update(torch.from_numpy(p), torch.from_numpy(t)) for p, t in parts]
    merged = metrics[0].merge_state(metrics[1:])
    whole = MulticlassConfusionMatrix(50, device="cpu").update(torch.from_numpy(pred), torch.from_numpy(target))
    assert torch.equal(merged.compute(), whole.compute())
    snapshot = whole.state_dict()
    whole.reset()
    assert int(whole.confusion_matrix.sum()) == 0 and whole.confusion_matrix.dtype == torch.int32
    whole.load_state_dict(snapshot)
    assert torch.equal(whole.compute(), merged.compute())


@pytest.mark.parametrize("c", [8, 300])
def test_class_mask_matches_jax(c):
    pred, target = _labels(13, 600, c)
    mask = np.random.default_rng(14).random(600) < 0.7
    port = MulticlassConfusionMatrix(c, device="cpu").update(
        torch.from_numpy(pred), torch.from_numpy(target), mask=torch.from_numpy(mask)
    )
    ref = JaxMulticlassCM(c).update(jnp.asarray(pred), jnp.asarray(target), mask=jnp.asarray(mask))
    _same(port.compute(), ref.compute())
    assert int(port.compute().sum()) == int(mask.sum())


def test_class_continues_a_jax_state():
    pred, target = _labels(15, 800, 40)
    ref = JaxMulticlassCM(40).update(jnp.asarray(pred[:500]), jnp.asarray(target[:500]))
    port = MulticlassConfusionMatrix(40, device="cpu")
    port.load_state_dict(state_from_jax({k: np.asarray(v) for k, v in ref.state_dict().items()}))
    port.update(torch.from_numpy(pred[500:]), torch.from_numpy(target[500:]))
    ref.update(jnp.asarray(pred[500:]), jnp.asarray(target[500:]))
    _same(port.compute(), ref.compute())


@pytest.mark.parametrize("normalize", [None, "all"])
def test_binary_class_matches_jax(normalize):
    rng = np.random.default_rng(16)
    s = rng.random(500).astype(np.float32)
    y = (rng.random(500) < 0.5).astype(np.int32)
    mask = rng.random(500) < 0.8
    port = BinaryConfusionMatrix(threshold=0.6, normalize=normalize, device="cpu")
    ref = JaxBinaryCM(threshold=0.6, normalize=normalize)
    port.update(torch.from_numpy(s[:300]), torch.from_numpy(y[:300]))
    ref.update(jnp.asarray(s[:300]), jnp.asarray(y[:300]))
    port.update(torch.from_numpy(s[300:]), torch.from_numpy(y[300:]), mask=torch.from_numpy(mask[300:]))
    ref.update(jnp.asarray(s[300:]), jnp.asarray(y[300:]), mask=jnp.asarray(mask[300:]))
    _same(port.compute(), ref.compute())


def _messages(fn_jax, fn_port, args, kwargs):
    with pytest.raises(ValueError) as want:
        fn_jax(*[jnp.asarray(a) for a in args], **kwargs)
    with pytest.raises(ValueError) as got:
        fn_port(*[torch.from_numpy(a) for a in args], **kwargs)
    assert str(got.value) == str(want.value)


_I = np.int32


@pytest.mark.parametrize(
    "args,kwargs",
    [
        ((np.zeros(4, _I), np.zeros(5, _I)), {"num_classes": 3}),
        ((np.zeros(4, _I), np.zeros((4, 2), _I)), {"num_classes": 3}),
        ((np.zeros((4, 2), np.float32), np.zeros(4, _I)), {"num_classes": 3}),
        ((np.asarray([0, 3], _I), np.zeros(2, _I)), {"num_classes": 3}),
        ((np.asarray([0, -1], _I), np.zeros(2, _I)), {"num_classes": 3}),
        ((np.zeros(2, _I), np.asarray([0, 5], _I)), {"num_classes": 3}),
        ((np.zeros(2, _I), np.asarray([-2, 0], _I)), {"num_classes": 3}),
        ((np.zeros(2, _I), np.zeros(2, _I)), {"num_classes": 1}),
        ((np.zeros(2, _I), np.zeros(2, _I)), {"num_classes": 3, "normalize": "rows"}),
    ],
)
def test_multiclass_errors_match_jax(args, kwargs):
    _messages(jax_multiclass_cm, multiclass_confusion_matrix, args, kwargs)


@pytest.mark.parametrize(
    "args",
    [
        (np.zeros(4, np.float32), np.zeros(5, _I)),
        (np.zeros((2, 2), np.float32), np.zeros((2, 2), _I)),
        (np.zeros(2, np.float32), np.asarray([0, 2], _I)),
    ],
)
def test_binary_errors_match_jax(args):
    _messages(jax_binary_cm, binary_confusion_matrix, args, {})
