"""The binned AUROC / AUPRC / PR-curve family against the JAX package:
functional and class metrics on the same inputs.  Count states and grids
are bit-equal; AUROC, AP, precision and recall are within 1e-6 (f32 sums
in another order).  Covers ``mask=``, merge, checkpoints, a JAX state
carried into the port, the error messages and out-of-range targets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as jm
import torcheval_tpu.metrics.functional as jf
import torcheval_tpu_torch.metrics as pm
import torcheval_tpu_torch.metrics.functional as pf
from torcheval_tpu_torch.convert import state_from_jax
from torcheval_tpu_torch.ops import _build

CPU = "cpu"


def _close(got, want):
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-6)


def _bitwise(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


def _data(seed, shape, p=0.4, grid=None):
    rng = np.random.default_rng(seed)
    s = rng.random(shape).astype(np.float32)
    if grid:
        s = (np.floor(s * grid) / grid).astype(np.float32)  # ties with the grid
    return s, (rng.random(shape) < p).astype(np.int32)


_THRESHOLDS = [200, 7, 1, [0.0, 0.1, 0.25, 0.5, 1.0]]


@pytest.mark.parametrize("threshold", _THRESHOLDS, ids=["200", "7", "1", "list"])
@pytest.mark.parametrize("name", ["binary_binned_auroc", "binary_binned_auprc"])
@pytest.mark.parametrize("num_tasks", [1, 3])
def test_binary_functional_matches_jax(name, threshold, num_tasks):
    shape = (num_tasks, 500) if num_tasks > 1 else (500,)
    s, y = _data(num_tasks, shape, grid=20)
    _build.reset_counts()
    got, got_t = getattr(pf, name)(torch.from_numpy(s), torch.from_numpy(y),
                                   num_tasks=num_tasks, threshold=threshold)
    assert dict(_build.PLAIN_CALLS) == {"binned_counts": 1}
    want, want_t = getattr(jf, name)(jnp.asarray(s), jnp.asarray(y),
                                     num_tasks=num_tasks, threshold=threshold)
    _bitwise(got_t.numpy(), want_t)
    _close(got, want)


@pytest.mark.parametrize("average", ["macro", None])
@pytest.mark.parametrize("name", ["multiclass_binned_auroc", "multiclass_binned_auprc"])
def test_multiclass_functional_matches_jax(name, average):
    rng = np.random.default_rng(7)
    s = (np.floor(rng.random((600, 6)) * 50) / 50).astype(np.float32)
    y = rng.integers(0, 6, 600).astype(np.int32)
    y[y == 5] = 0  # a class without positives
    got, _ = getattr(pf, name)(torch.from_numpy(s), torch.from_numpy(y),
                               num_classes=6, average=average, threshold=50)
    want, _ = getattr(jf, name)(jnp.asarray(s), jnp.asarray(y),
                                num_classes=6, average=average, threshold=50)
    _close(got, want)


@pytest.mark.parametrize("average", ["macro", None])
def test_multilabel_functional_matches_jax(average):
    s, y = _data(8, (400, 4), grid=30)
    args_p, args_j = (torch.from_numpy(s), torch.from_numpy(y)), (jnp.asarray(s), jnp.asarray(y))
    got, _ = pf.multilabel_binned_auprc(*args_p, num_labels=4, average=average, threshold=30)
    want, _ = jf.multilabel_binned_auprc(*args_j, num_labels=4, average=average, threshold=30)
    _close(got, want)
    got_c = pf.multilabel_binned_precision_recall_curve(*args_p, num_labels=4, threshold=30)
    want_c = jf.multilabel_binned_precision_recall_curve(*args_j, num_labels=4, threshold=30)
    _close(got_c[:2], want_c[:2])
    _bitwise(got_c[2].numpy(), want_c[2])


def test_binned_curves_match_jax():
    s, y = _data(9, (700,), grid=25)
    got = pf.binary_binned_precision_recall_curve(torch.from_numpy(s), torch.from_numpy(y),
                                                  threshold=25)
    want = jf.binary_binned_precision_recall_curve(jnp.asarray(s), jnp.asarray(y), threshold=25)
    _close(got, want)
    rng = np.random.default_rng(10)
    sm = rng.random((300, 5)).astype(np.float32)
    ym = rng.integers(0, 5, 300).astype(np.int32)
    got = pf.multiclass_binned_precision_recall_curve(
        torch.from_numpy(sm), torch.from_numpy(ym), num_classes=5, threshold=[0.0, 0.3, 0.9])
    want = jf.multiclass_binned_precision_recall_curve(
        jnp.asarray(sm), jnp.asarray(ym), num_classes=5, threshold=[0.0, 0.3, 0.9])
    _close(got[:2], want[:2])
    _bitwise(got[2].numpy(), want[2])


def test_nan_and_out_of_range_scores_match_the_jax_sort_route():
    s, y = _data(11, (2, 300))
    s[0, :7] = np.nan
    s[1, :3] = [-2.0, 5.0, np.inf]
    for name in ("binary_binned_auroc", "binary_binned_auprc"):
        got, _ = getattr(pf, name)(torch.from_numpy(s), torch.from_numpy(y), num_tasks=2)
        want, _ = getattr(jf, name)(jnp.asarray(s), jnp.asarray(y), num_tasks=2)
        _close(got, want)


def _jax_counts(metric):
    return {k: np.asarray(getattr(metric, k)) for k in ("num_tp", "num_fp", "num_pos", "num_total")}


def _assert_states_equal(port, ref, names):
    for name in names:
        _bitwise(getattr(port, name).numpy(), np.asarray(getattr(ref, name)))


_COUNT_STATES = ("threshold", "num_tp", "num_fp", "num_pos", "num_total")


def _binned_pairs(kind):
    if kind == "binary":
        return (pm.BinaryBinnedAUROC(num_tasks=2, threshold=40, device=CPU),
                jm.BinaryBinnedAUROC(num_tasks=2, threshold=40)), (2, 250)
    if kind == "binary_auprc":
        return (pm.BinaryBinnedAUPRC(threshold=40, device=CPU),
                jm.BinaryBinnedAUPRC(threshold=40)), (250,)
    if kind == "multiclass":
        return (pm.MulticlassBinnedAUPRC(num_classes=5, average=None, threshold=40, device=CPU),
                jm.MulticlassBinnedAUPRC(num_classes=5, average=None, threshold=40)), (250, 5)
    if kind == "multiclass_auroc":
        return (pm.MulticlassBinnedAUROC(num_classes=5, threshold=40, device=CPU),
                jm.MulticlassBinnedAUROC(num_classes=5, threshold=40)), (250, 5)
    if kind == "multilabel":
        return (pm.MultilabelBinnedAUPRC(num_labels=3, average=None, threshold=40, device=CPU),
                jm.MultilabelBinnedAUPRC(num_labels=3, average=None, threshold=40)), (250, 3)
    assert kind == "multilabel_curve"
    return (pm.MultilabelBinnedPrecisionRecallCurve(num_labels=3, threshold=40, device=CPU),
            jm.MultilabelBinnedPrecisionRecallCurve(num_labels=3, threshold=40)), (250, 3)


def _batch(rng, kind, shape):
    s = (np.floor(rng.random(shape) * 40) / 40).astype(np.float32)
    if kind.startswith("multiclass"):
        return s, rng.integers(0, shape[1], shape[0]).astype(np.int32)
    return s, (rng.random(shape) < 0.4).astype(np.int32)


@pytest.mark.parametrize(
    "kind",
    ["binary", "binary_auprc", "multiclass", "multiclass_auroc", "multilabel", "multilabel_curve"],
)
def test_class_lifecycle_with_mask_matches_jax(kind):
    (port, ref), shape = _binned_pairs(kind)
    rng = np.random.default_rng(len(kind))
    _build.reset_counts()
    for i in range(4):
        s, y = _batch(rng, kind, shape)
        mask = None if i % 2 else (rng.random(shape[-1] if kind.startswith("binary") else shape[0])
                                   < 0.7).astype(np.int32)
        port.update(s, y, mask=mask)
        ref.update(jnp.asarray(s), jnp.asarray(y),
                   mask=None if mask is None else jnp.asarray(mask))
    assert dict(_build.PLAIN_CALLS) == {"binned_counts": 4} and not _build.LAUNCHES
    _assert_states_equal(port, ref, _COUNT_STATES)
    assert port.num_tp.dtype == torch.int32 and port.threshold.dtype == torch.float32
    _close(port.compute(), ref.compute())

    # merge_state adds the counts; a JAX state continues in the port.
    twin, _ = _binned_pairs(kind)[0]
    twin.load_state_dict(state_from_jax(_jax_counts(ref) | {"threshold": np.asarray(ref.threshold)}))
    _assert_states_equal(twin, ref, _COUNT_STATES)
    s, y = _batch(rng, kind, shape)
    twin.update(s, y)
    ref.update(jnp.asarray(s), jnp.asarray(y))
    _assert_states_equal(twin, ref, _COUNT_STATES)
    _close(twin.compute(), ref.compute())
    merged = _binned_pairs(kind)[0][0].merge_state([port, port])
    assert torch.equal(merged.num_tp, 2 * port.num_tp)

    snap = port.state_dict()
    port.reset()
    assert int(port.num_total.sum()) == 0 and torch.equal(port.threshold, snap["threshold"])
    port.load_state_dict(snap)
    assert torch.equal(port.num_fp, snap["num_fp"])


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_binned_curve_classes_match_jax(kind):
    rng = np.random.default_rng(12)
    if kind == "binary":
        port = pm.BinaryBinnedPrecisionRecallCurve(threshold=30, device=CPU)
        ref = jm.BinaryBinnedPrecisionRecallCurve(threshold=30)
    else:
        port = pm.MulticlassBinnedPrecisionRecallCurve(num_classes=4, threshold=30, device=CPU)
        ref = jm.MulticlassBinnedPrecisionRecallCurve(num_classes=4, threshold=30)
    for _ in range(3):
        if kind == "binary":
            s, y = rng.random(200).astype(np.float32), (rng.random(200) < 0.5).astype(np.int32)
        else:
            s, y = rng.random((200, 4)).astype(np.float32), rng.integers(0, 4, 200).astype(np.int32)
        port.update(s, y)
        ref.update(jnp.asarray(s), jnp.asarray(y))
    # The JAX states are f32 (the reference's zeros default); so are the port's.
    _assert_states_equal(port, ref, ("threshold", "num_tp", "num_fp", "num_fn"))
    got, want = port.compute(), ref.compute()
    _close(got[:2], want[:2])
    _bitwise(got[2].numpy(), want[2])
    fresh = type(port)(**({"num_classes": 4} if kind == "multiclass" else {}),
                       threshold=30, device=CPU)
    fresh.load_state_dict(state_from_jax({k: np.asarray(v) for k, v in ref.state_dict().items()}))
    assert torch.equal(fresh.merge_state([port]).num_tp, 2 * port.num_tp)


@pytest.mark.parametrize(
    "call,message",
    [
        (lambda: pf.binary_binned_auroc(torch.rand(5), torch.ones(5), threshold=[0.5, 0.1]),
         "The `threshold` should be a sorted array."),
        (lambda: pf.binary_binned_auprc(torch.rand(5), torch.ones(5), threshold=[0.0, 1.5]),
         r"The values in `threshold` should be in the range of \[0, 1\]."),
        (lambda: pf.multiclass_binned_auroc(torch.rand(5, 3), torch.zeros(5), num_classes=1),
         "`num_classes` has to be at least 2."),
        (lambda: pf.multiclass_binned_auprc(torch.rand(5, 3), torch.zeros(5), num_classes=3,
                                            average="micro"),
         "`average` was not in the allowed value"),
        (lambda: pf.multiclass_binned_auroc(torch.rand(5, 3), torch.tensor([0, 1, 2, 3, 0]),
                                            num_classes=3),
         r"target values should be in \[0, 3\), got min 0 max 3."),
        (lambda: pf.multiclass_binned_precision_recall_curve(
            torch.rand(5, 3), torch.tensor([0, -1, 2, 1, 0]), num_classes=3),
         r"target values should be in \[0, 3\), got min -1 max 2."),
        (lambda: pf.binary_binned_precision_recall_curve(torch.rand(5, 2), torch.ones(5, 2)),
         "input should be a one-dimensional tensor"),
        (lambda: pm.MulticlassBinnedAUROC(num_classes=3, device=CPU).update(
            torch.rand(4, 3), torch.tensor([0, 1, 2, 7])),
         r"target values should be in \[0, 3\)"),
        (lambda: pm.MulticlassBinnedPrecisionRecallCurve(num_classes=1, device=CPU),
         "`num_classes` has to be at least 2, got 1."),
        (lambda: pm.MultilabelBinnedAUPRC(num_labels=1, device=CPU),
         "`num_labels` has to be at least 2."),
        (lambda: pm.BinaryBinnedAUROC(num_tasks=0, device=CPU),
         "`num_tasks` value should be greater than and equal to 1"),
    ],
)
def test_error_messages(call, message):
    with pytest.raises(ValueError, match=message):
        call()


def test_out_of_range_message_matches_jax():
    s, y = np.random.default_rng(0).random((4, 3)).astype(np.float32), np.array([0, 1, 2, 5])
    with pytest.raises(ValueError) as port_err:
        pf.multiclass_binned_auprc(torch.from_numpy(s), torch.from_numpy(y), num_classes=3)
    with pytest.raises(ValueError) as jax_err:
        jf.multiclass_binned_auprc(jnp.asarray(s), jnp.asarray(y), num_classes=3)
    assert str(port_err.value) == str(jax_err.value)
