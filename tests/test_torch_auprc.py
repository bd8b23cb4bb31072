"""The exact AUPRC slice against the JAX package: functional and class
metrics on the same inputs (1e-6: f32 sums in another order), on the
rank-histogram route and the sort route, with merge, checkpoints, a JAX
state carried into the port, the error messages and out-of-range
targets."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.metrics import (
    BinaryAUPRC as JaxBinaryAUPRC,
    MulticlassAUPRC as JaxMulticlassAUPRC,
    MultilabelAUPRC as JaxMultilabelAUPRC,
)
from torcheval_tpu.metrics.functional import (
    binary_auprc as jax_binary_auprc,
    multiclass_auprc as jax_multiclass_auprc,
    multilabel_auprc as jax_multilabel_auprc,
)
from torcheval_tpu_torch.convert import state_from_jax
from torcheval_tpu_torch.metrics import BinaryAUPRC, MulticlassAUPRC, MultilabelAUPRC
from torcheval_tpu_torch.metrics.functional import (
    binary_auprc,
    multiclass_auprc,
    multilabel_auprc,
)
from torcheval_tpu_torch.ops import _build

CPU = "cpu"


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-6)


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def _numpy_state(jax_metric):
    return {
        k: [np.asarray(a) for a in v] if isinstance(v, list) else np.asarray(v)
        for k, v in jax_metric.state_dict().items()
    }


def _multiclass_data(seed, n, c, grid=None):
    rng = np.random.default_rng(seed)
    s = rng.random((n, c)).astype(np.float32)
    if grid:
        s = (np.floor(s * grid) / grid).astype(np.float32)
    return s, rng.integers(0, c, n).astype(np.int32)


@pytest.mark.parametrize("average", ["macro", None, "none"])
@pytest.mark.parametrize(
    "n,c,route",
    # 200 classes over 2^15 samples: the largest class holds ~210, so the
    # rank-histogram route takes cap 256; 12 classes over 600 samples sort.
    [(2**15, 200, "rank_hist_counts"), (600, 12, None)],
)
def test_multiclass_auprc_matches_jax(average, n, c, route):
    s, y = _multiclass_data(c, n, c, grid=64)
    _build.reset_counts()
    got = multiclass_auprc(*_t(s, y), num_classes=c, average=average)
    assert dict(_build.PLAIN_CALLS) == ({route: 1} if route else {})
    want = jax_multiclass_auprc(jnp.asarray(s), jnp.asarray(y), num_classes=c, average=average)
    _close(got, want)


def test_route_switch_and_pinned_cap(monkeypatch):
    s, y = _multiclass_data(1, 2**15, 200)
    ustat = multiclass_auprc(*_t(s, y), num_classes=200, average=None)
    pinned = multiclass_auprc(*_t(s, y), num_classes=200, average=None, ustat_cap=512)
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_DISABLE_USTAT", "1")
    _build.reset_counts()
    sorted_ = multiclass_auprc(*_t(s, y), num_classes=200, average=None, ustat_cap=256)
    assert not _build.PLAIN_CALLS  # the sort route runs no kernel
    _close(ustat, sorted_)
    _close(pinned, sorted_)
    with pytest.raises(ValueError, match="ustat_cap=16 but one class has"):
        multiclass_auprc(*_t(s, y), num_classes=200, ustat_cap=16)


def test_out_of_range_targets_take_the_sort_route_as_jax():
    s, y = _multiclass_data(2, 2**15, 200)
    y[:5] = 200
    _build.reset_counts()
    got = multiclass_auprc(*_t(s, y), num_classes=200, average=None)
    assert "rank_hist_counts" not in _build.PLAIN_CALLS
    want = jax_multiclass_auprc(jnp.asarray(s), jnp.asarray(y), num_classes=200, average=None)
    _close(got, want)


@pytest.mark.parametrize("case", ["rare_pos", "balanced", "single_row"])
def test_binary_auprc_matches_jax(case):
    rng = np.random.default_rng(3)
    shape = (250,) if case == "single_row" else (2, 2**15)
    s = (np.floor(rng.random(shape) * 128) / 128).astype(np.float32)
    y = (rng.random(shape) < (0.003 if case == "rare_pos" else 0.5)).astype(np.int32)
    num_tasks = 1 if case == "single_row" else 2
    _build.reset_counts()
    got = binary_auprc(*_t(s, y), num_tasks=num_tasks)
    assert bool(_build.PLAIN_CALLS) == (case == "rare_pos")
    _close(got, jax_binary_auprc(jnp.asarray(s), jnp.asarray(y), num_tasks=num_tasks))


@pytest.mark.parametrize("average", ["macro", None])
def test_multilabel_auprc_matches_jax(average):
    rng = np.random.default_rng(4)
    s = rng.random((400, 5)).astype(np.float32)
    y = (rng.random((400, 5)) < 0.3).astype(np.int32)
    y[:, 4] = 0  # a label without positives: AP 0
    got = multilabel_auprc(*_t(s, y), num_labels=5, average=average)
    _close(got, jax_multilabel_auprc(jnp.asarray(s), jnp.asarray(y), num_labels=5, average=average))


def test_empty_inputs():
    assert multiclass_auprc(torch.zeros(0, 3), torch.zeros(0, dtype=torch.int32),
                            num_classes=3).item() == 0.0
    assert multilabel_auprc(torch.zeros(0, 3), torch.zeros(0, 3), average=None).tolist() == [0.0] * 3
    assert binary_auprc(torch.zeros(2, 0), torch.zeros(2, 0), num_tasks=2).tolist() == [0.0, 0.0]


@pytest.mark.parametrize(
    "call,message",
    [
        (lambda: multiclass_auprc(torch.zeros(4, 3), torch.zeros(4), num_classes=3, average="micro"),
         "`average` was not in the allowed value"),
        (lambda: multiclass_auprc(torch.zeros(4, 1), torch.zeros(4), num_classes=1),
         "`num_classes` has to be at least 2."),
        (lambda: multiclass_auprc(torch.zeros(4, 3), torch.zeros(5), num_classes=3),
         "should have the same first dimension"),
        (lambda: multilabel_auprc(torch.zeros(4, 3), torch.zeros(4, 2)),
         "to have the same shape"),
        (lambda: multilabel_auprc(torch.zeros(4, 3), torch.zeros(4, 3), num_labels=1),
         "`num_labels` has to be at least 2."),
        (lambda: binary_auprc(torch.zeros(2, 4), torch.zeros(2, 4)),
         "`num_tasks = 1`, `input` is expected to be one-dimensional"),
    ],
)
def test_error_messages(call, message):
    with pytest.raises(ValueError, match=message.replace("(", r"\(")):
        call()


def _multiclass_batches(seed, c, total=2**15, updates=8):
    s, y = _multiclass_data(seed, total, c)
    return list(zip(np.split(s, updates), np.split(y, updates)))


@pytest.mark.parametrize("average", ["macro", None])
def test_multiclass_class_lifecycle_matches_jax(average):
    batches = _multiclass_batches(5, 200)
    port = MulticlassAUPRC(num_classes=200, average=average, device=CPU)
    ref = JaxMulticlassAUPRC(num_classes=200, average=average)
    assert port.compute().numel() == 0
    for s, y in batches:
        port.update(s, y)
        ref.update(jnp.asarray(s), jnp.asarray(y))
    _build.reset_counts()
    got = port.compute()
    assert dict(_build.PLAIN_CALLS) == {"rank_hist_counts": 1}
    _close(got, ref.compute())

    a = MulticlassAUPRC(num_classes=200, average=average, device=CPU)
    b = MulticlassAUPRC(num_classes=200, average=average, device=CPU)
    for i, (s, y) in enumerate(batches):
        (a if i < 3 else b).update(*_t(s, y))
    b._prepare_for_merge_state()
    assert len(b.inputs) == 1
    assert torch.equal(a.merge_state([b]).compute(), got)

    fresh = MulticlassAUPRC(num_classes=200, average=average, device=CPU)
    fresh.load_state_dict(port.state_dict())
    assert torch.equal(fresh.compute(), got)
    port.reset()
    assert port.inputs == [] and port.compute().numel() == 0


def test_jax_state_continues_in_the_port():
    batches = _multiclass_batches(6, 200)
    ref = JaxMulticlassAUPRC(num_classes=200)
    for s, y in batches[:4]:
        ref.update(jnp.asarray(s), jnp.asarray(y))
    port = MulticlassAUPRC(num_classes=200, device=CPU)
    port.load_state_dict(state_from_jax(_numpy_state(ref)))
    for s, y in batches[4:]:
        ref.update(jnp.asarray(s), jnp.asarray(y))
        port.update(s, y)
    assert port.inputs[0].dtype == torch.float32 and port.targets[0].dtype == torch.int32
    _close(port.compute(), ref.compute())


@pytest.mark.parametrize("num_tasks", [1, 3])
def test_binary_class_lifecycle_matches_jax(num_tasks):
    rng = np.random.default_rng(num_tasks)
    shape = (num_tasks, 300) if num_tasks > 1 else (300,)
    port = BinaryAUPRC(num_tasks=num_tasks, device=CPU)
    ref = JaxBinaryAUPRC(num_tasks=num_tasks, sketch=False)
    for _ in range(3):
        s = (np.floor(rng.random(shape) * 32) / 32).astype(np.float32)
        y = (rng.random(shape) < 0.4).astype(np.int32)
        port.update(s, y)
        ref.update(jnp.asarray(s), jnp.asarray(y))
    _close(port.compute(), ref.compute())
    other = BinaryAUPRC(num_tasks=num_tasks, device=CPU)
    other.load_state_dict(state_from_jax(_numpy_state(ref)))
    _close(other.compute(), ref.compute())
    merged = BinaryAUPRC(num_tasks=num_tasks, device=CPU).merge_state([port])
    _close(merged.compute(), ref.compute())
    with pytest.raises(ValueError, match="mask= requires the rank-sketch state"):
        port.update(s, y, mask=np.ones(shape[-1]))


def test_multilabel_class_matches_jax():
    rng = np.random.default_rng(8)
    port = MultilabelAUPRC(num_labels=4, average=None, device=CPU)
    ref = JaxMultilabelAUPRC(num_labels=4, average=None)
    for _ in range(3):
        s = rng.random((100, 4)).astype(np.float32)
        y = (rng.random((100, 4)) < 0.3).astype(np.int32)
        port.update(s, y)
        ref.update(jnp.asarray(s), jnp.asarray(y))
    _close(port.compute(), ref.compute())
    empty = MultilabelAUPRC(num_labels=4, device=CPU)
    empty.update(np.zeros((0, 4), np.float32), np.zeros((0, 4), np.int32))
    assert empty.compute().item() == 0.0


def test_sketch_mode_is_not_ported_yet():
    # The sketch tier is ported: BinaryAUPRC(sketch=True) keeps the JAX
    # package's rank-sketch counts and value.
    rng = np.random.default_rng(13)
    s = rng.random(600).astype(np.float32)
    y = (rng.random(600) < s).astype(np.int32)
    port = BinaryAUPRC(device=CPU, sketch=True, sketch_bins=64).update(s, y)
    ref = JaxBinaryAUPRC(sketch=True, sketch_bins=64)
    ref.update(jnp.asarray(s), jnp.asarray(y))
    for name in ("num_tp", "num_fp", "num_pos", "num_total"):
        np.testing.assert_array_equal(getattr(port, name).numpy(), np.asarray(getattr(ref, name)))
    _close(port.compute(), ref.compute())
