"""The port's MetricCollection against the JAX package's on the same
streams: ``update`` and ``fused_update`` (the JAX side with its
megakernel forced on in interpret mode and ``donate=False``, the port with
its collection kernel's plain version), bucketed, sliced with
``compute_slices``, merged and reset, and the state_dict round trip, the
JAX state_dict included.  Every state is bit-equal; computed f32 values
agree within 1e-6 relative.  Then the port's own contracts: the
constructor's errors, the atomic ``load_state_dict``, ``fused_update``'s
refusal of buffer states and its abort-restore, ``update()`` never taking
the kernel, and pickling."""

import os
import pickle
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
from torcheval_tpu_torch import metrics as P
from torcheval_tpu_torch.convert import state_from_jax
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.ops import _build

C = 7
RTOL = 1e-6
ON = {"TORCHEVAL_TPU_MEGAKERNEL": "1", "TORCHEVAL_TPU_TORCH_MEGAKERNEL": "1"}


def members(lib, **dev):
    return {
        "acc": lib.MulticlassAccuracy(num_classes=C, average="macro", **dev),
        "acc_micro": lib.MulticlassAccuracy(**dev),
        "f1": lib.MulticlassF1Score(num_classes=C, average="macro", **dev),
        "prec": lib.MulticlassPrecision(num_classes=C, average="weighted", **dev),
        "rec": lib.MulticlassRecall(num_classes=C, average=None, **dev),
        "cm": lib.MulticlassConfusionMatrix(num_classes=C, **dev),
        "topk": lib.MulticlassAccuracy(num_classes=C, k=2, **dev),  # per-member path
    }


def stream(seed, steps=4, slices=None):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        n = int(r.integers(30, 200))
        out.append((
            r.standard_normal((n, C)).astype(np.float32),
            r.integers(0, C, n).astype(np.int32),
            r.integers(0, slices, n).astype(np.int32) if slices else None,
        ))
    return out


def feed(col, batches, method, to):
    for x, y, sids in batches:
        kw = {} if sids is None else {"slice_ids": to(sids)}
        getattr(col, method)(to(x), to(y), **kw)
    return col


def jax_col(batches, method="fused_update", **kw):
    with mock.patch.dict(os.environ, ON):
        return feed(J.MetricCollection(members(J), donate=False, **kw), batches, method,
                    jnp.asarray)


def port_col(batches, method="fused_update", **kw):
    with mock.patch.dict(os.environ, ON):
        return feed(P.MetricCollection(members(P, device="cpu"), **kw), batches, method,
                    torch.from_numpy)


def numpy_state(col):
    return {k: np.asarray(v) for k, v in col.state_dict().items()}


def assert_states_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
        assert g.dtype == want[k].dtype and g.shape == want[k].shape, k
        np.testing.assert_array_equal(g, want[k], k)


def assert_results_close(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_results_close(got[k], want[k])
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("method", ["update", "fused_update"])
@pytest.mark.parametrize("bucket,slices", [(False, None), (True, None), (True, 16)])
def test_states_and_results_match_jax(method, bucket, slices):
    batches = stream(3 + (slices or 0), slices=slices)
    want = jax_col(batches, method, bucket=bucket, slices=slices)
    _build.reset_counts()
    got = port_col(batches, method, bucket=bucket, slices=slices)
    assert _build.PLAIN_CALLS["mega_counts"] == (len(batches) if method == "fused_update" else 0)
    assert not _build.LAUNCHES
    assert_states_equal(got.state_dict(), numpy_state(want))
    assert_results_close(got.compute(), want.compute())
    if slices:
        assert_results_close(got.compute_slices(), want.compute_slices())


def test_merge_reset_and_state_dict_round_trip_match_jax():
    a, b = stream(5, slices=16), stream(6, slices=16)
    ja, jb = jax_col(a, bucket=True, slices=16), jax_col(b, bucket=True, slices=16)
    pa, pb = port_col(a, bucket=True, slices=16), port_col(b, bucket=True, slices=16)
    ja.merge_state([jb])
    pa.merge_state([pb])
    assert_states_equal(pa.state_dict(), numpy_state(ja))
    assert_results_close(pa.compute_slices(), ja.compute_slices())
    # the JAX state_dict, "@k" slice keys included, through convert
    fresh = P.MetricCollection(members(P, device="cpu"), bucket=True, slices=16)
    fresh.load_state_dict(state_from_jax(numpy_state(ja)))
    assert_states_equal(fresh.state_dict(), numpy_state(ja))
    assert any("@15/" in k for k in fresh.state_dict())
    # and the port's own round trip
    again = P.MetricCollection(members(P, device="cpu"), bucket=True, slices=16)
    again.load_state_dict(pa.state_dict())
    assert_states_equal(again.state_dict(), numpy_state(ja))
    ja.reset()
    pa.reset()
    assert_states_equal(pa.state_dict(), numpy_state(ja))


def test_load_state_dict_is_atomic():
    col = port_col(stream(7))
    before = {k: v.clone() for k, v in col.state_dict().items()}
    other = port_col(stream(8)).state_dict()
    # strict errors come before anything loads
    with pytest.raises(RuntimeError, match="Unexpected keys.*nope/x"):
        col.load_state_dict(dict(other, **{"nope/x": torch.zeros(1)}))
    with pytest.raises(RuntimeError, match=r"missing every state of member\(s\) \['cm'\]"):
        col.load_state_dict({k: v for k, v in other.items() if not k.startswith("cm/")})
    # a member that raises after earlier members loaded rolls all of them back
    with pytest.raises(RuntimeError, match="unexpected keys"):
        col.load_state_dict(dict(other, **{"topk/bogus": torch.zeros(1)}))
    assert_states_equal(col.state_dict(), {k: v.numpy() for k, v in before.items()})
    col.load_state_dict(other)
    assert_states_equal(col.state_dict(), {k: v.numpy() for k, v in other.items()})


def test_constructor_errors():
    m = {"cm": P.MulticlassConfusionMatrix(num_classes=C, device="cpu")}
    auroc = {"auroc": P.MulticlassAUROC(num_classes=C, device="cpu")}
    cases = [
        (ValueError, "at least one metric", {}, {}),
        (ValueError, "slice_labels requires slices", m, {"slice_labels": ["a"]}),
        (ValueError, "slices must be >= 1", m, {"slices": 0}),
        (TypeError, "must be Metric instances", {"x": object()}, {}),
        (ValueError, "must not contain '/'", {"a/b": m["cm"]}, {}),
        (ValueError, "must not contain '@'", {"a@b": m["cm"]}, {"slices": 2}),
        (ValueError, "bucket=True requires mask-aware", auroc, {"bucket": True}),
        (ValueError, "slices= requires mask-aware", auroc, {"slices": 2}),
        (ValueError, "must name all 2 slices", m, {"slices": 2, "slice_labels": ["a"]}),
        (ValueError, "must be unique", m, {"slices": 2, "slice_labels": ["a", "a"]}),
    ]
    for exc, msg, metrics, kw in cases:
        with pytest.raises(exc, match=msg):
            P.MetricCollection(metrics, **kw)
    assert P.MetricCollection({"a@b": m["cm"]}) is not None  # "@" is free when unsliced
    col = P.MetricCollection(m, slices=2, slice_labels=["x", "y"])
    assert col.slice_labels == ("x", "y") and col.slices == 2
    with pytest.raises(TypeError, match="must carry slice_ids"):
        col.update(torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.int32))
    with pytest.raises(TypeError, match="unsliced"):
        P.MetricCollection(m).update(torch.zeros(4, dtype=torch.int32),
                                     torch.zeros(4, dtype=torch.int32), slice_ids=torch.zeros(4))
    with pytest.raises(ValueError, match="unsliced"):
        P.MetricCollection(m).compute_slices()


def test_merge_state_refuses_other_shapes():
    a = port_col(stream(9))
    with pytest.raises(ValueError, match="same metric names"):
        a.merge_state([P.MetricCollection({"cm": P.MulticlassConfusionMatrix(
            num_classes=C, device="cpu")})])
    with pytest.raises(ValueError, match="share the slice axis"):
        a.merge_state([P.MetricCollection(members(P, device="cpu"), slices=2)])
    other = members(P, device="cpu")
    other["cm"] = P.MulticlassAccuracy(device="cpu")
    with pytest.raises(ValueError, match="Member 'cm' is MulticlassConfusionMatrix"):
        a.merge_state([P.MetricCollection(other)])


def test_fused_update_refuses_buffer_states():
    col = P.MetricCollection({"auroc": P.MulticlassAUROC(num_classes=C, device="cpu")})
    x, y, _ = stream(10, steps=1)[0]
    with pytest.raises(ValueError, match="fused_update requires tensor states"):
        col.fused_update(torch.from_numpy(x), torch.from_numpy(y))
    col.update(torch.from_numpy(x), torch.from_numpy(y))  # update() takes them


class Boom(Metric[torch.Tensor]):
    """A counter that raises on its second update."""

    _supports_mask = True

    def __init__(self, device="cpu"):
        super().__init__(device=device)
        self._add_state("n", torch.tensor(0))
        self.calls = 0

    def update(self, input, target, *, mask=None):
        self.calls += 1
        if self.calls > 1:
            raise RuntimeError("boom")
        self.n = self.n + 1
        return self

    def compute(self):
        return self.n

    def merge_state(self, metrics):
        return self


@pytest.mark.parametrize("donate", [False, True])
@pytest.mark.parametrize("slices", [None, 3])
def test_fused_update_abort_leaves_every_state_as_it_was(donate, slices):
    ms = members(P, device="cpu")
    ms["boom"] = Boom()  # after the kernel's members and the per-member top-k
    col = P.MetricCollection(ms, bucket=True, slices=slices, donate=donate)
    batches = stream(11, steps=2, slices=slices)
    with mock.patch.dict(os.environ, ON):
        feed(col, batches[:1], "fused_update", torch.from_numpy)
        live = {name: {s: getattr(m, s) for s in m._state_name_to_default}
                for name, m in col._all_members.items()}
        snap = {k: v.clone() for k, v in col.state_dict().items()}
        with pytest.raises(RuntimeError, match="boom"):
            feed(col, batches[1:], "fused_update", torch.from_numpy)
    assert_states_equal(col.state_dict(), {k: v.numpy() for k, v in snap.items()})
    for name, m in col._all_members.items():
        for s in m._state_name_to_default:
            assert getattr(m, s) is live[name][s]


def test_donated_fused_update_is_bit_equal_and_snapshots_never_change():
    batches = stream(12, slices=3)
    plain = port_col(batches, bucket=True, slices=3)
    donated = P.MetricCollection(members(P, device="cpu"), bucket=True, slices=3, donate=True)
    with mock.patch.dict(os.environ, ON):
        feed(donated, batches[:1], "fused_update", torch.from_numpy)
        snap = donated.state_dict()
        frozen = {k: v.clone() for k, v in snap.items()}
        feed(donated, batches[1:], "fused_update", torch.from_numpy)
    assert_states_equal(snap, {k: v.numpy() for k, v in frozen.items()})
    assert_states_equal(donated.state_dict(), numpy_state(plain))


def test_update_never_takes_the_kernel():
    _build.reset_counts()
    col = port_col(stream(13), "update", bucket=True)
    assert not _build.PLAIN_CALLS["mega_counts"] and not _build.LAUNCHES
    assert int(col["cm"].confusion_matrix.sum()) > 0


def test_pickle_round_trip_and_repr():
    col = port_col(stream(14, slices=2), bucket=True, slices=2)
    back = pickle.loads(pickle.dumps(col))
    assert_states_equal(back.state_dict(), numpy_state(col))
    assert repr(back) == repr(col) == (
        "MetricCollection(acc=MulticlassAccuracy, acc_micro=MulticlassAccuracy, "
        "f1=MulticlassF1Score, prec=MulticlassPrecision, rec=MulticlassRecall, "
        "cm=MulticlassConfusionMatrix, topk=MulticlassAccuracy, slices=2)"
    )
    assert back.device == torch.device("cpu") and back.to("cpu") is back
    more = stream(15, steps=1, slices=2)
    feed(back, more, "fused_update", torch.from_numpy)
    feed(col, more, "fused_update", torch.from_numpy)
    assert_states_equal(back.state_dict(), numpy_state(col))
    assert list(col) == list(members(P, device="cpu")) and len(col) == 7
    assert col["cm"] is dict(col.items())["cm"]


def test_numpy_inputs_and_a_caller_mask():
    batches = stream(16)
    r = np.random.default_rng(16)
    masks = [(r.random(len(y)) < 0.6).astype(np.int32) for _, y, _ in batches]
    with mock.patch.dict(os.environ, ON):
        want = J.MetricCollection(members(J), bucket=True, donate=False)
        got = P.MetricCollection(members(P, device="cpu"), bucket=True)
        for (x, y, _), m in zip(batches, masks):
            want.fused_update(jnp.asarray(x), jnp.asarray(y), mask=jnp.asarray(m))
            got.fused_update(x, y, mask=m)
    assert_states_equal(got.state_dict(), numpy_state(want))
