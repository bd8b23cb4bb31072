"""The slice as a whole: the port's Metric lifecycle and AUROC classes
against the JAX classes on the same inputs (1e-6), including a JAX
metric whose state is carried into the port halfway through."""

import pickle
from collections import defaultdict, deque

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.metrics import (
    BinaryAUROC as JaxBinaryAUROC,
    MulticlassAUROC as JaxMulticlassAUROC,
)
from torcheval_tpu_torch.convert import state_from_jax
from torcheval_tpu_torch.metrics import BinaryAUROC, Metric, MulticlassAUROC
from torcheval_tpu_torch.ops import _build
from torcheval_tpu_torch.telemetry import events

CPU = "cpu"


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=1e-6)


def _batches(seed, num_classes, total=2**15, updates=8):
    rng = np.random.default_rng(seed)
    s = rng.random((total, num_classes)).astype(np.float32)
    y = rng.integers(0, num_classes, total).astype(np.int32)
    return list(zip(np.split(s, updates), np.split(y, updates)))


def _numpy_state(jax_metric):
    return {
        k: [np.asarray(a) for a in v] if isinstance(v, list) else np.asarray(v)
        for k, v in jax_metric.state_dict().items()
    }


@pytest.mark.parametrize(
    "num_classes,route", [(200, "rank_sum_counts"), (16, "auc_from_sorted")]
)
def test_multiclass_lifecycle_matches_jax(num_classes, route):
    # 200 classes over 2^15 samples: the largest class holds ~210, so the
    # rank-sum route takes cap 256; 16 classes (~2^11 each) sort.
    batches = _batches(num_classes, num_classes)
    port = MulticlassAUROC(num_classes=num_classes, average=None, device=CPU)
    ref = JaxMulticlassAUROC(num_classes=num_classes, average=None)
    for s, y in batches:
        port.update(torch.from_numpy(s), torch.from_numpy(y))
        ref.update(jnp.asarray(s), jnp.asarray(y))
    _build.reset_counts()
    got = port.compute()
    assert dict(_build.PLAIN_CALLS) == {route: 1}
    _close(got, ref.compute())

    # merge_state: two halves merged equal the whole.
    a = MulticlassAUROC(num_classes=num_classes, average=None, device=CPU)
    b = MulticlassAUROC(num_classes=num_classes, average=None, device=CPU)
    for i, (s, y) in enumerate(batches):
        (a if i < 4 else b).update(s, y)
    b._prepare_for_merge_state()
    assert len(b.inputs) == 1
    assert torch.equal(a.merge_state([b]).compute(), got)
    assert len(b.inputs) == 1  # the source is unchanged

    # state_dict round trip and pickling carry the buffers unchanged.
    fresh = MulticlassAUROC(num_classes=num_classes, average=None, device=CPU)
    fresh.load_state_dict(port.state_dict())
    unpickled = pickle.loads(pickle.dumps(port))
    for other in (fresh, unpickled):
        for name in ("inputs", "targets"):
            assert torch.equal(torch.cat(getattr(other, name)), torch.cat(getattr(port, name)))
    assert unpickled.device == torch.device("cpu") and unpickled.average is None

    port.reset()
    assert port.inputs == [] and port.compute().numel() == 0


def test_jax_state_continues_in_the_port():
    batches = _batches(1, 200)
    ref = JaxMulticlassAUROC(num_classes=200)
    for s, y in batches[:4]:
        ref.update(jnp.asarray(s), jnp.asarray(y))
    port = MulticlassAUROC(num_classes=200, device=CPU)
    port.load_state_dict(state_from_jax(_numpy_state(ref)))
    for s, y in batches[4:]:
        ref.update(jnp.asarray(s), jnp.asarray(y))
        port.update(s, y)
    assert port.inputs[0].dtype == torch.float32 and port.targets[0].dtype == torch.int32
    _close(port.compute(), ref.compute())


@pytest.mark.parametrize("num_tasks", [1, 2])
def test_binary_lifecycle_matches_jax(num_tasks):
    rng = np.random.default_rng(num_tasks)
    shape = (num_tasks, 250) if num_tasks > 1 else (250,)
    port = BinaryAUROC(num_tasks=num_tasks, device=CPU)
    ref = JaxBinaryAUROC(num_tasks=num_tasks)
    for _ in range(4):
        s = (np.floor(rng.random(shape) * 64) / 64).astype(np.float32)
        y = (rng.random(shape) < 0.3).astype(np.int32)
        port.update(s, y)
        ref.update(jnp.asarray(s), jnp.asarray(y))
    _close(port.compute(), ref.compute())
    other = BinaryAUROC(num_tasks=num_tasks, device=CPU)
    other.load_state_dict(state_from_jax(_numpy_state(ref)))
    _close(other.compute(), ref.compute())


def test_sketch_mode_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="sketch"):
        MulticlassAUROC(num_classes=4, device=CPU, sketch=True)
    with pytest.raises(NotImplementedError, match="sketch"):
        BinaryAUROC(device=CPU, sketch=True)


class _Counters(Metric[torch.Tensor]):
    def __init__(self, **kwargs):
        super().__init__(**kwargs)
        self._add_state("total", torch.tensor(0.0))
        self._add_state("seen", deque(maxlen=2))
        self._add_state("by_key", defaultdict(lambda: torch.tensor(0.0)))

    def update(self, x):
        self.total = self.total + torch.as_tensor(x).sum()
        self.seen.append(torch.as_tensor(x))
        self.by_key["a"] = self.by_key["a"] + 1
        return self

    def compute(self):
        return self.total

    def merge_state(self, metrics):
        for m in metrics:
            self.total = self.total + m.total.to(self.device)
        return self


def test_metric_base_lifecycle():
    m = _Counters(device=CPU).update([1.0, 2.0]).update([3.0])
    snap = m.state_dict()
    m.update([10.0])
    assert float(snap["total"]) == 6.0  # the snapshot does not alias
    assert isinstance(snap["seen"], list) and len(m.seen) == 2
    restored = _Counters(device=CPU)
    restored.load_state_dict(snap)
    assert float(restored.compute()) == 6.0 and restored.seen.maxlen == 2
    with pytest.raises(RuntimeError, match="missing keys"):
        restored.load_state_dict({"total": torch.tensor(1.0)})
    clone = pickle.loads(pickle.dumps(m))
    assert float(clone.compute()) == 16.0 and isinstance(clone.by_key, defaultdict)
    m.reset()
    assert float(m.total) == 0.0 and len(m.seen) == 0 and dict(m.by_key) == {}
    assert m.to("cpu").device == torch.device("cpu")
    with pytest.raises(TypeError):
        m._add_state("bad", [1.0])


def test_telemetry_spans(monkeypatch):
    monkeypatch.setattr(events, "ENABLED", True)
    events.clear()
    m = _Counters(device=CPU).update([1.0, 2.0])
    m.compute()
    spans = events.events("span")
    assert [(s.phase, s.name) for s in spans] == [("update", "_Counters"), ("compute", "_Counters")]
    assert spans[0].state_bytes > 0 and all(s.seconds >= 0 for s in spans)
    assert set(events.aggregates()["spans"]) == {("_Counters", "update"), ("_Counters", "compute")}
    events.clear()
