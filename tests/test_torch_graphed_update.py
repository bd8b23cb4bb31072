"""The split of a graph-eligible member's ``update`` into ``_validate``
(every check, with its read backs) and ``_update_body`` (device work
only), and ``MetricCollection.update``'s choice of path, on the CPU.

Each eligible class's ``update`` is its ``_validate`` then its
``_update_body``: the same states bit for bit, the same read backs by site
and, on a bad batch, the same exception from ``_validate`` with no state
written.  A collection on the CPU, a sliced one and one with no eligible
member never reach the graph path (the member-update counter says
``eager``).  The collection's order on that path, all checks before any
eligible state is written, is held here with a stand-in for the captured
graph that runs the same bodies eagerly; the replay itself is held against
the eager path on the card (``tests/test_torch_cuda.py``).

A ring window's ``update`` is ``_validate``, then ``_update_body`` at its
cursor given as a device index, then the host bookkeeping
``_update_host``: the same states, cursor, fill level and counters bit for
bit through wraps, oversized batches, merges, resets and loads of a JAX
``state_dict``."""

import copy
import pickle
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from torcheval_tpu_torch import _stats
from torcheval_tpu_torch import metrics as P
from torcheval_tpu_torch.convert import state_from_jax
from torcheval_tpu_torch.metrics._buffer import RingWindowMixin
from torcheval_tpu_torch.metrics._graphs import (
    GraphedUpdate,
    GraphPrograms,
    Program,
    clone_states,
    install_states,
    read_states,
)
from torcheval_tpu_torch.metrics.functional._host_checks import CheckQueue, value_check
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.telemetry import events

C = 7
N = 96


def _rng(seed):
    return np.random.default_rng(seed)


def _multiclass(seed, n=N):
    r = _rng(seed)
    return (torch.from_numpy(r.standard_normal((n, C)).astype(np.float32)),
            torch.from_numpy(r.integers(0, C, n).astype(np.int64)))


def _labels(seed, n=N):
    r = _rng(seed)
    return (torch.from_numpy(r.integers(0, C, n).astype(np.int64)),
            torch.from_numpy(r.integers(0, C, n).astype(np.int64)))


def _binary(seed, n=N):
    r = _rng(seed)
    return (torch.from_numpy(r.random(n).astype(np.float32)),
            torch.from_numpy(r.integers(0, 2, n).astype(np.int64)))


def _multilabel(seed, n=N):
    r = _rng(seed)
    return (torch.from_numpy(r.random((n, C)).astype(np.float32)),
            torch.from_numpy(r.integers(0, 2, (n, C)).astype(np.int64)))


def _mask(seed, n=N):
    return torch.from_numpy((_rng(seed + 100).random(n) < 0.7).astype(np.int32))


def _bad_target(args, upper):
    x, y = args
    y = y.clone()
    y[3] = upper
    return (x, y)


# (id, factory(device), batch(seed) -> (args, kwargs), bad batch(seed) or None)
CASES = [
    ("top1", lambda d: P.MulticlassAccuracy(device=d),
     lambda s: (_multiclass(s), {"mask": _mask(s)}), None),
    ("top2", lambda d: P.MulticlassAccuracy(k=2, device=d),
     lambda s: (_multiclass(s), {}), lambda s: (_bad_target(_multiclass(s), C), {})),
    ("acc_macro", lambda d: P.MulticlassAccuracy(average="macro", num_classes=C, device=d),
     lambda s: (_labels(s), {"mask": _mask(s)}), lambda s: (_bad_target(_labels(s), C), {})),
    ("binary_acc", lambda d: P.BinaryAccuracy(threshold=0.4, device=d),
     lambda s: (_binary(s), {}), None),
    ("multilabel_acc", lambda d: P.MultilabelAccuracy(criteria="hamming", device=d),
     lambda s: (_multilabel(s), {"mask": _mask(s)}), None),
    ("topk_multilabel_acc", lambda d: P.TopKMultilabelAccuracy(k=2, device=d),
     lambda s: (_multilabel(s), {}), None),
    ("f1_macro", lambda d: P.MulticlassF1Score(num_classes=C, average="macro", device=d),
     lambda s: (_multiclass(s), {"mask": _mask(s)}),
     lambda s: (_bad_target(_multiclass(s), C), {})),
    ("binary_f1", lambda d: P.BinaryF1Score(device=d), lambda s: (_binary(s), {}), None),
    ("cm", lambda d: P.MulticlassConfusionMatrix(C, device=d),
     lambda s: (_labels(s), {"mask": _mask(s)}), lambda s: (_bad_target(_labels(s), C), {})),
    ("binary_cm", lambda d: P.BinaryConfusionMatrix(device=d),
     lambda s: (_binary(s), {}), lambda s: (_bad_target(_binary(s), 2), {})),
    ("precision", lambda d: P.MulticlassPrecision(num_classes=C, average="weighted", device=d),
     lambda s: (_labels(s), {}), lambda s: (_bad_target(_labels(s), C), {})),
    ("binary_precision", lambda d: P.BinaryPrecision(device=d), lambda s: (_binary(s), {}),
     None),
    ("recall", lambda d: P.MulticlassRecall(num_classes=C, average=None, device=d),
     lambda s: (_multiclass(s), {"mask": _mask(s)}),
     lambda s: (_bad_target(_multiclass(s), C), {})),
    ("binary_recall", lambda d: P.BinaryRecall(device=d), lambda s: (_binary(s), {}), None),
    ("ne", lambda d: P.BinaryNormalizedEntropy(device=d), lambda s: (_binary(s), {}),
     lambda s: ((_binary(s)[0] + 1.0, _binary(s)[1]), {})),
    ("ne_weighted", lambda d: P.BinaryNormalizedEntropy(num_tasks=2, device=d),
     lambda s: ((torch.stack([_binary(s)[0], _binary(s + 1)[0]]),
                 torch.stack([_binary(s)[1], _binary(s + 1)[1]])),
                {"weight": torch.from_numpy(_rng(s).random((2, N)).astype(np.float32))}),
     None),
    ("ctr", lambda d: P.ClickThroughRate(device=d), lambda s: ((_binary(s)[1],), {}),
     lambda s: ((_binary(s)[1] * 2,), {})),
    ("ctr_weighted", lambda d: P.ClickThroughRate(device=d),
     lambda s: ((_binary(s)[1].float(), torch.from_numpy(_rng(s).random(N).astype(np.float32))),
                {}), None),
]
IDS = [c[0] for c in CASES]
BAD = [c for c in CASES if c[3] is not None]


def _tasks(seed, n, tasks=2):
    x, y = zip(*(_binary(seed + k, n) for k in range(tasks)))
    return torch.stack(x), torch.stack(y)


def _weights(seed, shape):
    return torch.from_numpy(_rng(seed + 200).random(shape).astype(np.float32))


# The ring windows: (id, factory(device), batch(seed, n) -> (args, kwargs),
# bad batch(seed)).  The AUROC ring holds 100 samples, so batches of 32
# wrap mid-batch; the per-update rings hold 3 columns.
RING_CASES = [
    ("window_auroc", lambda d: P.WindowedBinaryAUROC(max_num_samples=100, device=d),
     lambda s, n: (_binary(s, n), {}), lambda s: ((_binary(s)[0][:-1], _binary(s)[1]), {})),
    ("window_auroc_tasks",
     lambda d: P.WindowedBinaryAUROC(num_tasks=2, max_num_samples=100, device=d),
     lambda s, n: ((_tasks(s, n)[0], _tasks(s, n)[1].float()), {}),
     lambda s: (_binary(s), {})),
    ("window_ne", lambda d: P.WindowedBinaryNormalizedEntropy(max_num_updates=3, device=d),
     lambda s, n: (_binary(s, n), {}), lambda s: ((_binary(s)[0] + 1.0, _binary(s)[1]), {})),
    ("window_ne_weighted", lambda d: P.WindowedBinaryNormalizedEntropy(
        num_tasks=2, max_num_updates=3, enable_lifetime=False, device=d),
     lambda s, n: (_tasks(s, n), {"weight": _weights(s, (2, n))}),
     lambda s: (_tasks(s, N), {"weight": _weights(s, (2, N - 1))})),
    ("window_calibration", lambda d: P.WindowedWeightedCalibration(max_num_updates=3, device=d),
     lambda s, n: ((*_binary(s, n), 0.5), {}),
     lambda s: ((*_binary(s), _weights(s, (N - 1,))), {})),
    ("window_calibration_weighted", lambda d: P.WindowedWeightedCalibration(
        num_tasks=2, max_num_updates=3, device=d),
     lambda s, n: ((*_tasks(s, n), _weights(s, (2, n))), {}),
     lambda s: ((*_binary(s), 1.0), {})),
    ("window_ctr", lambda d: P.WindowedClickThroughRate(max_num_updates=3, device=d),
     lambda s, n: ((_binary(s, n)[1].float(),), {}), lambda s: ((_binary(s)[1] * 2,), {})),
    ("window_ctr_weighted", lambda d: P.WindowedClickThroughRate(
        max_num_updates=3, enable_lifetime=False, device=d),
     lambda s, n: ((_binary(s, n)[1], _weights(s, (n,))), {}),
     lambda s: ((_binary(s)[1], _weights(s, (N, 2))), {})),
]
RING_IDS = [c[0] for c in RING_CASES]


def _monitor(device):
    """``criteo.window``'s first collection, at test sizes."""
    return {
        "auroc": P.WindowedBinaryAUROC(max_num_samples=100, device=device),
        "ne": P.WindowedBinaryNormalizedEntropy(max_num_updates=3, device=device),
        "calibration": P.WindowedWeightedCalibration(max_num_updates=3, device=device),
    }


def _states(m):
    return {k: v.clone() for k, v in m.state_dict().items()}


def _assert_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if isinstance(w, list):  # a sample buffer
            assert len(g) == len(w) and all(torch.equal(a, b) for a, b in zip(g, w)), k
        else:
            assert g.dtype == w.dtype and torch.equal(g, w), k


def _readbacks(fn):
    before = _stats.readback_counts()
    fn()
    after = _stats.readback_counts()
    return {k: n - before.get(k, 0) for k, n in after.items() if n != before.get(k, 0)}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_update_is_validate_then_body(case):
    _, make, batch, _ = case
    whole, split = make("cpu"), make("cpu")
    assert type(whole)._graph_update
    for seed in (1, 2, 3):
        args, kwargs = batch(seed)
        reads_whole = _readbacks(lambda: whole.update(*args, **kwargs))

        def halves():
            split._validate(*args, **kwargs)
            split._update_body(*args, **kwargs)

        assert _readbacks(halves) == reads_whole
        _assert_equal(_states(split), _states(whole))


@pytest.mark.parametrize("case", BAD, ids=[c[0] for c in BAD])
def test_a_bad_batch_raises_from_validate_and_writes_nothing(case):
    _, make, batch, bad = case
    whole, split = make("cpu"), make("cpu")
    args, kwargs = batch(5)
    whole.update(*args, **kwargs)
    split.update(*args, **kwargs)
    want = _states(whole)
    bad_args, bad_kwargs = bad(6)
    with pytest.raises(ValueError) as from_update:
        whole.update(*bad_args, **bad_kwargs)
    with pytest.raises(ValueError) as from_validate:
        split._validate(*bad_args, **bad_kwargs)
    assert str(from_validate.value) == str(from_update.value)
    _assert_equal(_states(whole), want)
    _assert_equal(_states(split), want)


def _ring_split_update(m, args, kwargs):
    """``update``'s three parts by hand, the start a tensor of the cursor;
    the graph's ``_advance_start`` moves that tensor to the cursor that
    ``_update_host`` leaves."""
    m._validate(*args, **kwargs)
    start = torch.tensor(m.next_inserted, dtype=torch.int64)
    m._update_body(start, *args, **kwargs)
    m._update_host(*args, **kwargs)
    m._advance_start(start, *args, **kwargs)
    assert int(start) == m.next_inserted


# Each scenario: the steps both metrics take, ("update", seed, n) or an
# operation on both ("merge", "reset", "load" of a JAX-layout state_dict).
RING_SCENARIOS = {
    "wrap": [("update", s, 32) for s in range(5)],
    "oversized": [("update", 0, 32), ("update", 1, 32), ("update", 2, 130), ("update", 3, 32),
                  ("update", 4, 70)],
    "merge": [("update", 0, 32), ("update", 1, 32), ("merge",), ("update", 2, 32),
              ("update", 3, 32), ("update", 4, 32)],
    "reset": [("update", 0, 32), ("update", 1, 32), ("update", 2, 32), ("reset",),
              ("update", 3, 32), ("update", 4, 32)],
    "load": [("update", 0, 32), ("load",), ("update", 1, 32), ("update", 2, 32),
             ("update", 3, 32)],
}


@pytest.mark.parametrize("scenario", list(RING_SCENARIOS))
@pytest.mark.parametrize("case", RING_CASES, ids=RING_IDS)
def test_ring_update_is_validate_then_body_at_the_cursor_then_bookkeeping(case, scenario):
    _, make, batch, _ = case
    whole, split = make("cpu"), make("cpu")
    assert type(whole)._graph_update and isinstance(whole, RingWindowMixin)
    donor = make("cpu")
    for seed in (40, 41, 42, 43):  # mid-wrap: a cursor inside the ring
        donor.update(*batch(seed, 32)[0], **batch(seed, 32)[1])
    for step in RING_SCENARIOS[scenario]:
        if step[0] == "update":
            args, kwargs = batch(step[1], step[2])
            reads_whole = _readbacks(lambda: whole.update(*args, **kwargs))
            assert _readbacks(lambda: _ring_split_update(split, args, kwargs)) == reads_whole
        elif step[0] == "merge":
            whole.merge_state([donor])
            split.merge_state([donor])
        elif step[0] == "reset":
            whole.reset()
            split.reset()
        else:
            jax_layout = {k: v.numpy() for k, v in donor.state_dict().items()}
            assert jax_layout["window_bookkeeping"].dtype == np.int64
            whole.load_state_dict(state_from_jax(jax_layout))
            split.load_state_dict(state_from_jax(jax_layout))
        # state_dict carries the cursor, fill level and counters too.
        _assert_equal(_states(split), _states(whole))
    assert whole.next_inserted == split.next_inserted and whole._num_valid == split._num_valid


@pytest.mark.parametrize("case", RING_CASES, ids=RING_IDS)
def test_a_bad_ring_batch_raises_from_validate_and_moves_nothing(case):
    _, make, batch, bad = case
    whole, split = make("cpu"), make("cpu")
    for seed in (5, 6):
        args, kwargs = batch(seed, 32)
        whole.update(*args, **kwargs)
        split.update(*args, **kwargs)
    want = _states(whole)
    bad_args, bad_kwargs = bad(7)
    with pytest.raises(ValueError) as from_update:
        whole.update(*bad_args, **bad_kwargs)
    with pytest.raises(ValueError) as from_validate:
        split._validate(*bad_args, **bad_kwargs)
    assert str(from_validate.value) == str(from_update.value)
    _assert_equal(_states(whole), want)
    _assert_equal(_states(split), want)


def test_eligibility_is_a_class_attribute_a_redefined_update_drops():
    eligible = {type(c[1]("cpu")) for c in CASES + RING_CASES}
    assert all(cls._graph_update for cls in eligible)
    assert {cls for cls in eligible if issubclass(cls, RingWindowMixin)} == {
        P.WindowedBinaryAUROC, P.WindowedBinaryNormalizedEntropy,
        P.WindowedWeightedCalibration, P.WindowedClickThroughRate}
    # The windowed MSE sizes its rings on its first update: not eligible.
    for m in (P.BinaryAUROC(device="cpu"), P.MulticlassAUROC(num_classes=C, device="cpu"),
              P.WindowedMeanSquaredError(max_num_updates=4, device="cpu"),
              P.Sum(device="cpu")):
        assert not m._graph_update, type(m).__name__

    class Reads(P.MulticlassAccuracy):
        def update(self, input, target, *, mask=None):
            float(input.sum())  # a host read outside the checks
            return super().update(input, target, mask=mask)

    class Declared(P.MulticlassAccuracy):
        _graph_update = True

        def update(self, input, target, *, mask=None):
            return super().update(input, target, mask=mask)

    assert not Reads._graph_update and Declared._graph_update
    assert Metric._graph_update is False


def _counted(fn):
    _stats.reset_member_update_counts()
    fn()
    return _stats.member_update_counts()


def _imagenet_like(device):
    return {
        "top1": P.MulticlassAccuracy(device=device),
        "top5": P.MulticlassAccuracy(k=5, device=device),
        "f1": P.MulticlassF1Score(num_classes=C, average="macro", device=device),
        "cm": P.MulticlassConfusionMatrix(C, device=device),
        "auroc": P.MulticlassAUROC(num_classes=C, device=device),
    }


def test_collections_on_the_cpu_and_sliced_or_windowed_ones_update_eagerly():
    x, y = _multiclass(11)
    col = P.MetricCollection(_imagenet_like("cpu"))
    assert list(col._graphed) == ["top1", "top5", "f1", "cm"]
    assert _counted(lambda: [col.update(x, y) for _ in range(3)]) == {"eager": 15}
    assert col._graphs is None

    sliced = P.MetricCollection(
        {"acc": P.MulticlassAccuracy(device="cpu"), "cm": P.MulticlassConfusionMatrix(C, device="cpu")},
        slices=3)
    assert not sliced._graphed
    ids = torch.from_numpy(_rng(12).integers(0, 3, N).astype(np.int32))
    assert _counted(lambda: sliced.update(x, y, slice_ids=ids)) == {"eager": 8}

    s, t = _binary(13)
    windowed = P.MetricCollection({
        "auroc": P.WindowedBinaryAUROC(max_num_samples=256, device="cpu"),
        "ne": P.WindowedBinaryNormalizedEntropy(max_num_updates=4, device="cpu"),
        "mse": P.WindowedMeanSquaredError(max_num_updates=4, device="cpu"),
    })
    assert list(windowed._graphed) == ["auroc", "ne"]
    assert _counted(lambda: windowed.update(s, t)) == {"eager": 3}
    assert windowed._graphs is None

    fused = P.MetricCollection({"acc": P.MulticlassAccuracy(device="cpu")})
    assert _counted(lambda: fused.fused_update(x, y)) == {}


def test_graph_key_refuses_a_cpu_batch():
    members = {"acc": P.MulticlassAccuracy(device="cpu")}
    graphs = GraphedUpdate(members)
    assert graphs.name == "graph[acc].update"
    assert graphs.key(_multiclass(14), {}, graphs.read()) is None


def test_the_ring_members_are_decided_once_from_the_member_classes():
    assert GraphedUpdate({"acc": P.BinaryAccuracy(device="cpu"),
                          "ne": P.BinaryNormalizedEntropy(device="cpu")})._rings == ()
    members = dict(_monitor("cpu"), acc=P.BinaryAccuracy(device="cpu"))
    assert GraphedUpdate(members)._rings == ("auroc", "ne", "calibration")


class _NoGraph:
    def replay(self):
        pass


@pytest.mark.parametrize("held", ["views", "clone", "other"])
def test_a_call_decides_once_what_the_members_hold_of_the_state_buffer(held, monkeypatch):
    # The buffer's views keep the states' key and copy nothing in; its
    # last clone keeps the key and copies one flat buffer a dtype; other
    # tensors get a new signature and one multi-tensor copy of every
    # state.  The replay sequence runs on the CPU around a graph that
    # does nothing, so the members come out holding what they held.
    cpu = torch.device("cpu")
    members = {"acc": P.MulticlassAccuracy(device="cpu"),
               "cm": P.MulticlassConfusionMatrix(C, device="cpu")}
    x, y = _multiclass(61)
    for m in members.values():
        m.update(x, y)
    want = {name: m.state_dict() for name, m in members.items()}
    programs = GraphPrograms("collection_update", members)
    first = read_states(members)
    key = programs.states_key(first, cpu)
    buffer = programs.buffer(key, first, cpu)
    buffer.copy_in(first, None)
    install_states(members, {"views": buffer.views, "clone": buffer.cloned(),
                             "other": clone_states(first)}[held])
    current = read_states(members)
    got = programs.states_key(current, cpu)
    assert got == key and (got is key) == (held != "other")

    copies = []
    foreach_copy, copy_ = torch._foreach_copy_, torch.Tensor.copy_

    def counted_foreach(dst, src):
        copies.append(("foreach", len(dst)))
        return foreach_copy(dst, src)

    def counted_copy(dst, src, *a, **kw):
        copies.append(("copy", dst.dtype))
        return copy_(dst, src, *a, **kw)

    monkeypatch.setattr(torch, "_foreach_copy_", counted_foreach)
    monkeypatch.setattr(torch.Tensor, "copy_", counted_copy)
    program = Program(_NoGraph(), [torch.empty_like(x), torch.empty_like(y)], buffer, Counter(), None)
    programs.replay(program, (x, y), {}, current)
    monkeypatch.undo()
    assert copies[0] == ("foreach", 2)  # the batch into the static inputs
    assert copies[1:] == {"views": [], "clone": [("copy", dt) for dt in buffer.flats],
                          "other": [("foreach", 3)]}[held]
    assert len(buffer.flats) == 2
    for name, m in members.items():
        _assert_equal(m.state_dict(), want[name])
    # No donation: the members hold a new clone, none of the tensors they held.
    after = read_states(members)
    assert all(after[n][s] is not v for n, per in current.items() for s, v in per.items())


class _EagerGraphs(GraphedUpdate):
    """The collection's graph path with the bodies run eagerly in place of
    the replay: its order of checks, state writes and ring bookkeeping, on
    the CPU (ring members read their start from one tensor filled from
    their cursors, as the replay does)."""

    def key(self, args, kwargs, current):
        return ("cpu",)

    def run(self, key, args, kwargs, current):
        starts = torch.tensor([self._members[n].next_inserted for n in self._rings],
                              dtype=torch.int64)
        for name, m in self._members.items():
            if name in self._rings:
                m._update_body(starts[self._rings.index(name)], *args, **kwargs)
            else:
                m._update_body(*args, **kwargs)
        for name in self._rings:
            self._members[name]._update_host(*args, **kwargs)
        _stats.count_member_updates("replay", len(self._members))


def _on_graph_path(col):
    col._graphs = _EagerGraphs(col._graphed)
    return col


def test_the_graph_path_checks_every_member_before_writing_any():
    eager = P.MetricCollection(_imagenet_like("cpu"))
    graphed = _on_graph_path(P.MetricCollection(_imagenet_like("cpu")))
    for seed in (21, 22):
        x, y = _multiclass(seed)
        eager.update(x, y)
        assert _counted(lambda: graphed.update(x, y)) == {"replay": 4, "eager": 1}
    _assert_equal(graphed.state_dict(), eager.state_dict())

    # A label past the classes: top-5's check is the first to fail.  The
    # eager path has written top-1 by then; the graph path writes nothing.
    before = graphed.state_dict()
    x, y = _bad_target(_multiclass(23), C)
    with pytest.raises(ValueError) as on_graph:
        graphed.update(x, y)
    with pytest.raises(ValueError) as on_eager:
        eager.update(x, y)
    assert str(on_graph.value) == str(on_eager.value)
    _assert_equal(graphed.state_dict(), before)
    assert not torch.equal(eager["top1"].num_total, graphed["top1"].num_total)


def test_the_graph_path_keeps_the_ineligible_members_order():
    # An ineligible member ahead of the eligible ones updates first, as on
    # the eager path, and its failure stops the call before any replay.
    def members():
        return {"auroc": P.BinaryAUROC(device="cpu"), "ne": P.BinaryNormalizedEntropy(device="cpu"),
                "acc": P.BinaryAccuracy(device="cpu")}

    eager = P.MetricCollection(members())
    graphed = _on_graph_path(P.MetricCollection(members()))
    s, t = _binary(31)
    eager.update(s, t)
    graphed.update(s, t)
    _assert_equal(graphed.state_dict(), eager.state_dict())
    before = graphed.state_dict()
    bad = (s + 1.0, t)  # probabilities past 1: the entropy's check
    with pytest.raises(ValueError) as on_graph:
        graphed.update(*bad)
    with pytest.raises(ValueError) as on_eager:
        eager.update(*bad)
    assert str(on_graph.value) == str(on_eager.value)
    for name in ("ne", "acc"):
        _assert_equal(graphed[name].state_dict(), {
            k.split("/", 1)[1]: v for k, v in before.items() if k.startswith(name + "/")})


def test_the_graph_path_checks_every_ring_before_writing_or_moving_any():
    # The monitor's rings on the graph path against their own updates,
    # through wraps; then a batch whose probabilities pass 1 fails the
    # entropy's check (the second member): the eager path has written the
    # AUROC ring and moved its cursor by then, the graph path neither.
    eager = _monitor("cpu")
    graphed = _on_graph_path(P.MetricCollection(_monitor("cpu")))
    for seed in range(50, 57):
        s, t = _binary(seed, 32)
        for m in eager.values():
            m.update(s, t)
        assert _counted(lambda: graphed.update(s, t)) == {"replay": 3}
    for name, m in eager.items():
        _assert_equal(graphed[name].state_dict(), m.state_dict())
    before = graphed.state_dict()
    s, t = _binary(57, 32)
    with pytest.raises(ValueError) as on_graph:
        graphed.update(s + 1.0, t)
    with pytest.raises(ValueError) as on_eager:
        for m in eager.values():
            m.update(s + 1.0, t)
    assert str(on_graph.value) == str(on_eager.value)
    _assert_equal(graphed.state_dict(), before)
    assert eager["auroc"].total_samples == graphed["auroc"].total_samples + 32


def test_pickled_and_copied_collections_leave_their_graphs_behind():
    col = _on_graph_path(P.MetricCollection(_imagenet_like("cpu")))
    col.update(*_multiclass(41))
    for other in (pickle.loads(pickle.dumps(col)), copy.deepcopy(col)):
        assert other._graphs is None and list(other._graphed) == list(col._graphed)
        _assert_equal(other.state_dict(), col.state_dict())


# ------------------------------------------------- the queued value checks
class _Ops(TorchDispatchMode):
    """The aten operations run inside the block, by name, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def _checked(fn):
    """``fn()``'s read backs by site, aminmax calls and stacked-check counts."""
    _stats.reset_stacked_check_counts()
    with _Ops() as ops:
        reads = _readbacks(fn)
    return reads, ops.ops.count("aten.aminmax"), _stats.stacked_check_counts()


def test_the_graph_path_reads_the_eligible_members_checks_back_once():
    # Top-5, F1 and the matrix each check the same target: one aminmax and
    # one read back a call, where each member's own update makes its own.
    eager = P.MetricCollection(_imagenet_like("cpu"))
    graphed = _on_graph_path(P.MetricCollection(_imagenet_like("cpu")))
    for seed in (71, 72, 73):
        x, y = _multiclass(seed)
        assert _checked(lambda: eager.update(x, y)) == (
            {"accuracy": 1, "f1_score": 1, "confusion_matrix": 1}, 3, {})
        assert _checked(lambda: graphed.update(x, y)) == (
            {"collection_checks": 1}, 1, {"requests": 3, "reads": 1})
    _assert_equal(graphed.state_dict(), eager.state_dict())
    _stats.reset_stacked_check_counts()
    assert _stats.stacked_check_counts() == {}


def _labels_first(device):
    return {
        "cm": P.MulticlassConfusionMatrix(C, device=device),
        "f1": P.MulticlassF1Score(num_classes=C, average="macro", device=device),
        "acc": P.MulticlassAccuracy(average="macro", num_classes=C, device=device),
    }


def _f1_first(device):
    return {
        "f1": P.MulticlassF1Score(num_classes=C, average="macro", device=device),
        "top5": P.MulticlassAccuracy(k=5, device=device),
        "cm": P.MulticlassConfusionMatrix(C, device=device),
    }


def _binary_members(device):
    return {
        "acc": P.BinaryAccuracy(device=device),
        "ne": P.BinaryNormalizedEntropy(device=device),
        "bcm": P.BinaryConfusionMatrix(device=device),
    }


def _with(args, i, value, at=3):
    args = tuple(a.clone() for a in args)
    args[i][at] = value
    return args


# (id, members(device), good batch(seed), bad batch(seed)): the bad value
# fails the first member that checks it.
FIRST_TO_FAIL = [
    ("top5_target_past_c", _imagenet_like, _multiclass, lambda s: _with(_multiclass(s), 1, C)),
    ("negative_target", _imagenet_like, _multiclass, lambda s: _with(_multiclass(s), 1, -1)),
    ("f1_target_past_c", _f1_first, _multiclass, lambda s: _with(_multiclass(s), 1, C + 2)),
    ("cm_input_past_c", _labels_first, _labels, lambda s: _with(_labels(s), 0, C)),
    ("ne_past_one", _binary_members, _binary, lambda s: (_binary(s)[0] + 1.0, _binary(s)[1])),
    ("bcm_target_past_one", _binary_members, _binary, lambda s: _with(_binary(s), 1, 2)),
]


@pytest.mark.parametrize("case", FIRST_TO_FAIL, ids=[c[0] for c in FIRST_TO_FAIL])
def test_the_first_failing_queued_check_raises_the_eager_message_and_writes_nothing(case):
    _, members, good, bad = case
    eager = P.MetricCollection(members("cpu"))
    graphed = _on_graph_path(P.MetricCollection(members("cpu")))
    for seed in (81, 82):
        eager.update(*good(seed))
        assert _checked(lambda: graphed.update(*good(seed)))[2]["reads"] == 1
    before = graphed.state_dict()
    args = bad(83)
    with pytest.raises(ValueError) as on_graph:
        graphed.update(*args)
    with pytest.raises(ValueError) as on_eager:
        eager.update(*args)
    assert str(on_graph.value) == str(on_eager.value)
    assert on_graph.value.__suppress_context__ or on_graph.value.__context__ is None
    _assert_equal(graphed.state_dict(), before)


@pytest.mark.parametrize("later_fails", [False, True])
def test_an_earlier_members_value_check_beats_a_later_members_shape_check(later_fails):
    # F1 built for C + 1 classes refuses (N, C) logits by their shape; top-5,
    # ahead of it, queues its range check first.
    def members():
        return {"top5": P.MulticlassAccuracy(k=5, device="cpu"),
                "f1": P.MulticlassF1Score(num_classes=C + 1, average="macro", device="cpu")}

    graphed = _on_graph_path(P.MetricCollection(members()))
    eager = P.MetricCollection(members())
    x, y = _multiclass(91)
    if not later_fails:
        y = _with((y,), 0, C)[0]
    _stats.reset_stacked_check_counts()
    with pytest.raises(ValueError) as on_graph:
        graphed.update(x, y)
    with pytest.raises(ValueError) as on_eager:
        eager.update(x, y)
    assert str(on_graph.value) == str(on_eager.value)
    assert str(on_graph.value).startswith("input should have shape" if later_fails else "target")
    assert _stats.stacked_check_counts() == {"requests": 1, "reads": 1}
    assert int(graphed["top5"].num_total) == 0


def test_an_ineligible_member_runs_after_the_pending_checks_are_judged():
    # AUROC between top-5 and F1: top-5's check is read at its own site
    # before AUROC's update, F1's alone before the replay; a bad batch
    # raises top-5's message before AUROC appends anything.
    def members():
        return {"top5": P.MulticlassAccuracy(k=5, device="cpu"),
                "auroc": P.MulticlassAUROC(num_classes=C, device="cpu"),
                "f1": P.MulticlassF1Score(num_classes=C, average="macro", device="cpu")}

    graphed = _on_graph_path(P.MetricCollection(members()))
    eager = P.MetricCollection(members())
    pending_at_auroc = []
    auroc_update = type(graphed["auroc"]).update

    def update(m, *args, **kwargs):
        pending_at_auroc.append(_stats.stacked_check_counts().get("reads", 0))
        return auroc_update(m, *args, **kwargs)

    graphed["auroc"].update = update.__get__(graphed["auroc"])
    x, y = _multiclass(101)
    eager.update(x, y)
    reads, _, counts = _checked(lambda: graphed.update(x, y))
    assert reads == {"accuracy": 1, "f1_score": 1}
    assert counts == {"requests": 2, "reads": 2} and pending_at_auroc == [1]
    _assert_equal(graphed.state_dict(), eager.state_dict())
    with pytest.raises(ValueError) as on_graph:
        graphed.update(*_with((x, y), 1, C))
    with pytest.raises(ValueError) as on_eager:
        eager.update(*_with((x, y), 1, C))
    assert str(on_graph.value) == str(on_eager.value)
    assert len(graphed["auroc"].inputs) == 1 and len(pending_at_auroc) == 1


def _criteo_epoch(device):
    return {"auroc": P.BinaryAUROC(device=device), "ne": P.BinaryNormalizedEntropy(device=device),
            "accuracy": P.BinaryAccuracy(device=device)}


# criteo's collections at test sizes: one member that reads values each.
ONE_READER = [
    ("criteo_epoch", _criteo_epoch, lambda s: _binary(s)),
    ("criteo_epoch_ctr", lambda d: {"ctr": P.ClickThroughRate(device=d)},
     lambda s: (_binary(s)[1],)),
    ("criteo_window", _monitor, lambda s: _binary(s, 32)),
    ("criteo_window_ctr",
     lambda d: {"ctr": P.WindowedClickThroughRate(max_num_updates=3, device=d)},
     lambda s: (_binary(s, 32)[1].float(),)),
]


@pytest.mark.parametrize("case", ONE_READER, ids=[c[0] for c in ONE_READER])
def test_a_collection_with_one_reading_member_reads_and_runs_as_before(case):
    # Against the collection's graph path before the queue: each eligible
    # member's checks where it stands, every other member's update, then
    # the bodies; the same operations in the same order, the same reads.
    _, members, batch = case
    graphed = _on_graph_path(P.MetricCollection(members("cpu")))
    before = _on_graph_path(P.MetricCollection(members("cpu")))

    def unqueued(args):
        for name, m in before.items():
            (m._validate if name in before._graphed else m.update)(*args)
        before._graphs.run(("cpu",), args, {}, before._graphs.read())

    for seed in (111, 112, 113):
        args = batch(seed)
        _stats.reset_stacked_check_counts()
        with _Ops() as queued_ops:
            queued_reads = _readbacks(lambda: graphed.update(*args))
        assert _stats.stacked_check_counts() == {"requests": 1, "reads": 1}
        with _Ops() as ops:
            reads = _readbacks(lambda: unqueued(args))
        assert queued_reads == reads and len(reads) == 1 and "collection_checks" not in reads
        assert queued_ops.ops == ops.ops
    _assert_equal(graphed.state_dict(), before.state_dict())


def test_stacked_reads_give_each_check_the_values_it_reads_alone():
    # Mixed dtypes, a flag, one tensor read by two checks and a view of the
    # same memory: the values and dtypes each check would read alone, one
    # aminmax a distinct tensor.
    ints = torch.tensor([4, -2, 9, 3])
    same = ints.view(2, 2).view(4)
    wide = torch.tensor([0.25, 1.5], dtype=torch.float64)
    halves = torch.tensor([0.5, -0.75], dtype=torch.float16)
    requests = [((ints,), None), ((same, halves), None), ((), torch.tensor(True)),
                ((wide, ints), None), ((), torch.tensor(False))]
    alone, stacked = [], []
    for tensors, flag in requests:
        value_check("alone", alone.append, *tensors, flag=flag)
    queue = CheckQueue()
    with queue.scope("m"):
        for tensors, flag in requests:
            value_check("queued", stacked.append, *tensors, flag=flag)
    assert stacked == [] and queue.members == ["m"]
    _stats.reset_stacked_check_counts()
    with _Ops() as ops:
        reads = _readbacks(queue.flush)
    assert reads == {"collection_checks": 1} and queue.pending == []
    assert _stats.stacked_check_counts() == {"requests": 5, "reads": 1}
    assert ops.ops.count("aten.aminmax") == 3 and ops.ops.count("aten.stack") == 1
    assert len(stacked) == len(alone)
    for got, want in zip(stacked, alone):
        assert type(got) is type(want)
        if isinstance(want, bool):
            assert got is want
        else:
            assert got.dtype == want.dtype and np.array_equal(got, want)


_PROBS = torch.tensor([0.25, 0.5, 0.75, 0.125])
_CLICKS = torch.tensor([0, 1, 1, 0])

# Every converted site alone: (site, metric(device), good args, bad args,
# the message the bad batch raises).
SITES = [
    ("accuracy", lambda d: P.MulticlassAccuracy(k=2, device=d), lambda: _multiclass(121),
     lambda: _with(_multiclass(121), 1, C), "target values should be in [0, 7), got min 0 max 7."),
    ("f1_score", lambda d: P.MulticlassF1Score(num_classes=C, average="macro", device=d),
     lambda: _labels(122), lambda: _with(_labels(122), 0, -3),
     "input values should be in [0, 7), got min -3 max 6."),
    ("precision", lambda d: P.MulticlassPrecision(num_classes=C, average="macro", device=d),
     lambda: _labels(123), lambda: _with(_labels(123), 1, C + 5),
     "target values should be in [0, 7), got min 0 max 12."),
    ("recall", lambda d: P.MulticlassRecall(num_classes=C, average=None, device=d),
     lambda: _labels(124), lambda: _with(_labels(124), 1, -1),
     "target values should be in [0, 7), got min -1 max 6."),
    ("confusion_matrix", lambda d: P.MulticlassConfusionMatrix(C, device=d),
     lambda: _labels(125), lambda: _with(_labels(125), 0, C),
     "Got `input` prediction class which is too large for the number of classes, "
     "num_classes: 7 must be strictly greater than max class predicted: 7."),
    ("confusion_matrix", lambda d: P.MulticlassConfusionMatrix(C, device=d),
     lambda: _labels(126), lambda: _with(_labels(126), 1, -2),
     "Got negative `target` class -2."),
    ("binary_confusion_matrix", lambda d: P.BinaryConfusionMatrix(device=d),
     lambda: _binary(127), lambda: _with(_binary(127), 1, 3),
     "Got `target` class which is larger than the number of classes, num_classes: 2 must "
     "be strictly greater than max target: 3."),
    ("normalized_entropy", lambda d: P.BinaryNormalizedEntropy(device=d),
     lambda: _binary(128), lambda: (_PROBS * torch.tensor([1.0, -2.0, 1.0, 1.0]), _CLICKS),
     "`from_logits`=False, `input` should be probability in range [0., 1.], but got "
     "`input` ranging from -1.0 to 0.75. Please set `from_logits = True` "
     "or convert `input` into valid probability value."),
    ("normalized_entropy",
     lambda d: P.WindowedBinaryNormalizedEntropy(max_num_updates=3, device=d),
     lambda: _binary(128), lambda: (_PROBS * 3.0, _CLICKS),
     "`from_logits`=False, `input` should be probability in range [0., 1.], but got "
     "`input` ranging from 0.375 to 2.25. Please set `from_logits = True` "
     "or convert `input` into valid probability value."),
    ("click_through_rate", lambda d: P.ClickThroughRate(device=d),
     lambda: (_binary(129)[1],), lambda: (_binary(129)[1] * 2,),
     "`input` should be a binary tensor of 0/1 click events."),
    ("click_through_rate", lambda d: P.WindowedClickThroughRate(max_num_updates=3, device=d),
     lambda: (_binary(130)[1].float(),), lambda: (_binary(130)[1].float() - 0.5,),
     "`input` should be a binary tensor of 0/1 click events."),
]


@pytest.mark.parametrize("case", SITES, ids=[f"{c[0]}-{i}" for i, c in enumerate(SITES)])
def test_each_check_alone_reads_back_once_at_its_own_site(case):
    site, make, good, bad, message = case
    m = make("cpu")
    _stats.reset_stacked_check_counts()
    events.annotate(True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            reads = _readbacks(lambda: m.update(*good()))
    finally:
        events.annotate(False)
    assert reads == {site: 1} and _stats.stacked_check_counts() == {}
    ranges = [e.name for e in prof.events() if e.name.startswith("torcheval_tpu_torch.")]
    assert ranges.count(f"torcheval_tpu_torch.readback.{site}") == 1
    assert ranges.count(f"torcheval_tpu_torch.check.{site}") == 1
    want = _states(m)
    with pytest.raises(ValueError) as raised:
        m.update(*bad())
    assert str(raised.value) == message
    _assert_equal(_states(m), want)
