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
the eager path on the card (``tests/test_torch_cuda.py``)."""

import copy
import pickle

import numpy as np
import pytest
import torch

from torcheval_tpu_torch import _stats
from torcheval_tpu_torch import metrics as P
from torcheval_tpu_torch.metrics._graphs import GraphedUpdate
from torcheval_tpu_torch.metrics.metric import Metric

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


def test_eligibility_is_a_class_attribute_a_redefined_update_drops():
    eligible = {type(c[1]("cpu")) for c in CASES}
    assert all(cls._graph_update for cls in eligible)
    for m in (P.BinaryAUROC(device="cpu"), P.MulticlassAUROC(num_classes=C, device="cpu"),
              P.WindowedBinaryAUROC(max_num_samples=64, device="cpu"),
              P.WindowedBinaryNormalizedEntropy(max_num_updates=4, device="cpu"),
              P.WindowedClickThroughRate(max_num_updates=4, device="cpu"),
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
    })
    assert not windowed._graphed
    assert _counted(lambda: windowed.update(s, t)) == {"eager": 2}

    fused = P.MetricCollection({"acc": P.MulticlassAccuracy(device="cpu")})
    assert _counted(lambda: fused.fused_update(x, y)) == {}


def test_graph_key_refuses_a_cpu_batch():
    members = {"acc": P.MulticlassAccuracy(device="cpu")}
    graphs = GraphedUpdate(members)
    assert graphs.name == "graph[acc].update"
    assert graphs.key(_multiclass(14), {}, graphs.read()) is None


class _EagerGraphs(GraphedUpdate):
    """The collection's graph path with the bodies run eagerly in place of
    the replay: its order of checks and state writes, on the CPU."""

    def key(self, args, kwargs, current):
        return ("cpu",)

    def run(self, key, args, kwargs, current):
        for m in self._members.values():
            m._update_body(*args, **kwargs)
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


def test_pickled_and_copied_collections_leave_their_graphs_behind():
    col = _on_graph_path(P.MetricCollection(_imagenet_like("cpu")))
    col.update(*_multiclass(41))
    for other in (pickle.loads(pickle.dumps(col)), copy.deepcopy(col)):
        assert other._graphs is None and list(other._graphed) == list(col._graphed)
        _assert_equal(other.state_dict(), col.state_dict())
