"""The port's spans and read-back counter on the CPU: the span tree of a
validation pass, a click-through-rate pass and a monitor's window under
``torch.profiler``, the profiler ranges without the event bus, nothing
at all with both off, the read backs by site, and a span's cost against
a sample buffer's length."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torcheval_tpu_torch import _stats
from torcheval_tpu_torch import metrics as tm
from torcheval_tpu_torch.metrics.collection import MetricCollection
from torcheval_tpu_torch.telemetry import events

PREFIX = "torcheval_tpu_torch."
CPU = "cpu"


@pytest.fixture(autouse=True)
def spans_off():
    events.disable()
    events.annotate(False)
    events.clear()
    yield
    events.disable()
    events.annotate(False)
    events.clear()


# ------------------------------------------------------------- the suites
def _classes(n=32800, c=200, batches=4, seed=0):
    """Logits with the target's raised, at a size the rank-sum route takes
    (N >= 2^15, at most 512 samples a class)."""
    g = torch.Generator().manual_seed(seed)
    target = torch.arange(n) % c
    logits = torch.randn(n, c, generator=g)
    logits[torch.arange(n), target] += 2.0
    step = -(-n // batches)
    return [(logits[i:i + step], target[i:i + step]) for i in range(0, n, step)]


def _clicks(n=40000, batches=5, seed=1):
    g = torch.Generator().manual_seed(seed)
    label = (torch.rand(n, generator=g) < 0.05).to(torch.float32)
    prob = torch.sigmoid(torch.randn(n, generator=g) + 1.2 * label - 3.0)
    step = n // batches
    return [(prob[i:i + step], label[i:i + step]) for i in range(0, n, step)]


def imagenet_suite():
    c = 200
    return [(MetricCollection({
        "top1": tm.MulticlassAccuracy(device=CPU),
        "top5": tm.MulticlassAccuracy(k=5, device=CPU),
        "f1": tm.MulticlassF1Score(num_classes=c, average="macro", device=CPU),
        "cm": tm.MulticlassConfusionMatrix(c, device=CPU),
        "auroc": tm.MulticlassAUROC(num_classes=c, device=CPU),
    }), lambda x, y: (x, y))], _classes()


def criteo_epoch_suite():
    return [
        (MetricCollection({
            "auroc": tm.BinaryAUROC(device=CPU),
            "ne": tm.BinaryNormalizedEntropy(device=CPU),
            "accuracy": tm.BinaryAccuracy(device=CPU),
        }), lambda p, y: (p, y)),
        (MetricCollection({"ctr": tm.ClickThroughRate(device=CPU)}), lambda p, y: (y,)),
    ], _clicks()


def criteo_window_suite():
    return [
        (MetricCollection({
            "auroc": tm.WindowedBinaryAUROC(max_num_samples=40000, device=CPU),
            "ne": tm.WindowedBinaryNormalizedEntropy(max_num_updates=6, device=CPU),
            "calibration": tm.WindowedWeightedCalibration(max_num_updates=6, device=CPU),
        }), lambda p, y: (p, y)),
        (MetricCollection({"ctr": tm.WindowedClickThroughRate(max_num_updates=6, device=CPU)}),
         lambda p, y: (y,)),
    ], _clicks()


SUITES = {
    "imagenet1k.eager": imagenet_suite,
    "criteo.epoch": criteo_epoch_suite,
    "criteo.window": criteo_window_suite,
}


def run_suite(name):
    """One pass: every batch through every collection, then one compute."""
    groups, batches = SUITES[name]()
    for batch in batches:
        for col, args in groups:
            col.update(*args(*batch))
    return [col.compute() for col, _ in groups], len(batches)


# Every span of each suite's pass: (name, count) with B the batches.
def expected_spans(name, b):
    if name == "imagenet1k.eager":
        members = {"MulticlassAccuracy[top1]", "MulticlassAccuracy[top5]",
                   "MulticlassF1Score[f1]", "MulticlassConfusionMatrix[cm]",
                   "MulticlassAUROC[auroc]"}
        out = {"MetricCollection.update": b, "MetricCollection.compute": 1,
               "check.accuracy": b, "readback.accuracy": b, "check.f1_score": b,
               "readback.f1_score": b, "check.confusion_matrix": b,
               "readback.confusion_matrix": b, "readback.f1_score.missing_classes": 1,
               "compute.concat": 1, "compute.route": 1, "readback.multiclass_route": 1,
               "compute.kernel.rank_sum": 1}
    else:
        windowed = name == "criteo.window"
        members = ({"WindowedBinaryAUROC[auroc]", "WindowedBinaryNormalizedEntropy[ne]",
                    "WindowedWeightedCalibration[calibration]", "WindowedClickThroughRate[ctr]"}
                   if windowed else
                   {"BinaryAUROC[auroc]", "BinaryNormalizedEntropy[ne]",
                    "BinaryAccuracy[accuracy]", "ClickThroughRate[ctr]"})
        out = {"MetricCollection.update": 2 * b, "MetricCollection.compute": 2,
               "check.normalized_entropy": b, "readback.normalized_entropy": b,
               "check.click_through_rate": b, "readback.click_through_rate": b,
               "compute.route": 1, "readback.binary_route": 1, "compute.sort": 1,
               "compute.kernel.auc_scan": 1}
        if not windowed:
            out.update({"compute.concat": 1, "readback.normalized_entropy.empty": 1})
    for m in members:
        out[f"{m}.update"] = b
        out[f"{m}.compute"] = 1
    return out


def program_ranges(prof):
    return [(e.name[len(PREFIX):], e.time_range.start, e.time_range.end, e.thread)
            for e in prof.events() if e.name.startswith(PREFIX)]


def inside(inner, outer):
    return outer[3] == inner[3] and outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("name", sorted(SUITES))
def test_the_span_tree_of_each_suite(name):
    events.annotate(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, b = run_suite(name)
    events.annotate(False)
    got = program_ranges(prof)
    counts = {}
    for r in got:
        counts[r[0]] = counts.get(r[0], 0) + 1
    assert counts == expected_spans(name, b)
    assert events.events() == []  # the ranges alone: the bus stays off
    members = [r for r in got if r[0].endswith(".update") and "[" in r[0]]
    collections = [r for r in got if r[0] == "MetricCollection.update"]
    for m in members:
        assert any(inside(m, c) for c in collections), m
    for r in got:
        if r[0].startswith(("check.", "readback.")) and not r[0].startswith(
                ("readback.multiclass_route", "readback.binary_route",
                 "readback.f1_score.missing", "readback.normalized_entropy.empty")):
            # an update's check and its read back sit in their member's span
            assert any(inside(r, m) for m in members), r
        if r[0].startswith("readback.") and r[0][len("readback."):] in (
                "accuracy", "f1_score", "confusion_matrix", "normalized_entropy",
                "click_through_rate"):
            assert any(inside(r, c) for c in got if c[0] == "check." + r[0][len("readback."):])
        if r[0].startswith("compute."):
            assert any(inside(r, m) for m in got if m[0].endswith(".compute") and "[" in m[0])


def test_top1_and_top5_are_told_apart():
    events.annotate(True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_suite("imagenet1k.eager")
    events.annotate(False)
    names = {r[0] for r in program_ranges(prof)}
    assert {"MulticlassAccuracy[top1].update", "MulticlassAccuracy[top5].update"} <= names
    assert "MulticlassAccuracy.update" not in names
    # only top-5's update reads its targets back (top-1 scatters nothing)
    top5 = [r for r in program_ranges(prof) if r[0] == "MulticlassAccuracy[top5].update"]
    checks = [r for r in program_ranges(prof) if r[0] == "check.accuracy"]
    assert len(checks) == len(top5) and all(any(inside(c, t) for t in top5) for c in checks)


class _Checked(tm.MulticlassAccuracy):
    """A subclass whose update calls the wrapped update of its base."""

    def update(self, input, target, *, mask=None):
        return super().update(input, target, mask=mask)


def test_one_span_per_member_call_when_a_subclass_calls_super_update():
    x, y = torch.rand(8, 4), torch.arange(8) % 4
    alone = _Checked(device=CPU)
    col = MetricCollection({"acc": _Checked(device=CPU)})
    events.enable(annotate=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        alone.update(x, y).update(x, y)
        col.update(x, y)
    names = [r[0] for r in program_ranges(prof)]
    assert names.count("_Checked.update") == 2
    assert names.count("_Checked[acc].update") == 1
    assert not any(n.startswith("MulticlassAccuracy") for n in names)
    # The bus emits one event a wrapped call, nested ones too, as the JAX
    # bus does: the subclass's and its base's, three calls over.
    assert [(e.name, e.phase) for e in events.events("span")
            if e.phase == "update"] == [("_Checked", "update")] * 6


@pytest.mark.parametrize("name", sorted(SUITES))
def test_with_everything_off_no_range_opens_and_nothing_is_emitted(name, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("called with the spans off")

    for attr in ("span", "timed_phase", "member_phase", "emit", "_callsite"):
        monkeypatch.setattr(events, attr, refuse)
    monkeypatch.setattr(torch.profiler.record_function, "__enter__", refuse)
    run_suite(name)
    monkeypatch.undo()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_suite(name)
    assert program_ranges(prof) == [] and events.events() == []


def test_ranges_alone_walk_no_stack_and_size_no_state(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("bus work with the bus off")

    for attr in ("emit", "_callsite", "state_nbytes", "record_span"):
        monkeypatch.setattr(events, attr, refuse)
    events.annotate(True)
    run_suite("criteo.epoch")
    events.annotate(False)


def expected_readbacks(name, b):
    if name == "imagenet1k.eager":
        return {"accuracy": b, "f1_score": b, "confusion_matrix": b,
                "f1_score.missing_classes": 1, "multiclass_route": 1}
    out = {"normalized_entropy": b, "click_through_rate": b, "binary_route": 1}
    if name == "criteo.epoch":
        out["normalized_entropy.empty"] = 1
    return out


@pytest.mark.parametrize("annotate", [False, True])
@pytest.mark.parametrize("name", sorted(SUITES))
def test_the_read_back_counter_by_site(name, annotate):
    _stats.reset_readback_counts()
    events.annotate(annotate)
    _, b = run_suite(name)
    events.annotate(False)
    assert _stats.readback_counts() == expected_readbacks(name, b)
    _stats.reset_readback_counts()
    assert _stats.readback_counts() == {}


def test_a_spans_cost_does_not_grow_with_a_sample_buffer(monkeypatch):
    sized = []
    real = events.state_nbytes

    def counting(metric):
        sized.append(type(metric).__name__)
        return real(metric)

    monkeypatch.setattr(events, "state_nbytes", counting)
    walked = []
    real_leaves = events._callsite

    def callsite():
        walked.append(1)
        return real_leaves()

    monkeypatch.setattr(events, "_callsite", callsite)
    events.enable(annotate=True)
    m = tm.BinaryAUROC(device=CPU)
    batch = (torch.rand(64), (torch.rand(64) < 0.5).to(torch.float32))
    for n in range(1, 301):
        m.update(*batch)
    # 300 updates with a buffer of 1 to 300 tensors: no update span sized
    # the state; one callsite walk a span, whatever the buffer's length.
    assert sized == [] and len(walked) == 300 and len(m.inputs) == 300
    m.compute()
    assert sized == ["BinaryAUROC"]
    spans = events.events("span")
    assert [s.state_bytes for s in spans if s.phase == "update"] == [0] * 300
    assert spans[-1].phase == "compute" and spans[-1].state_bytes == 300 * 64 * 8


def test_the_switches():
    assert (events.ENABLED, events.ANNOTATE, events.SPANS) == (False, False, False)
    events.annotate(True)
    assert (events.ENABLED, events.ANNOTATE, events.SPANS) == (False, True, True)
    events.enable()
    assert (events.ENABLED, events.ANNOTATE, events.SPANS) == (True, True, True)
    events.annotate(False)
    assert (events.ENABLED, events.ANNOTATE, events.SPANS) == (True, False, True)
    events.enable(annotate=True)
    events.disable()  # the bus off; the ranges stay on
    assert (events.ENABLED, events.ANNOTATE, events.SPANS) == (False, True, True)
    events.annotate(False)
    assert (events.ENABLED, events.ANNOTATE, events.SPANS) == (False, False, False)
