"""The spans stretch and the readers of the program's spans and read-back
counter (``portbench/spans.py``): interval overlap on synthetic traces,
the read-back check, and a whole run on the CPU with the harness's own
traced stretch spans off and the spans stretch spans on."""

import argparse
import random

import pytest
import torch

from portbench import run, spans
from portbench.profile import Event
from portbench.spec import load_cell
from portbench.tests.tiny import ROOT, run_tiny, tiny_cell

MAIN = 1


def ev(name, start, end, tid=MAIN):
    return Event(name, float(start), float(end), tid)


def synthetic(program, runtime=(), device=((100, 200), (600, 700)), window=(0, 1000),
              harness=(("portbench.update", 40, 510), ("portbench.compute", 690, 990)),
              readbacks=None, batches=1):
    ranges = [ev("portbench.window", *window)] + [ev(*h) for h in harness]
    return spans.SpanTrace(
        device_ops=[Event("k", float(s), float(e)) for s, e in device],
        runtime=list(runtime), ranges=ranges, cpu_ops=[], window=window,
        batches=batches, updates=batches, computes=1,
        program=list(program), readbacks=dict(readbacks or {}),
    )


NESTED = [
    ev("MetricCollection.update", 50, 500),
    ev("MulticlassAccuracy[top5].update", 60, 400),
    ev("check.accuracy", 150, 300),
    ev("readback.accuracy", 250, 300),
    ev("MetricCollection.compute", 700, 950),
    ev("MulticlassAccuracy[top5].compute", 710, 940),
    ev("compute.sort", 720, 800),
    ev("Other.update", 0, 1000, tid=2),  # another thread: not the host's main one
]


def test_idle_split_by_interval_overlap_with_nested_spans():
    split = spans.idle_split(synthetic(NESTED))
    # idle: [0, 100], [200, 600], [700, 1000] microseconds
    assert split["idle"] == pytest.approx(800e-6)
    assert split["update"] == pytest.approx(140e-6)  # [60, 100] and [300, 400]
    assert split["check"] == pytest.approx(100e-6)  # [200, 300]
    assert split["compute"] == pytest.approx(250e-6)  # [700, 950]
    assert split["collection"] == pytest.approx(110e-6)  # [50, 60] and [400, 500]
    assert split["harness"] == pytest.approx(200e-6)  # [0, 50], [500, 600], [950, 1000]
    inner = split["innermost"]
    assert inner["readback.accuracy"] == pytest.approx(50e-6)
    assert inner["check.accuracy"] == pytest.approx(50e-6)
    assert inner["compute.sort"] == pytest.approx(80e-6)
    assert inner["MulticlassAccuracy[top5].compute"] == pytest.approx(150e-6)
    assert sum(inner.values()) == pytest.approx(split["idle"])


def _random_nest(rng, lo, hi, depth, out):
    names = ["MetricCollection.update", "A[a].update", "check.a", "readback.a"]
    t = lo
    while depth < len(names) and t < hi - 4:
        s = rng.uniform(t, hi - 2)
        e = rng.uniform(s + 1, hi)
        out.append(ev(names[depth] if rng.random() < 0.8 else "compute.sort", s, e))
        _random_nest(rng, s, e, depth + 1, out)
        t = e + rng.uniform(0, 5)


@pytest.mark.parametrize("seed", range(20))
def test_the_shares_do_not_overlap_and_stay_within_the_idle_share(seed):
    rng = random.Random(seed)
    program = []
    _random_nest(rng, 0.0, 1000.0, 0, program)
    device = sorted((s, s + rng.uniform(1, 30)) for s in (rng.uniform(0, 990) for _ in range(40)))
    st = synthetic(program, device=device)
    split = spans.idle_split(st)
    parts = [split[k] for k in ("update", "check", "compute", "collection", "harness")]
    assert all(p >= -1e-12 for p in parts)
    assert sum(parts) == pytest.approx(split["idle"])
    assert split["idle"] == pytest.approx(st.window_s - st.busy_s())
    shares = [100.0 * split[k] / st.window_s for k in spans.CATEGORIES]
    assert sum(shares) <= 100.0 * split["idle"] / st.window_s + 1e-9


def test_readbacks_per_batch_fails_on_a_blocking_call_outside_every_readback_span(monkeypatch):
    from portbench.spec import find

    reader = find("layer_metrics", "readbacks_per_batch")
    counted = ev("cudaStreamSynchronize", 260, 270)  # inside readback.accuracy
    harness = ev("cudaStreamSynchronize", 960, 980)  # the harness's own copy of the values
    st = synthetic(NESTED, runtime=[counted, harness], readbacks={"accuracy": 3}, batches=2)
    monkeypatch.setattr(spans, "for_run", lambda trace: st)
    assert reader.read(None) == 1.5
    assert spans.uncounted(st) == []
    for t, where in ((170, "check.accuracy"), (80, "MulticlassAccuracy[top5].update"),
                     (730, "compute.sort"), (45, "-")):
        bad = ev("cudaStreamSynchronize", t, t + 1)
        st.runtime = [counted, harness, bad]
        assert spans.uncounted(st) == [(bad, where)]
        with pytest.raises(RuntimeError, match="outside every readback"):
            reader.read(None)


def test_a_program_without_spans_reads_nothing(monkeypatch):
    monkeypatch.setattr(spans, "program_api", lambda: None)
    assert spans.trace_with_spans(tiny_cell("criteo.epoch"), 1, "cpu") is None


def test_the_first_traced_stretch_runs_spans_off_and_the_second_spans_on(monkeypatch):
    from portbench import loops
    from torcheval_tpu_torch.telemetry import events

    name = "criteo.window"
    cell = tiny_cell(name)
    seed = 2**33 + 7
    loop = loops.load(cell.traffic["loop"])
    real_unit = loop.unit
    traced = []

    def unit(self, rec, mark):
        if mark is not loops.no_mark:
            traced.append((events.ANNOTATE, events.SPANS, events.ENABLED))
        real_unit(self, rec, mark)

    monkeypatch.setattr(loop, "unit", unit)
    monkeypatch.setattr(spans, "_run_args", lambda: argparse.Namespace(workload=name, seed=seed))
    import portbench.spec

    monkeypatch.setattr(portbench.spec, "load_cell", lambda *a, **k: tiny_cell(name))
    out = run_tiny(cell, seed=seed, trace=True)
    assert out["correct"], out["checks"]
    units = int(cell.traffic["trace_units"])
    assert traced == [(False, False, False)] * units + [(True, True, False)] * units
    assert not events.ANNOTATE and not events.SPANS
    # On the CPU the counter reads (the checks of the click-through rate and
    # the normalized entropy, one a batch; the window's 5000 samples take
    # no route read); the idle shares have no device rows.
    got = out["metrics"]
    assert got["readbacks_per_batch"]["value"] == 2.0
    assert not {"update_idle_pct", "check_idle_pct", "compute_idle_pct"} & set(got)


def test_the_spans_stretch_holds_the_program_spans():
    st = spans.trace_with_spans(tiny_cell("imagenet1k.eager"), 2**31 + 5, "cpu")
    names = {s.name for s in st.program}
    assert {"MetricCollection.update", "MulticlassAccuracy[top1].update",
            "MulticlassAccuracy[top5].update", "check.accuracy", "readback.accuracy",
            "MulticlassAUROC[auroc].compute", "compute.concat"} <= names
    assert st.readbacks["accuracy"] == st.batches
    assert spans.uncounted(st) == []
    line = spans.timeline(st)
    for s in st.program:
        if s.name.startswith("readback."):
            assert any(o.name.startswith("check.") for o in line.at((s.start + s.end) / 2)) \
                or any(spans.is_compute(o.name) for o in line.at((s.start + s.end) / 2))


def test_a_wrong_answer_on_the_spans_path_fails_the_run(monkeypatch):
    from torcheval_tpu_torch.telemetry import events

    real = events.member_phase

    def wrong(metric, member, phase, *args, **kwargs):
        out = real(metric, member, phase, *args, **kwargs)
        return out + 1 if phase == "compute" and isinstance(out, torch.Tensor) else out

    # Only the spans stretch takes the member spans: the run's own window
    # and its first traced stretch answer right.
    monkeypatch.setattr(events, "member_phase", wrong)
    with pytest.raises(RuntimeError, match="spans stretch answered wrong"):
        spans.trace_with_spans(tiny_cell("criteo.window"), 2**33 + 3, "cpu")


def test_the_spans_stretch_is_traced_once_a_run_and_needs_the_command_line(monkeypatch, capsys):
    traced = []
    monkeypatch.setattr(spans, "trace_with_spans",
                        lambda cell, seed, device: traced.append(seed) or None)
    first = synthetic(NESTED)
    first.suite, first.config = tiny_cell("criteo.epoch").suite, tiny_cell("criteo.epoch").config
    monkeypatch.setattr("sys.argv", ["portbench"])
    assert spans.for_run(first) is None
    assert "no --workload and --seed" in capsys.readouterr().err
    second = synthetic(NESTED)
    second.suite, second.config = first.suite, first.config
    monkeypatch.setattr("sys.argv", ["portbench", "--workload", "criteo.epoch", "--seed", "9"])
    import portbench.spec

    monkeypatch.setattr(portbench.spec, "load_cell", lambda *a, **k: tiny_cell("criteo.epoch"))
    assert spans.for_run(second) is None and spans.for_run(second) is None
    assert traced == [9]


def test_a_port_flag_in_the_environment_still_stops_the_run(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: pytest.fail("the run went on"))
    monkeypatch.setattr(run, "ROOT", ROOT)
    assert load_cell("criteo.epoch", ROOT).name == "criteo.epoch"
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_TELEMETRY_ANNOTATE", "1")
    code = run.main(["--workload", "criteo.epoch", "--seed", "1", "--seconds", "1",
                     "--trace", "1"], started=0.0)
    assert code == 2
    assert "TORCHEVAL_TPU_TORCH_TELEMETRY_ANNOTATE" in capsys.readouterr().err
