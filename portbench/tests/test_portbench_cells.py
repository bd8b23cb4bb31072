"""Each cell end to end on the CPU at a tiny size, through the port's
plain versions, with the profiler's reading on and off; the comparison
sees each fault of the timed path and the control as not correct."""

import pytest
import torch

from portbench import control, loops
from portbench.run import run_cell
from portbench.tests.tiny import CELLS, run_tiny, tiny_cell
from torcheval_tpu_torch.metrics.collection import MetricCollection


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_runs_and_is_correct(name, trace):
    cell = tiny_cell(name)
    out = run_tiny(cell, trace=trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "cpu"
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert out["device"]["busy_s"] == 0.0  # no device on the CPU
    else:
        assert set(out["metrics"]) == {"samples_per_s", "setup_s"}
        assert out["metrics"]["samples_per_s"]["value"] > 0


def test_same_seed_same_inputs_and_sizes_across_seeds():
    from portbench import inputs

    spec = tiny_cell("criteo.epoch").config["inputs"]
    a = inputs.make(spec, 1000, 2**33 + 1, "cpu")
    b = inputs.make(spec, 1000, 2**33 + 1, "cpu")
    c = inputs.make(spec, 1000, 5, "cpu")
    assert torch.equal(a["input"], b["input"]) and torch.equal(a["target"], b["target"])
    assert not torch.equal(a["input"], c["input"])
    assert a["input"].shape == c["input"].shape


def _skip_every(n):
    """MetricCollection.update that leaves the state unchanged on every
    ``n``-th call."""
    real = MetricCollection.update
    calls = {"n": 0}

    def update(self, *args, **kwargs):
        calls["n"] += 1
        if calls["n"] % n == 0:
            return self
        return real(self, *args, **kwargs)

    return update


def _half_batch():
    real = MetricCollection.update

    def update(self, *args, **kwargs):
        half = args[0].shape[0] // 2
        return real(self, *(a[:half] for a in args), **kwargs)

    return update


def _altered_answer():
    real = MetricCollection.compute

    def compute(self):
        out = real(self)
        name = next(iter(out))
        v = out[name]
        if isinstance(v, tuple):
            out[name] = (v[0], v[1] * (1 + 1e-3))
        elif v.is_floating_point():
            out[name] = v * (1 + 1e-3)
        else:
            out[name] = v + 1
        return out

    return compute


FAULTS = {
    "state_unchanged": lambda: (MetricCollection, "update", _skip_every(7)),
    "half_batch": lambda: (MetricCollection, "update", _half_batch()),
    "answer_altered": lambda: (MetricCollection, "compute", _altered_answer()),
}


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_of_the_timed_path_is_not_correct(name, fault, monkeypatch):
    cell = tiny_cell(name)
    # set-up runs sound; the fault enters once the window opens
    loop = loops.load(cell.traffic["loop"])
    real_warm = loop.warm

    def warm_then_break(self):
        real_warm(self)
        target, attr, broken = FAULTS[fault]()
        monkeypatch.setattr(target, attr, broken)

    monkeypatch.setattr(loop, "warm", warm_then_break)
    out = run_tiny(cell)
    assert not out["correct"], out["checks"]
    assert out["failed"] >= 1


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    cell = tiny_cell(name)
    out = control.readings(cell, 2**31 + 3, torch.device("cpu"), computes=5)
    assert not out["correct"], out["checks"]


def test_no_answer_is_not_correct(monkeypatch):
    cell = tiny_cell("criteo.epoch")
    loop = loops.load("epoch")
    real = loop.unit

    def unit(self, rec, mark):
        real(self, rec, mark)
        rec.answers.clear()

    monkeypatch.setattr(loop, "unit", unit)
    out = run_cell(cell, 1, 0.1, False, torch.device("cpu"), 0.0)
    assert out["attempted"] == 0 and not out["correct"]


def test_a_run_keeps_a_bounded_sample_of_its_answers_drawn_from_the_seed():
    import random

    def kept(seed):
        rec = loops.Record(keep=5, rng=random.Random(seed))
        for i in range(200):
            rec.answer(i, {})
        return rec

    a, b = kept(7), kept(7)
    assert a.offered == 200 and len(a.answers) == 5
    assert a.answers == b.answers
    assert [p for p, _ in kept(8).answers] != [p for p, _ in a.answers]
    assert len(loops.Record().answers) == 0  # keep 0: every answer
