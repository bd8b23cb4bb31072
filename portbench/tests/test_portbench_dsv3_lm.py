"""The ``dsv3_lm.epoch`` cell end to end on the CPU at a size it runs in
a second (4 sequences of 64 tokens over a vocabulary of 1000, the margin
set for the same mean NLL of about 2.2 nats), through the port's plain
version of the token-NLL kernel: correct, with the profiler's reading on
and off; each fault of the timed path and the bfloat16 control not
correct; the generator's inputs and the readers of the new metrics."""

import math

import pytest
import torch

from portbench import control, inputs, loops
from portbench.profile import Event, Trace
from portbench.spec import find, load_cell
from portbench.tests.test_portbench_cells import FAULTS
from portbench.tests.tiny import ROOT, run_tiny

NAME = "dsv3_lm.epoch"
SEQ, VOCAB, SEQS = 64, 1000, 4


def small_cell():
    cell = load_cell(NAME, ROOT)
    cell.config.update(num_samples=SEQS, seq_len=SEQ, vocab_size=VOCAB)
    cell.config["inputs"].update(seq_len=SEQ, vocab_size=VOCAB, margin=5.3)
    return cell


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_runs_and_is_correct(trace):
    cell = small_cell()
    out = run_tiny(cell, trace=trace)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["checks"]["ppl_gap"]["value"] < 1e-6
    if trace:
        # no device on the CPU: the kernel's share reads nothing
        assert "token_nll_roofline" not in out["metrics"]
    else:
        assert set(out["metrics"]) == {"samples_per_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_fault_of_the_timed_path_is_not_correct(fault, monkeypatch):
    cell = small_cell()
    loop = loops.load(cell.traffic["loop"])
    real_warm = loop.warm

    def warm_then_break(self):
        real_warm(self)
        target, attr, broken = FAULTS[fault]()
        monkeypatch.setattr(target, attr, broken)

    monkeypatch.setattr(loop, "warm", warm_then_break)
    out = run_tiny(cell, seconds=1.0)  # past the 7th update however slow the host
    assert not out["correct"], out["checks"]


def test_the_bfloat16_control_is_not_correct():
    out = control.readings(small_cell(), 2**31 + 3, torch.device("cpu"))
    assert not out["correct"], out["checks"]
    assert out["checks"]["ppl_gap"]["value"] > 10 * out["checks"]["ppl_gap"]["limit"]


def test_inputs_from_the_seed():
    spec = small_cell().config["inputs"]
    a = inputs.make(spec, SEQS, 2**33 + 1, "cpu")
    b = inputs.make(spec, SEQS, 2**33 + 1, "cpu")
    c = inputs.make(spec, SEQS, 5, "cpu")
    assert a["input"].dtype == torch.bfloat16 and a["input"].shape == (SEQS, SEQ, VOCAB)
    assert a["target"].dtype == torch.int64 and a["target"].shape == (SEQS, SEQ)
    assert torch.equal(a["input"], b["input"]) and torch.equal(a["target"], b["target"])
    assert not torch.equal(a["input"], c["input"])
    ignored = a["target"] == -100
    assert 0 < int(ignored.sum()) < SEQS * SEQ // 10
    kept = a["target"][~ignored]
    assert int(kept.min()) >= 0 and int(kept.max()) < VOCAB
    x = a["input"].to(torch.float64)
    nll = torch.logsumexp(x, -1) - x.gather(-1, a["target"].clamp(min=0)[..., None])[..., 0]
    assert 1.5 < float(nll[~ignored].mean()) < 3.0


def _trace(ops, launches, computes=2):
    cfg = small_cell().config
    return Trace(device_ops=ops, runtime=[], ranges=[], cpu_ops=[], window=(0.0, 1e6),
                 batches=2 * computes, updates=2 * computes, computes=computes,
                 launches=launches, config=cfg, suite={})


def test_the_kernel_share_reads_the_configuration_s_bytes():
    read = find("layer_metrics", "token_nll_roofline").read
    assert read(_trace([], {})) is None  # a program without the kernel
    with pytest.raises(RuntimeError, match="names none"):
        read(_trace([], {"token_nll": 4}))
    bytes_ = 2 * SEQS * SEQ * (VOCAB * 2 + 12)
    us = 1e6 * bytes_ / 3.35e12  # the least time: 100 %
    ops = [Event("void token_nll_kernel<__nv_bfloat16, long>", 0.0, us / 2),
           Event("void token_nll_kernel<__nv_bfloat16, long>", 10.0, 10.0 + us / 2)]
    assert math.isclose(read(_trace(ops, {"token_nll": 4})), 100.0, rel_tol=1e-9)


def test_update_device_time_reads_the_update_ranges():
    read = find("layer_metrics", "update_device_ms").read
    t = _trace([Event("k", 0.0, 500.0, correlation=1), Event("k", 600.0, 700.0, correlation=2)],
               {}, computes=1)
    t.ranges = [Event("portbench.update", 0.0, 50.0, tid=1)]
    t.runtime = [Event("cudaLaunchKernel", 10.0, 12.0, tid=1, correlation=1),
                 Event("cudaLaunchKernel", 60.0, 62.0, tid=1, correlation=2)]
    assert read(t) == pytest.approx(0.5 / 2)  # 500 us inside, over 2 updates
    t.runtime = []
    assert read(t) is None
