"""A cell, a configuration, a traffic mix and a per-layer metric are
added by new files and entries alone: here all four come from a
temporary directory, and the harness runs them unchanged."""

import json
import shutil

from portbench.spec import HERE, load_cell
from portbench.tests.tiny import run_tiny


def test_a_new_cell_from_files_alone(tmp_path):
    bench = tmp_path / "portbench"
    for sub in ("configs", "traffic", "cells", "layer_metrics"):
        (bench / sub).mkdir(parents=True)
    config = json.loads((HERE / "configs" / "criteo_ctr_eval.json").read_text())
    config.update(name="toy_ctr", num_samples=20_000, eval_batch=2048)
    (bench / "configs" / "toy_ctr.json").write_text(json.dumps(config))
    (bench / "traffic" / "toy_epoch.json").write_text(
        json.dumps({"loop": "epoch", "batch": "eval_batch", "trace_units": 1}))
    (bench / "cells" / "toy.epoch.json").write_text(json.dumps({
        "suite": [{"args": ["input", "target"],
                   "members": {"mean_ce": {"class": "BinaryNormalizedEntropy"}}}],
        "numbers": {"ne_gap": {"members": {"mean_ce": "rel"}, "limit": 1e-4}},
    }))
    (bench / "layer_metrics" / "toy.updates_per_compute.py").write_text(
        "def read(trace):\n    return trace.updates / trace.computes\n")
    shutil.copy(HERE / "layer_metrics" / "device_idle_pct.py", bench / "layer_metrics")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "toy_ctr", "file": "portbench/configs/toy_ctr.json"}],
        "workloads": [{"name": "toy.epoch", "config": "toy_ctr", "traffic": "toy_epoch",
                       "chips": 1, "why": "toy"}],
        "end_to_end": [{"name": "samples_per_s", "unit": "samples/s", "better": "higher",
                        "bound": 0.05, "source": "host_clock"},
                       {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
                        "source": "host_clock"}],
        "per_layer": [{"name": "toy.updates_per_compute", "unit": "count", "better": "lower",
                       "source": "program_counter", "layer": "toy", "moves": "samples_per_s"},
                      {"name": "device_idle_pct", "unit": "%", "better": "lower",
                       "source": "device_trace", "layer": "device", "moves": "samples_per_s",
                       "workloads": ["criteo.epoch"]}],
    }))
    cell = load_cell("toy.epoch", tmp_path, bench)
    assert [m.name for m in cell.per_layer] == ["toy.updates_per_compute"]
    out = run_tiny(cell, trace=True)
    assert out["correct"], out["checks"]
    assert out["metrics"] == {"toy.updates_per_compute": {"value": 10.0, "unit": "count"}}
    assert set(run_tiny(cell)["metrics"]) == {"samples_per_s", "setup_s"}


TOY_INPUTS = '''
import torch
from portbench.inputs import generator


def make(spec, n, seed, device):
    g = generator(seed, "toy_regression", device)
    target = torch.randn(n, generator=g, device=device)
    noise = torch.randn(n, generator=g, device=device)
    return {"input": target + float(spec["noise"]) * noise, "target": target}
'''

TOY_REFERENCE = '''
from portbench.reference import formulas as f
from portbench.reference.members import whole


def reference(kw, data, position):
    d = whole(data, position)
    err = f.read(d["input"], data.dtype).to(f.F64) - d["target"].to(f.F64)
    return f.result((err * err).mean(), data.dtype)
'''

TOY_LOOP = '''
from portbench.loops import Record, no_mark, split
from portbench.suite import Suite, to_host


class Loop:
    """Whole passes with the batches handed over last to first."""

    def __init__(self, config, traffic, suite_spec, data, device):
        self.suite = Suite(suite_spec["suite"], device)
        self.batches = split(data, int(config[traffic["batch"]]))[::-1]

    @staticmethod
    def samples(config, traffic):
        return int(config["num_samples"])

    @staticmethod
    def positions(traffic, computes):
        return [None]

    def warm(self):
        self.unit(Record(), no_mark)

    def unit(self, rec, mark):
        self.suite.reset()
        for batch in self.batches:
            with mark("portbench.update"):
                self.suite.update(batch)
            rec.update_s.append(0.0)
        rec.answer(None, to_host(self.suite.compute()))
        rec.samples += int(config_samples(self.batches))
        rec.batches += len(self.batches)
        rec.computes += 1

    def free(self):
        del self.suite


def config_samples(batches):
    return sum(b["input"].shape[0] for b in batches)
'''


def test_a_new_loop_generator_and_reference_from_files_alone(tmp_path):
    from portbench import control

    bench = tmp_path / "portbench"
    for sub in ("configs", "traffic", "cells", "loops", "inputs", "reference/members"):
        (bench / sub).mkdir(parents=True)
    (bench / "inputs" / "toy_regression.py").write_text(TOY_INPUTS)
    (bench / "reference" / "members" / "MeanSquaredError.py").write_text(TOY_REFERENCE)
    (bench / "loops" / "toy_reverse.py").write_text(TOY_LOOP)
    (bench / "configs" / "toy_reg.json").write_text(json.dumps({
        "name": "toy_reg", "num_samples": 10_000, "eval_batch": 1000,
        "inputs": {"kind": "toy_regression", "noise": 0.5}}))
    (bench / "traffic" / "reverse.json").write_text(
        json.dumps({"loop": "toy_reverse", "batch": "eval_batch", "trace_units": 1}))
    (bench / "cells" / "toy.mse.json").write_text(json.dumps({
        "suite": [{"args": ["input", "target"],
                   "members": {"mse": {"class": "MeanSquaredError"}}}],
        "numbers": {"mse_gap": {"members": {"mse": "rel"}, "limit": 1e-5}},
    }))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "toy_reg", "file": "portbench/configs/toy_reg.json"}],
        "workloads": [{"name": "toy.mse", "config": "toy_reg", "traffic": "reverse",
                       "chips": 1, "why": "toy"}],
        "end_to_end": [{"name": "samples_per_s", "unit": "samples/s", "better": "higher",
                        "bound": 0.05, "source": "host_clock"},
                       {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
                        "source": "host_clock"}],
        "per_layer": [{"name": "kernels_per_batch", "unit": "count", "better": "lower",
                       "source": "device_trace", "layer": "toy", "moves": "samples_per_s"}],
    }))
    cell = load_cell("toy.mse", tmp_path, bench)
    out = run_tiny(cell)
    assert out["correct"], out["checks"]
    assert out["checks"]["mse_gap"]["value"] < 1e-6
    # the control (the reference in bfloat16) is found not correct
    assert not control.readings(cell, 2**31 + 5, "cpu")["correct"]
