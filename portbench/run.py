"""One run of one cell: set-up, the measured window, the check against
the reference, and the result's line.

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Standard output ends with one JSON line: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared with its limit,
also the last lines on standard error.  The run exits with another code
than 0, and prints no result, without a CUDA device, with a flag of the
port set, after a plain fallback of a kernel on the card, or with JAX or
the JAX package loaded.
"""

from __future__ import annotations

import argparse
import gc
import json
import random
import sys
import time
from collections import Counter
from pathlib import Path
from typing import Any, Dict

import torch

from portbench import guard, inputs, loops, profile
from portbench.judge import Reference, judge
from portbench.reference.members import Data
from portbench.spec import Cell, load_cell

ROOT = Path.cwd()
# Answers a run keeps for the comparison: a uniform sample drawn from the
# seed, so the store stays bounded however many units the window holds.
ANSWERS_KEPT = 48


def _record(seed: int, tag: str) -> loops.Record:
    return loops.Record(keep=ANSWERS_KEPT, rng=random.Random(inputs.sub_seed(seed, tag)))


def _power_limit() -> str:
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20, check=False,
        )
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: {exc}"


def run_cell(
    cell: Cell,
    seed: int,
    seconds: float,
    trace: bool,
    device: torch.device,
    started: float,
) -> Dict[str, Any]:
    """Run ``cell`` once and return its result (without printing it)."""
    on_device = device.type == "cuda"
    loop_cls = loops.load(cell.traffic["loop"], cell.bench_dir)
    n = loop_cls.samples(cell.config, cell.traffic)
    t_inputs = time.perf_counter()
    data = inputs.make(cell.config["inputs"], n, seed, device, cell.bench_dir)
    if on_device:
        torch.cuda.synchronize()
    t_build = time.perf_counter()
    loop = loop_cls(cell.config, cell.traffic, cell.suite, data, device)
    t_warm = time.perf_counter()
    loop.warm()
    if on_device:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - started
    print(f"portbench: set-up {setup_s:.3f} s: start to inputs {t_inputs - started:.3f}, "
          f"inputs {t_build - t_inputs:.3f}, suite {t_warm - t_build:.3f}, "
          f"warm-up {started + setup_s - t_warm:.3f}", file=sys.stderr)

    rec = _record(seed, "answers")
    t0 = time.perf_counter()
    ends = []
    while True:
        loop.unit(rec, loops.no_mark)
        window_s = time.perf_counter() - t0
        ends.append(window_s)
        if window_s >= seconds:
            break
    units = sorted(b - a for a, b in zip([0.0] + ends, ends))
    print(f"portbench: window {window_s:.3f} s, {len(units)} units: "
          f"min {units[0]:.4f} median {units[len(units) // 2]:.4f} max {units[-1]:.4f} s",
          file=sys.stderr)

    traced = None
    if trace:
        traced = _trace(cell, loop, rec, on_device, seed)
    peak = torch.cuda.max_memory_allocated(device) if on_device else 0
    answers = rec.answers + (traced[1].answers if traced else [])

    loop.free()
    del loop
    gc.collect()
    if on_device:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    batch = cell.config[cell.traffic["batch"]]
    ref = Reference(cell.suite, Data(data, batch, torch.float64), cell.bench_dir)
    checks, attempted, failed = judge(cell.suite, ref, answers)
    offered = rec.offered + (traced[1].offered if traced else 0)
    print(f"portbench: {attempted} answers of {offered} checked against the reference in "
          f"{time.perf_counter() - t_ref:.3f} s", file=sys.stderr)

    dev: Dict[str, Any] = {
        "platform": "gpu" if on_device else "cpu",
        "kind": torch.cuda.get_device_name(device) if on_device else "cpu",
        "count": cell.chips,
        "memory_peak_bytes": int(peak),
    }
    out: Dict[str, Any] = {
        "correct": attempted > 0 and failed == 0,
        "attempted": attempted,
        "failed": failed,
    }
    if trace:
        view = traced[0]
        metrics = {}
        for m in cell.per_layer:
            # A reader returns None where its layer is off the path (no
            # launch of its kernel counted) and raises
            # where the trace and the program's counters disagree.
            value = cell.readers[m.name](view)
            if value is None:
                print(f"portbench: {m.name} reads nothing in {cell.name}: no device rows, "
                      f"or its layer did not run in the traced units (kernel launches "
                      f"{dict(view.launches)})", file=sys.stderr)
            else:
                metrics[m.name] = {"value": value, "unit": m.unit}
        dev["busy_s"] = view.busy_s()
        dev["window_s"] = view.window_s
        out["metrics"] = metrics
        out["device"] = dev
        out["breakdown"] = profile.breakdown(view)
    else:
        values = {"samples_per_s": rec.samples / window_s, "setup_s": setup_s}
        out["metrics"] = {
            m.name: {"value": values[m.name], "unit": m.unit} for m in cell.end_to_end
        }
        out["device"] = dev
    out["checks"] = checks
    return out


def _launches():
    from torcheval_tpu_torch.ops import _build

    return Counter(_build.LAUNCHES)


def _trace(cell: Cell, loop, rec: loops.Record, on_device: bool, seed: int, attempts: int = 3):
    """Trace ``trace_units`` more units; a trace without device rows (the
    profiler drops them now and then) is taken again."""
    units = int(cell.traffic["trace_units"])
    for _ in range(attempts):
        trec = _record(seed, "traced answers")
        launches0 = _launches()

        def body(mark):
            for _ in range(units):
                loop.unit(trec, mark)

        parsed = profile.capture(body, on_device)
        window = next(r for r in parsed["ranges"] if r.name == "portbench.window")
        view = profile.Trace(
            device_ops=parsed["device"],
            runtime=parsed["runtime"],
            ranges=parsed["ranges"],
            cpu_ops=parsed["cpu"],
            window=(window.start, window.end),
            batches=trec.batches,
            updates=len(trec.update_s),
            computes=trec.computes,
            launches=_launches() - launches0,
            update_s=rec.update_s,
            result_s=rec.result_s,
            config=cell.config,
            suite=cell.suite,
        )
        if view.device_ops or not on_device:
            return view, trec
        print("profiler: a trace without device rows; tracing again", file=sys.stderr)
    return view, trec


def main(argv, started: float) -> int:
    parser = argparse.ArgumentParser(prog="python -m portbench", description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = load_cell(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    flags = guard.non_default_flags()
    if flags:
        print(f"portbench: the port's flags are set away from their defaults: {flags}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(1)  # one process, few threads: the host work is dispatch
    print(f"portbench: {cell.name} seed {args.seed} on {_power_limit()}; "
          "peak bandwidth 3.35 TB/s (H100 SXM, 700 W)", file=sys.stderr)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), started)
    plain = guard.plain_calls()
    if plain:
        print(f"portbench: plain versions ran on the card: {plain}", file=sys.stderr)
        return 3
    found = guard.forbidden_modules()
    if found:
        print(f"portbench: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    print(f"portbench: peak memory {result['device']['memory_peak_bytes']} bytes", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
