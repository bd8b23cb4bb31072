"""The comparison's control: the plain reference put in the program's
place and computed one precision below the configurations' float32, in
bfloat16 (inputs rounded to it, every real result rounded to it; counts
stay exact).  A sound comparison finds it not correct.

    python -m portbench.control --workload <cell> --seeds 1 2 3 [--computes 200]

prints, for each seed, the control's reading of every number of the
cell beside its limit, at the cell's own size.  A whole-pass cell has one
answer a seed; a monitor cell has ``--computes`` answers, at the
positions a run's computes take.  The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Any, Dict

import torch

from portbench import inputs, loops
from portbench.judge import Reference, judge
from portbench.reference.members import Data
from portbench.spec import Cell, load_cell


def readings(cell: Cell, seed: int, device, computes: int = 200) -> Dict[str, Any]:
    """The control's numbers for one seed: ``{number: {"value", "limit"}}``
    and whether the comparison found it correct."""
    loop = loops.load(cell.traffic["loop"], cell.bench_dir)
    n = loop.samples(cell.config, cell.traffic)
    data = inputs.make(cell.config["inputs"], n, seed, device, cell.bench_dir)
    batch = cell.config[cell.traffic["batch"]]
    control = Reference(cell.suite, Data(data, batch, torch.bfloat16), cell.bench_dir)
    ref = Reference(cell.suite, Data(data, batch, torch.float64), cell.bench_dir)
    answers = [(p, control.values(p)) for p in loop.positions(cell.traffic, computes)]
    checks, attempted, failed = judge(cell.suite, ref, answers)
    return {"seed": seed, "correct": attempted > 0 and failed == 0, "checks": checks}


def main(argv) -> int:
    parser = argparse.ArgumentParser(prog="python -m portbench.control")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--computes", type=int, default=200)
    args = parser.parse_args(argv)
    cell = load_cell(args.workload, Path.cwd())
    if not torch.cuda.is_available():
        print("portbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        out = readings(cell, seed, torch.device("cuda", 0), args.computes)
        print(json.dumps({"workload": cell.name, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
