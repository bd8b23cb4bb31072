"""Cells of ``BENCHMARK.json`` cut to a size the CPU runs in a second,
for the tests: fewer samples, classes and window rows, the same loops,
suites and numbers."""

from pathlib import Path

import torch

from portbench.run import run_cell
from portbench.spec import load_cell

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("imagenet1k.eager", "criteo.epoch", "criteo.window")
CLASSES = 20


def tiny_cell(name: str, root: Path = ROOT, bench_dir=None):
    cell = load_cell(name, root) if bench_dir is None else load_cell(name, root, bench_dir)
    c = cell.config
    if "num_classes" in c:
        c.update(num_samples=100 * CLASSES, num_classes=CLASSES)
        c["inputs"]["num_classes"] = CLASSES
    else:
        c.update(num_samples=50_000, eval_batch=4096, monitor_batch=512)
    if cell.traffic["loop"] == "window":
        cell.traffic.update(pool_batches=30, compute_every=5, prefill_updates=10)
    for group in cell.suite["suite"]:
        for m in group["members"].values():
            kw = m.get("kwargs", {})
            if "num_classes" in kw:
                kw["num_classes"] = CLASSES
            if "max_num_samples" in kw:
                kw["max_num_samples"] = 5000
            if "max_num_updates" in kw:
                kw["max_num_updates"] = 10
    return cell


def run_tiny(cell, seed: int = 2**31 + 11, trace: bool = False, seconds: float = 0.2):
    import time

    return run_cell(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter())
