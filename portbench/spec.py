"""Find a cell's files by the names in ``BENCHMARK.json``.

``BENCHMARK.json`` at the root of the checkout lists the cells; each
cell's configuration, traffic mix, suite and per-layer readers are files
under ``portbench/`` named after them, and so is the code they name: the
loop a traffic mix drives (``loops/<loop>.py``), the input generator a
configuration names (``inputs/<kind>.py``) and the reference of each
metric class a suite holds (``reference/members/<Class>.py``).  Nothing
here knows a cell, a loop, a generator or a class by name.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent


@dataclass
class Metric:
    """One metric of ``BENCHMARK.json`` (end-to-end or per-layer)."""

    name: str
    unit: str
    better: str
    source: str
    workloads: Optional[List[str]] = None
    layer: Optional[str] = None
    moves: Optional[str] = None
    bound: Optional[float] = None

    def applies_to(self, cell: str) -> bool:
        return self.workloads is None or cell in self.workloads


@dataclass
class Cell:
    """Everything one run of one cell reads."""

    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    suite: Dict[str, Any]
    end_to_end: List[Metric]
    per_layer: List[Metric]
    bench_dir: Path = HERE
    readers: Dict[str, Callable[..., Optional[float]]] = field(default_factory=dict)


def _load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


_MODULES: Dict[Path, Any] = {}


def load_file(path: Path) -> Any:
    """The module of the file ``path``, loaded by path (a name may hold
    dots) and once: a second call returns the same module."""
    path = Path(path).resolve()
    if path not in _MODULES:
        if not path.is_file():
            raise FileNotFoundError(path)
        tag = "".join(c if c.isalnum() else "_" for c in f"{path.parent.name}_{path.stem}")
        spec = importlib.util.spec_from_file_location(f"portbench_file_{tag}", path)
        if spec is None or spec.loader is None:
            raise FileNotFoundError(path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _MODULES[path] = module
    return _MODULES[path]


def find(kind: str, name: str, bench_dir: Path = HERE) -> Any:
    """The module ``<kind>/<name>.py``: from ``bench_dir``, else from
    ``portbench/`` itself (a test adds files in a directory of its own)."""
    for base in dict.fromkeys((Path(bench_dir), HERE)):
        path = base / kind / f"{name}.py"
        if path.is_file():
            return load_file(path)
    raise FileNotFoundError(f"no {kind}/{name}.py under {bench_dir} or {HERE}")


def load_reader(path: Path) -> Callable[..., Optional[float]]:
    """The ``read(trace)`` function of a per-layer metric's file."""
    return load_file(path).read


def load_cell(name: str, root: Path, bench_dir: Path = HERE) -> Cell:
    """The cell ``name`` of ``root/BENCHMARK.json``, with its files from
    ``bench_dir`` (``portbench/`` unless a test adds files elsewhere)."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(root / configs[entry["config"]]["file"])
    traffic = _load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    suite = _load_json(bench_dir / "cells" / f"{name}.json")
    e2e = [Metric(**m) for m in bench["end_to_end"]]
    per_layer = [Metric(**m) for m in bench["per_layer"]]
    cell = Cell(
        name=name,
        chips=int(entry["chips"]),
        config=config,
        traffic=traffic,
        suite=suite,
        end_to_end=[m for m in e2e if m.applies_to(name)],
        per_layer=[m for m in per_layer if m.applies_to(name)],
        bench_dir=Path(bench_dir),
    )
    for m in cell.per_layer:
        cell.readers[m.name] = find("layer_metrics", m.name, bench_dir).read
    return cell
