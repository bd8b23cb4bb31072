"""Whether what the timed path produced is correct: each answer's values
against the plain reference's, gathered into the numbers
``cells/<cell>.json`` names, each held to its limit.

A number gathers members under a gap each:

* ``samples``: a ratio of counts, off by ``|value - reference| x samples``
  (the count it stands for);
* ``exact``: integer results, the largest difference;
* ``abs``: the largest absolute difference;
* ``rel``: the largest difference relative to the reference.

A number is the largest over its members and over every answer compared;
a missing or non-finite value reads the largest float (JSON has no
infinity).
"""

from __future__ import annotations

import math
import sys
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Tuple

import torch

from portbench.reference.members import Data, reference
from portbench.spec import HERE

F64 = torch.float64
Answer = Tuple[Optional[int], Dict[str, Any]]


def _leaves(value: Any) -> List[Any]:
    if isinstance(value, (tuple, list)):
        return [leaf for v in value for leaf in _leaves(v)]
    return [value]


def gap(kind: str, value: Any, ref: Any, samples: int) -> float:
    got, want = _leaves(value), _leaves(ref)
    if len(got) != len(want):
        return math.inf
    worst = 0.0
    for g, w in zip(got, want):
        g, w = torch.as_tensor(g).cpu(), torch.as_tensor(w).cpu()
        if g.shape != w.shape:
            return math.inf
        if kind == "exact" and not (g.is_floating_point() or w.is_floating_point()):
            # integer results: most answers are equal, which costs no copy
            if not torch.equal(g.to(w.dtype), w):
                worst = max(worst, float((g.to(torch.int64) - w.to(torch.int64)).abs().max()))
            continue
        g, w = g.to(F64), w.to(F64)
        if not bool(torch.isfinite(g).all()):
            return math.inf
        diff = (g - w).abs()
        if kind == "samples":
            diff = diff * samples
        elif kind == "rel":
            diff = diff / w.abs()
        elif kind not in ("exact", "abs"):
            raise ValueError(f"unknown gap {kind!r}")
        worst = max(worst, float(diff.max()) if diff.numel() else 0.0)
    return worst


def members(suite_spec: Dict[str, Any]) -> Dict[str, Tuple[str, Dict[str, Any]]]:
    return {
        name: (m["class"], dict(m.get("kwargs", {})))
        for g in suite_spec["suite"]
        for name, m in g["members"].items()
    }


class Reference:
    """The reference's values at each position, each worked out once."""

    def __init__(self, suite_spec: Dict[str, Any], data: Data, bench_dir: Path = HERE) -> None:
        self.members = members(suite_spec)
        self.data = data
        self.bench_dir = bench_dir
        self._cache: Dict[Optional[int], Dict[str, Any]] = {}

    def values(self, position: Optional[int]) -> Dict[str, Any]:
        if position not in self._cache:
            self._cache[position] = {
                name: reference(cls, kw, self.data, position, self.bench_dir)
                for name, (cls, kw) in self.members.items()
            }
        return self._cache[position]


def judge(
    suite_spec: Dict[str, Any], ref: Reference, answers: Iterable[Answer]
) -> Tuple[Dict[str, Dict[str, float]], int, int]:
    """``({number: {"value", "limit"}}, attempted, failed)``: each number
    the worst over the answers, and the answers with a number over its
    limit."""
    numbers = suite_spec["numbers"]
    worst = {name: 0.0 for name in numbers}
    attempted = failed = 0
    for position, values in answers:
        attempted += 1
        want = ref.values(position)
        samples = ref.data.samples_before(position)
        bad = False
        for name, spec in numbers.items():
            reading = max(
                gap(kind, values.get(member), want[member], samples)
                if member in values
                else math.inf
                for member, kind in spec["members"].items()
            )
            worst[name] = max(worst[name], min(reading, sys.float_info.max))
            bad |= not reading <= spec["limit"]
        failed += bad
    checks = {name: {"value": worst[name], "limit": numbers[name]["limit"]} for name in numbers}
    return checks, attempted, failed
