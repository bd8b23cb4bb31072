"""The loops that drive the library: ``loops/<loop>.py`` for each
``loop`` a traffic mix names, found by that name.

A loop file defines ``Loop(config, traffic, suite_spec, data, device)``
with ``samples(config, traffic)`` (a static method: the samples the
inputs hold), ``warm()``, ``unit(rec, mark)`` and ``free()``.  A loop
warms every shape it will use in :meth:`warm` (set-up), then runs one
*unit* a call of :meth:`unit`: an evaluation pass, or a monitor's cycle
of updates and one compute.  A unit ends with every value of the suite on
the host, so the clock read after it has all its work done.  ``mark``
wraps the calls into the library in named ranges; the traced run passes
``torch.profiler.record_function``, the measured one nothing.
"""

from __future__ import annotations

import contextlib
import random
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, ContextManager, Dict, List, Optional, Tuple

import torch

from portbench.spec import HERE, find

Mark = Callable[[str], ContextManager[Any]]
Answer = Tuple[Optional[int], Dict[str, Any]]


def no_mark(name: str) -> ContextManager[Any]:
    return contextlib.nullcontext()


@dataclass
class Record:
    """What the units of a window handed over and got back.  An answer is
    ``(position, values)``: the updates made before the compute (``None``
    for a whole pass) and the suite's values on the host.

    With ``keep`` set, the record holds a uniform sample of at most
    ``keep`` of the answers, drawn by ``rng`` (reservoir sampling), so a
    long window holds a bounded store; ``offered`` counts them all."""

    keep: int = 0
    rng: random.Random = field(default_factory=lambda: random.Random(0))
    samples: int = 0
    batches: int = 0
    computes: int = 0
    offered: int = 0
    update_s: List[float] = field(default_factory=list)
    result_s: List[float] = field(default_factory=list)
    answers: List[Answer] = field(default_factory=list)

    def answer(self, position: Optional[int], values: Dict[str, Any]) -> None:
        self.offered += 1
        if not self.keep or len(self.answers) < self.keep:
            self.answers.append((position, values))
            return
        slot = self.rng.randrange(self.offered)
        if slot < self.keep:
            self.answers[slot] = (position, values)


def split(data: Dict[str, torch.Tensor], batch: int) -> List[Dict[str, torch.Tensor]]:
    """Consecutive batches of ``batch`` rows (the last may be shorter)."""
    n = next(iter(data.values())).shape[0]
    return [{k: v[i : i + batch] for k, v in data.items()} for i in range(0, n, batch)]


def load(name: str, bench_dir: Path = HERE) -> Any:
    """The ``Loop`` class of ``loops/<name>.py``."""
    return find("loops", name, bench_dir).Loop
