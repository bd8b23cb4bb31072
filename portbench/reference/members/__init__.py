"""The reference value of each suite member, by the member's class and
arguments, at a position of the traffic: ``members/<Class>.py`` for each
metric class a suite holds, found by the class's name, with
``reference(kwargs, data, position)``.

A :class:`Data` holds what the benchmark made: the whole evaluation set
(``position`` ``None``: a pass over all of it) or a pool of batches that a
stream cycles through in order (``position`` ``u``: the first ``u``
batches of the stream have been handed over).  Values come back as float64
or int64 host tensors, in the shapes the members give: a windowed member's
value is ``(lifetime, windowed)``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from portbench.reference import formulas as f
from portbench.spec import HERE, find


class Data:
    def __init__(self, tensors: Dict[str, torch.Tensor], batch: int, dtype) -> None:
        self.input = tensors["input"]
        self.target = tensors["target"]
        self.batch = int(batch)
        self.dtype = dtype
        self.n = self.input.shape[0]
        self.batches = -(-self.n // self.batch)
        self._stats: Optional[torch.Tensor] = None

    # ------------------------------------------------------------ samples
    def sample_range(self, lo: int, hi: int) -> Dict[str, torch.Tensor]:
        """Samples ``lo`` to ``hi`` of the stream, the pool cycled."""
        idx = torch.arange(lo, hi, device=self.input.device) % self.n
        return {"input": self.input[idx], "target": self.target[idx]}

    def samples_before(self, position: Optional[int]) -> int:
        return self.n if position is None else position * self.batch

    # -------------------------------------------------------- batch stats
    def batch_stats(self) -> torch.Tensor:
        """``binary_stats`` of each batch of the pool, (batches, 5)."""
        if self._stats is None:
            self._stats = torch.stack(
                [
                    f.binary_stats(self.input[i : i + self.batch], self.target[i : i + self.batch], self.dtype)
                    for i in range(0, self.n, self.batch)
                ]
            )
        return self._stats

    def update_stats(self, lo: int, hi: int) -> torch.Tensor:
        """The stats of stream updates ``lo`` to ``hi`` summed."""
        per = self.batch_stats()
        cycles, rest = divmod(hi - lo, self.batches)
        start = lo % self.batches
        idx = torch.arange(start, start + rest, device=per.device) % self.batches
        return cycles * per.sum(0) + per[idx].sum(0)

    def all_stats(self, position: Optional[int]) -> torch.Tensor:
        return self.update_stats(0, self.batches if position is None else position)


Ref = Callable[[Dict[str, Any], Data, Optional[int]], Any]


def whole(data: Data, position: Optional[int]) -> Dict[str, torch.Tensor]:
    """The whole evaluation set, for a member that answers whole passes."""
    if position is not None:
        raise ValueError("a whole-set member answers whole passes only")
    return {"input": data.input, "target": data.target}


def ratio(fn: Callable[[torch.Tensor], torch.Tensor], shape: List[int]) -> Ref:
    """A member whose value is ``fn`` of every update's summed stats."""

    def ref(kw, data, position):
        return f.result(fn(data.all_stats(position)).reshape(shape), data.dtype)

    return ref


def windowed_ratio(fn: Callable[[torch.Tensor], torch.Tensor]) -> Ref:
    """A windowed member: ``(lifetime, windowed)``, the window the last
    ``max_num_updates`` updates."""

    def ref(kw, data, position):
        w = int(kw["max_num_updates"])
        windowed = fn(data.update_stats(max(0, position - w), position))
        lifetime = fn(data.all_stats(position))
        return (f.result(lifetime.reshape(1), data.dtype), f.result(windowed.reshape(1), data.dtype))

    return ref


def reference(
    cls: str, kwargs: Dict[str, Any], data: Data, position: Optional[int], bench_dir: Path = HERE
) -> Any:
    """The value of a member of class ``cls`` built with ``kwargs``."""
    return find("reference/members", cls, bench_dir).reference(kwargs, data, position)
