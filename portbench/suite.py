"""A cell's metric suite: the port's ``MetricCollection`` groups that its
``cells/<cell>.json`` lists.

Each group is one collection, updated with the batch's tensors the group
names in ``args`` (``["input", "target"]``, or ``["target"]`` for a
click-through rate, whose input is the labels).  Member names are unique
across groups, so the suite's values are one dict.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence

import torch

Values = Dict[str, Any]


class Group:
    def __init__(self, spec: Dict[str, Any], device) -> None:
        from torcheval_tpu_torch import metrics
        from torcheval_tpu_torch.metrics.collection import MetricCollection

        self.args: List[str] = list(spec["args"])
        self.members = {
            name: (m["class"], dict(m.get("kwargs", {})))
            for name, m in spec["members"].items()
        }
        self.collection = MetricCollection(
            {
                name: getattr(metrics, cls)(**kwargs, device=device)
                for name, (cls, kwargs) in self.members.items()
            },
            **spec.get("collection", {}),
        )

    def update(self, batch: Dict[str, torch.Tensor]) -> None:
        self.collection.update(*(batch[a] for a in self.args))


class Suite:
    def __init__(self, groups: Sequence[Dict[str, Any]], device) -> None:
        self.groups = [Group(g, device) for g in groups]
        names = [n for g in self.groups for n in g.members]
        if len(set(names)) != len(names):
            raise ValueError(f"member names repeat across groups: {names}")

    def update(self, batch: Dict[str, torch.Tensor]) -> None:
        for g in self.groups:
            g.update(batch)

    def compute(self) -> Values:
        out: Values = {}
        for g in self.groups:
            out.update(g.collection.compute())
        return out

    def reset(self) -> None:
        for g in self.groups:
            g.collection.reset()


def to_host(value: Any) -> Any:
    """``value`` with every tensor copied to the host (the copies end the
    result's latency: the values are then readable)."""
    if isinstance(value, torch.Tensor):
        return value.cpu()
    if isinstance(value, dict):
        return {k: to_host(v) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return type(value)(to_host(v) for v in value)
    return value
