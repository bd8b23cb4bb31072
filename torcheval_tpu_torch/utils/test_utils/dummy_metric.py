"""Dummy metrics, one per legal state-container type, for the base-class
tests (the port of ``torcheval_tpu/utils/test_utils/dummy_metric.py``)."""

from collections import defaultdict, deque
from typing import Iterable

import torch

from torcheval_tpu_torch.metrics.metric import Metric


class DummySumMetric(Metric[torch.Tensor]):
    """Tensor-state summer."""

    def __init__(self, *, device=None) -> None:
        super().__init__(device=device)
        self._add_state("sum", torch.tensor(0.0))

    def update(self, x) -> "DummySumMetric":
        self.sum = self.sum + torch.as_tensor(x, device=self.device)
        return self

    def compute(self) -> torch.Tensor:
        return self.sum

    def merge_state(self, metrics: Iterable["DummySumMetric"]) -> "DummySumMetric":
        for metric in metrics:
            self.sum = self.sum + metric.sum.to(self.device)
        return self


class DummySumListStateMetric(Metric[torch.Tensor]):
    """List-state summer."""

    def __init__(self, *, device=None) -> None:
        super().__init__(device=device)
        self._add_state("x", [])

    def update(self, x) -> "DummySumListStateMetric":
        self.x.append(torch.as_tensor(x, device=self.device))
        return self

    def compute(self) -> torch.Tensor:
        return sum(t.sum() for t in self.x)

    def merge_state(
        self, metrics: Iterable["DummySumListStateMetric"]
    ) -> "DummySumListStateMetric":
        for metric in metrics:
            self.x.extend(t.to(self.device) for t in metric.x)
        return self


class DummySumDictStateMetric(Metric[torch.Tensor]):
    """Dict-state summer."""

    def __init__(self, *, device=None) -> None:
        super().__init__(device=device)
        self._add_state("x", defaultdict(lambda: torch.tensor(0.0)))

    def update(self, k: str, v) -> "DummySumDictStateMetric":
        current = self.x[k] if k in self.x else torch.tensor(0.0, device=self.device)
        self.x[k] = current + torch.as_tensor(v, device=self.device)
        return self

    def compute(self):
        return self.x

    def merge_state(
        self, metrics: Iterable["DummySumDictStateMetric"]
    ) -> "DummySumDictStateMetric":
        for metric in metrics:
            for k in metric.x.keys():
                current = self.x[k] if k in self.x else torch.tensor(0.0, device=self.device)
                self.x[k] = current + metric.x[k].to(self.device)
        return self


class DummySumDequeStateMetric(Metric[torch.Tensor]):
    """Deque-state summer with maxlen=10."""

    def __init__(self, *, device=None) -> None:
        super().__init__(device=device)
        self._add_state("x", deque(maxlen=10))

    def update(self, x) -> "DummySumDequeStateMetric":
        self.x.append(torch.as_tensor(x, device=self.device))
        return self

    def compute(self) -> torch.Tensor:
        return sum(t.sum() for t in self.x)

    def merge_state(
        self, metrics: Iterable["DummySumDequeStateMetric"]
    ) -> "DummySumDequeStateMetric":
        for metric in metrics:
            self.x.extend(t.to(self.device) for t in metric.x)
        return self
