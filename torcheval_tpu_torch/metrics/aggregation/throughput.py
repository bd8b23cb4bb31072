"""Throughput metric (the port of
``torcheval_tpu/metrics/aggregation/throughput.py``; parity with the
reference ``torcheval/metrics/aggregation/throughput.py``).

States: ``num_total`` + ``elapsed_time_sec``; merge adds counts but takes
the **max** elapsed time: in distributed synchronous training the slowest
rank gates the pipeline (reference ``throughput.py:97-107``).  Update takes
Python numbers (host wall-clock), not tensors."""

import logging
from typing import Iterable

import torch

from torcheval_tpu_torch.metrics.metric import Metric

_logger: logging.Logger = logging.getLogger(__name__)


class Throughput(Metric[torch.Tensor]):
    def __init__(self, *, device=None) -> None:
        super().__init__(device=device)
        self._add_state("num_total", torch.tensor(0.0))
        self._add_state("elapsed_time_sec", torch.tensor(0.0))

    def update(self, num_processed: int, elapsed_time_sec: float) -> "Throughput":
        if num_processed < 0:
            raise ValueError(
                "Expected num_processed to be a non-negative number, but "
                f"received {num_processed}."
            )
        if elapsed_time_sec <= 0:
            raise ValueError(
                "Expected elapsed_time_sec to be a positive number, but "
                f"received {elapsed_time_sec}."
            )
        self.elapsed_time_sec = self.elapsed_time_sec + elapsed_time_sec
        self.num_total = self.num_total + num_processed
        return self

    def compute(self) -> torch.Tensor:
        """Items/sec; warns and returns 0.0 before any update
        (reference ``throughput.py:90-95``)."""
        if not float(self.elapsed_time_sec):
            _logger.warning("No calls to update() have been made - returning 0.0")
            return torch.tensor(0.0, device=self.device)
        return self.num_total / self.elapsed_time_sec

    def merge_state(self, metrics: Iterable["Throughput"]) -> "Throughput":
        for metric in metrics:
            self.num_total = self.num_total + metric.num_total.to(self.device)
            self.elapsed_time_sec = torch.maximum(
                self.elapsed_time_sec, metric.elapsed_time_sec.to(self.device)
            )
        return self
