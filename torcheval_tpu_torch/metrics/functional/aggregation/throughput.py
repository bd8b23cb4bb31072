"""Throughput (the port of
``torcheval_tpu/metrics/functional/aggregation/throughput.py``; parity
with the reference
``torcheval/metrics/functional/aggregation/throughput.py``).

Host-time semantics: the inputs are Python numbers, not tensors (elapsed
time is wall-clock measured outside the device), so the result is a
tensor on the host."""

import torch


def throughput(num_processed: int = 0, elapsed_time_sec: float = 0.0) -> torch.Tensor:
    """Items processed per second (reference ``throughput.py:24-47``)."""
    return _throughput_compute(num_processed, elapsed_time_sec)


def _throughput_compute(num_processed: int, elapsed_time_sec: float) -> torch.Tensor:
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
    return torch.tensor(num_processed / elapsed_time_sec)
