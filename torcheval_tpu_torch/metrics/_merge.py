"""Shared merge helpers for counter-state metrics.

Counter states merge by elementwise addition, so a sync can reduce them
with one all-reduce instead of gathering buffers."""

from typing import Iterable

from torcheval_tpu_torch.metrics.metric import Metric


def merge_add(metric: Metric, metrics: Iterable[Metric], *state_names: str) -> None:
    """Add each named counter state of ``metrics`` into ``metric``."""
    for other in metrics:
        for name in state_names:
            setattr(
                metric,
                name,
                getattr(metric, name) + getattr(other, name).to(metric.device),
            )
