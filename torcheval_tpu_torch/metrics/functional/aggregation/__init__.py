from torcheval_tpu_torch.metrics.functional.aggregation.auc import auc
from torcheval_tpu_torch.metrics.functional.aggregation.click_through_rate import (
    click_through_rate,
)
from torcheval_tpu_torch.metrics.functional.aggregation.mean import mean
from torcheval_tpu_torch.metrics.functional.aggregation.sum import sum  # noqa: A004
from torcheval_tpu_torch.metrics.functional.aggregation.throughput import throughput

__all__ = ["auc", "click_through_rate", "mean", "sum", "throughput"]
