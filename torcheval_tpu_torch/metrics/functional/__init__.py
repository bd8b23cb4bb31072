"""Stateless functional metrics of the port; each runs where its input
tensors live."""

from torcheval_tpu_torch.metrics.functional._host_checks import skip_value_checks
from torcheval_tpu_torch.metrics.functional.classification import (
    binary_auroc,
    multiclass_auroc,
)

__all__ = ["binary_auroc", "multiclass_auroc", "skip_value_checks"]
