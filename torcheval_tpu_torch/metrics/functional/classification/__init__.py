from torcheval_tpu_torch.metrics.functional.classification.auroc import (
    binary_auroc,
    multiclass_auroc,
)

__all__ = ["binary_auroc", "multiclass_auroc"]
