from torcheval_tpu_torch.metrics.classification.auroc import (
    BinaryAUROC,
    MulticlassAUROC,
)

__all__ = ["BinaryAUROC", "MulticlassAUROC"]
