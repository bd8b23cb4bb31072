"""Metric classes of the port and the :class:`Metric` base."""

from torcheval_tpu_torch.metrics import functional
from torcheval_tpu_torch.metrics.classification import (
    BinaryAccuracy,
    BinaryAUROC,
    BinaryConfusionMatrix,
    BinaryF1Score,
    BinaryPrecision,
    BinaryRecall,
    MulticlassAccuracy,
    MulticlassAUROC,
    MulticlassConfusionMatrix,
    MulticlassF1Score,
    MulticlassPrecision,
    MulticlassRecall,
    MultilabelAccuracy,
    TopKMultilabelAccuracy,
)
from torcheval_tpu_torch.metrics.metric import Metric

__all__ = [
    "BinaryAccuracy",
    "BinaryAUROC",
    "BinaryConfusionMatrix",
    "BinaryF1Score",
    "BinaryPrecision",
    "BinaryRecall",
    "Metric",
    "MulticlassAccuracy",
    "MulticlassAUROC",
    "MulticlassConfusionMatrix",
    "MulticlassF1Score",
    "MulticlassPrecision",
    "MulticlassRecall",
    "MultilabelAccuracy",
    "TopKMultilabelAccuracy",
    "functional",
]
