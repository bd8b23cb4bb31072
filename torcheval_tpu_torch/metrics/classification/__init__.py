from torcheval_tpu_torch.metrics.classification.accuracy import (
    BinaryAccuracy,
    MulticlassAccuracy,
    MultilabelAccuracy,
    TopKMultilabelAccuracy,
)
from torcheval_tpu_torch.metrics.classification.auroc import (
    BinaryAUROC,
    MulticlassAUROC,
)
from torcheval_tpu_torch.metrics.classification.confusion_matrix import (
    BinaryConfusionMatrix,
    MulticlassConfusionMatrix,
)
from torcheval_tpu_torch.metrics.classification.f1_score import (
    BinaryF1Score,
    MulticlassF1Score,
)
from torcheval_tpu_torch.metrics.classification.precision import (
    BinaryPrecision,
    MulticlassPrecision,
)
from torcheval_tpu_torch.metrics.classification.recall import (
    BinaryRecall,
    MulticlassRecall,
)

__all__ = [
    "BinaryAccuracy",
    "BinaryAUROC",
    "BinaryConfusionMatrix",
    "BinaryF1Score",
    "BinaryPrecision",
    "BinaryRecall",
    "MulticlassAccuracy",
    "MulticlassAUROC",
    "MulticlassConfusionMatrix",
    "MulticlassF1Score",
    "MulticlassPrecision",
    "MulticlassRecall",
    "MultilabelAccuracy",
    "TopKMultilabelAccuracy",
]
