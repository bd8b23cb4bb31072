from torcheval_tpu_torch.metrics.functional.classification.accuracy import (
    binary_accuracy,
    multiclass_accuracy,
    multilabel_accuracy,
    topk_multilabel_accuracy,
)
from torcheval_tpu_torch.metrics.functional.classification.auroc import (
    binary_auroc,
    multiclass_auroc,
)
from torcheval_tpu_torch.metrics.functional.classification.confusion_matrix import (
    binary_confusion_matrix,
    multiclass_confusion_matrix,
)
from torcheval_tpu_torch.metrics.functional.classification.f1_score import (
    binary_f1_score,
    multiclass_f1_score,
)
from torcheval_tpu_torch.metrics.functional.classification.precision import (
    binary_precision,
    multiclass_precision,
)
from torcheval_tpu_torch.metrics.functional.classification.recall import (
    binary_recall,
    multiclass_recall,
)

__all__ = [
    "binary_accuracy",
    "binary_auroc",
    "binary_confusion_matrix",
    "binary_f1_score",
    "binary_precision",
    "binary_recall",
    "multiclass_accuracy",
    "multiclass_auroc",
    "multiclass_confusion_matrix",
    "multiclass_f1_score",
    "multiclass_precision",
    "multiclass_recall",
    "multilabel_accuracy",
    "topk_multilabel_accuracy",
]
