"""Stateless functional metrics of the port.  Each runs where its input
tensors live; numpy arrays and lists go to the GPU (see
``_host_checks.place_inputs``)."""

from torcheval_tpu_torch.metrics.functional._host_checks import skip_value_checks
from torcheval_tpu_torch.metrics.functional.classification import (
    binary_accuracy,
    binary_auroc,
    binary_confusion_matrix,
    binary_f1_score,
    binary_precision,
    binary_recall,
    multiclass_accuracy,
    multiclass_auroc,
    multiclass_confusion_matrix,
    multiclass_f1_score,
    multiclass_precision,
    multiclass_recall,
    multilabel_accuracy,
    topk_multilabel_accuracy,
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
    "skip_value_checks",
    "topk_multilabel_accuracy",
]
