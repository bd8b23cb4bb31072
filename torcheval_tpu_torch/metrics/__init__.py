"""Metric classes of the port and the :class:`Metric` base."""

from torcheval_tpu_torch.metrics import functional
from torcheval_tpu_torch.metrics.classification import BinaryAUROC, MulticlassAUROC
from torcheval_tpu_torch.metrics.metric import Metric

__all__ = ["BinaryAUROC", "Metric", "MulticlassAUROC", "functional"]
