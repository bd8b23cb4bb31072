from torcheval_tpu_torch.utils.test_utils.dummy_metric import (
    DummySumDequeStateMetric,
    DummySumDictStateMetric,
    DummySumListStateMetric,
    DummySumMetric,
)
from torcheval_tpu_torch.utils.test_utils.metric_class_tester import MetricClassTester

__all__ = [
    "DummySumMetric",
    "DummySumListStateMetric",
    "DummySumDictStateMetric",
    "DummySumDequeStateMetric",
    "MetricClassTester",
]
