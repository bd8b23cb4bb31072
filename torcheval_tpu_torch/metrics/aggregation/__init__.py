from torcheval_tpu_torch.metrics.aggregation.auc import AUC
from torcheval_tpu_torch.metrics.aggregation.cat import Cat
from torcheval_tpu_torch.metrics.aggregation.click_through_rate import ClickThroughRate
from torcheval_tpu_torch.metrics.aggregation.max import Max
from torcheval_tpu_torch.metrics.aggregation.mean import Mean
from torcheval_tpu_torch.metrics.aggregation.min import Min
from torcheval_tpu_torch.metrics.aggregation.sum import Sum
from torcheval_tpu_torch.metrics.aggregation.throughput import Throughput

__all__ = ["AUC", "Cat", "ClickThroughRate", "Max", "Mean", "Min", "Sum", "Throughput"]
