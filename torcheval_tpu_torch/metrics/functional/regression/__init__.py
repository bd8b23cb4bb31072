from torcheval_tpu_torch.metrics.functional.regression.mean_squared_error import (
    mean_squared_error,
)
from torcheval_tpu_torch.metrics.functional.regression.r2_score import r2_score

__all__ = ["mean_squared_error", "r2_score"]
