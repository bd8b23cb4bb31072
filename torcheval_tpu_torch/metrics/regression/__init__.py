from torcheval_tpu_torch.metrics.regression.mean_squared_error import MeanSquaredError
from torcheval_tpu_torch.metrics.regression.r2_score import R2Score

__all__ = ["MeanSquaredError", "R2Score"]
