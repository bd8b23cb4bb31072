"""Windowed class metrics (the port of ``torcheval_tpu/metrics/window/``;
reference ``torcheval/metrics/window/``): ring-buffer states over the last
N samples / update calls."""

from torcheval_tpu_torch.metrics.window.auroc import WindowedBinaryAUROC
from torcheval_tpu_torch.metrics.window.click_through_rate import WindowedClickThroughRate
from torcheval_tpu_torch.metrics.window.mean_squared_error import WindowedMeanSquaredError
from torcheval_tpu_torch.metrics.window.normalized_entropy import (
    WindowedBinaryNormalizedEntropy,
)
from torcheval_tpu_torch.metrics.window.weighted_calibration import (
    WindowedWeightedCalibration,
)

__all__ = [
    "WindowedBinaryAUROC",
    "WindowedBinaryNormalizedEntropy",
    "WindowedClickThroughRate",
    "WindowedMeanSquaredError",
    "WindowedWeightedCalibration",
]
