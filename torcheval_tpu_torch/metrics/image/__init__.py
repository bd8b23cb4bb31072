"""Image metric classes (the port of ``torcheval_tpu/metrics/image/``)."""

from torcheval_tpu_torch.metrics.image.fid import FrechetInceptionDistance
from torcheval_tpu_torch.metrics.image.psnr import PeakSignalNoiseRatio
from torcheval_tpu_torch.metrics.image.ssim import StructuralSimilarity

__all__ = [
    "FrechetInceptionDistance",
    "PeakSignalNoiseRatio",
    "StructuralSimilarity",
]
