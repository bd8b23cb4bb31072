from torcheval_tpu_torch.metrics.functional.image.fid import gaussian_frechet_distance
from torcheval_tpu_torch.metrics.functional.image.psnr import peak_signal_noise_ratio
from torcheval_tpu_torch.metrics.functional.image.ssim import structural_similarity

__all__ = [
    "gaussian_frechet_distance",
    "peak_signal_noise_ratio",
    "structural_similarity",
]
