"""StructuralSimilarity metric (the port of
``torcheval_tpu/metrics/image/ssim.py``): counter states over per-image
SSIM, add merge."""

from typing import Iterable

import torch

from torcheval_tpu_torch.metrics._fuse import on_device
from torcheval_tpu_torch.metrics._merge import merge_add
from torcheval_tpu_torch.metrics.functional.image.ssim import _ssim_input_check, _ssim_per_image
from torcheval_tpu_torch.metrics.metric import Metric


class StructuralSimilarity(Metric[torch.Tensor]):
    """Mean SSIM over all images seen; NaN before any update (0/0)."""

    def __init__(
        self,
        *,
        data_range: float = 1.0,
        kernel_size: int = 11,
        sigma: float = 1.5,
        k1: float = 0.01,
        k2: float = 0.03,
        device=None,
    ) -> None:
        super().__init__(device=device)
        self.data_range = float(data_range)
        self.kernel_size = kernel_size
        self.sigma = float(sigma)
        self.k1 = float(k1)
        self.k2 = float(k2)
        self._add_state("mssim_sum", torch.tensor(0.0))
        self._add_state("num_images", torch.tensor(0.0))

    def update(self, input, target) -> "StructuralSimilarity":
        input, target = on_device(self.device, input, target)
        _ssim_input_check(input, target, self.kernel_size)
        per_image = _ssim_per_image(
            input, target, self.data_range, self.kernel_size, self.sigma, self.k1, self.k2
        )
        self.mssim_sum = self.mssim_sum + per_image.sum()
        self.num_images = self.num_images + float(per_image.shape[0])
        return self

    def compute(self) -> torch.Tensor:
        return self.mssim_sum / self.num_images

    def merge_state(self, metrics: Iterable["StructuralSimilarity"]) -> "StructuralSimilarity":
        merge_add(self, metrics, "mssim_sum", "num_images")
        return self
