"""HitRate metric (the port of ``torcheval_tpu/metrics/ranking/hit_rate.py``;
parity with the reference ``torcheval/metrics/ranking/hit_rate.py``).
Buffer state: the per-sample hit scores of each update."""

from typing import Optional

from torcheval_tpu_torch.metrics._fuse import on_device
from torcheval_tpu_torch.metrics.functional.ranking.hit_rate import hit_rate
from torcheval_tpu_torch.metrics.ranking._scores import ScoreBuffer


class HitRate(ScoreBuffer):
    def __init__(self, *, k: Optional[int] = None, device=None) -> None:
        super().__init__(device=device)
        self.k = k

    def update(self, input, target) -> "HitRate":
        input, target = on_device(self.device, input, target)
        self.scores.append(hit_rate(input, target, k=self.k))
        return self
