"""ReciprocalRank metric (the port of
``torcheval_tpu/metrics/ranking/reciprocal_rank.py``; parity with the
reference ``torcheval/metrics/ranking/reciprocal_rank.py``).
Buffer state: the per-sample reciprocal ranks of each update."""

from typing import Optional

from torcheval_tpu_torch.metrics._fuse import on_device
from torcheval_tpu_torch.metrics.functional.ranking.reciprocal_rank import reciprocal_rank
from torcheval_tpu_torch.metrics.ranking._scores import ScoreBuffer


class ReciprocalRank(ScoreBuffer):
    def __init__(self, *, k: Optional[int] = None, device=None) -> None:
        super().__init__(device=device)
        self.k = k

    def update(self, input, target) -> "ReciprocalRank":
        input, target = on_device(self.device, input, target)
        self.scores.append(reciprocal_rank(input, target, k=self.k))
        return self
