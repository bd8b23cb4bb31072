from torcheval_tpu_torch.metrics.functional.ranking.frequency import frequency_at_k
from torcheval_tpu_torch.metrics.functional.ranking.hit_rate import hit_rate
from torcheval_tpu_torch.metrics.functional.ranking.num_collisions import num_collisions
from torcheval_tpu_torch.metrics.functional.ranking.reciprocal_rank import reciprocal_rank
from torcheval_tpu_torch.metrics.functional.ranking.retrieval import (
    retrieval_precision,
    retrieval_recall,
)
from torcheval_tpu_torch.metrics.functional.ranking.weighted_calibration import (
    weighted_calibration,
)

__all__ = [
    "frequency_at_k",
    "hit_rate",
    "num_collisions",
    "reciprocal_rank",
    "retrieval_precision",
    "retrieval_recall",
    "weighted_calibration",
]
