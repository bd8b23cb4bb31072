from torcheval_tpu_torch.metrics.ranking.hit_rate import HitRate
from torcheval_tpu_torch.metrics.ranking.reciprocal_rank import ReciprocalRank
from torcheval_tpu_torch.metrics.ranking.retrieval import RetrievalPrecision, RetrievalRecall
from torcheval_tpu_torch.metrics.ranking.weighted_calibration import WeightedCalibration

__all__ = [
    "HitRate",
    "ReciprocalRank",
    "RetrievalPrecision",
    "RetrievalRecall",
    "WeightedCalibration",
]
