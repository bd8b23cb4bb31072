"""Retrieval precision / recall class metrics (the port of
``torcheval_tpu/metrics/ranking/retrieval.py``): per-query score buffers,
like HitRate / ReciprocalRank.  Each update scores one query (or
``num_tasks`` of them) and appends; compute concatenates the per-query
values, shape ``(num_queries,)`` or ``(num_queries * num_tasks,)``."""

from typing import Optional

from torcheval_tpu_torch.metrics._fuse import on_device
from torcheval_tpu_torch.metrics.functional.ranking.retrieval import (
    retrieval_precision,
    retrieval_recall,
)
from torcheval_tpu_torch.metrics.ranking._scores import ScoreBuffer


class _RetrievalMetric(ScoreBuffer):
    """Shared buffer machinery; subclasses pick the per-query scorer."""

    _scorer = None

    def __init__(
        self,
        *,
        k: Optional[int] = None,
        limit_k_to_size: bool = False,
        num_tasks: int = 1,
        device=None,
    ) -> None:
        super().__init__(device=device)
        if num_tasks < 1:
            raise ValueError(
                "`num_tasks` value should be greater than and equal to 1, "
                f"but received {num_tasks}. "
            )
        self.k = k
        self.limit_k_to_size = limit_k_to_size
        self.num_tasks = num_tasks

    def update(self, input, target):
        input, target = on_device(self.device, input, target)
        value = type(self)._scorer(
            input, target, self.k, limit_k_to_size=self.limit_k_to_size, num_tasks=self.num_tasks
        )
        self.scores.append(value.reshape(-1))
        return self


class RetrievalPrecision(_RetrievalMetric):
    """precision@k per query seen."""

    _scorer = staticmethod(retrieval_precision)


class RetrievalRecall(_RetrievalMetric):
    """recall@k per query seen."""

    _scorer = staticmethod(retrieval_recall)
