"""BLEUScore class metric (the port of
``torcheval_tpu/metrics/text/bleu.py``): four counters over host-side
n-gram statistics that merge by addition."""

from typing import Iterable, Optional, Sequence

import torch

from torcheval_tpu_torch.metrics._merge import merge_add
from torcheval_tpu_torch.metrics.functional.classification.binary_normalized_entropy import (
    _accum_dtype,
)
from torcheval_tpu_torch.metrics.functional.text.bleu import (
    TBleuInput,
    TBleuTarget,
    _bleu_compute,
    _bleu_param_check,
    _bleu_update,
)
from torcheval_tpu_torch.metrics.metric import Metric

_STATES = (
    "input_len",
    "target_len",
    "matches_by_order",
    "possible_matches_by_order",
)


class BLEUScore(Metric[torch.Tensor]):
    """Corpus BLEU accumulated over updates; 0 before any update."""

    def __init__(
        self,
        *,
        n_gram: int = 4,
        weights: Optional[Sequence[float]] = None,
        device=None,
    ) -> None:
        super().__init__(device=device)
        self.weights = _bleu_param_check(n_gram, weights)
        self.n_gram = n_gram
        dtype = _accum_dtype()
        self._add_state("input_len", torch.tensor(0.0, dtype=dtype))
        self._add_state("target_len", torch.tensor(0.0, dtype=dtype))
        self._add_state("matches_by_order", torch.zeros(n_gram, dtype=dtype))
        self._add_state("possible_matches_by_order", torch.zeros(n_gram, dtype=dtype))

    def update(self, input: TBleuInput, target: TBleuTarget) -> "BLEUScore":
        input_len, target_len, matches, possible = _bleu_update(
            input, target, self.n_gram
        )
        self.input_len = self.input_len + input_len
        self.target_len = self.target_len + target_len
        self.matches_by_order = self.matches_by_order + torch.as_tensor(
            matches, device=self.device
        )
        self.possible_matches_by_order = (
            self.possible_matches_by_order
            + torch.as_tensor(possible, device=self.device)
        )
        return self

    def compute(self) -> torch.Tensor:
        """Corpus BLEU over everything seen so far."""
        return _bleu_compute(
            self.input_len,
            self.target_len,
            self.matches_by_order,
            self.possible_matches_by_order,
            self.weights.to(self.device),
        )

    def merge_state(self, metrics: Iterable["BLEUScore"]) -> "BLEUScore":
        merge_add(self, metrics, *_STATES)
        return self
