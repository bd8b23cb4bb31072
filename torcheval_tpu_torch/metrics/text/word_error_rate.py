"""Word error rate / word information class metrics (the port of
``torcheval_tpu/metrics/text/word_error_rate.py``): scalar counter states
fed by the native host edit distance (string inputs) or by
``ops/wavefront.py`` (tokenized inputs; the CUDA kernel when the states
live on the GPU)."""

from typing import Iterable

import torch

from torcheval_tpu_torch.metrics._fuse import accumulate, on_device
from torcheval_tpu_torch.metrics._merge import merge_add
from torcheval_tpu_torch.metrics.functional.classification.binary_normalized_entropy import (
    _accum_dtype,
)
from torcheval_tpu_torch.metrics.functional.text.word_error_rate import (
    _is_tokens,
    _wip_compute,
    _word_stats_device_kernel,
    _word_stats_tokens_check,
    _word_stats_update,
)
from torcheval_tpu_torch.metrics.metric import Metric

_STATES = ("errors", "target_total", "input_total")


class _WordStatsMetric(Metric[torch.Tensor]):
    """Shared state machine: the three word-alignment counters.

    ``update`` is polymorphic over the input flavour:

    * strings → the host path (interning and the native C++ DP, three
      scalar folds);
    * ``(n, len)`` int token ids (``metrics/text/_tokens.tokenize_pairs``
      pads, negative and trailing) → one edit-distance launch on the
      metric's device and three integer sums;
    * ``(n, seq, vocab)`` float logits + id targets → greedy-argmax token
      error rate, the same launch: the ``(logits, ids)`` signature that
      ``Perplexity`` takes too, so both ride one ``MetricCollection``.
    """

    # The tokenized path accepts update(..., mask=) for bucketed ragged
    # batches (_bucket.py); string batches are never padded.
    _supports_mask = True

    def __init__(self, *, device=None) -> None:
        super().__init__(device=device)
        for name in _STATES:
            self._add_state(name, torch.tensor(0.0, dtype=_accum_dtype()))

    def update(self, input, target, *, mask=None):
        if not _is_tokens(input):
            if mask is not None:
                raise ValueError(
                    "mask= requires tokenized array inputs; string "
                    "batches are never padded."
                )
            errors, target_total, input_total = _word_stats_update(
                input, target
            )
            self.errors = self.errors + errors
            self.target_total = self.target_total + target_total
            self.input_total = self.input_total + input_total
            return self
        input, target, mask = on_device(self.device, input, target, mask)
        _word_stats_tokens_check(input, target)
        self.errors, self.target_total, self.input_total = accumulate(
            _word_stats_device_kernel,
            (self.errors, self.target_total, self.input_total),
            input,
            target,
            mask=mask,
        )
        return self

    def merge_state(self, metrics: Iterable["_WordStatsMetric"]):
        merge_add(self, metrics, *_STATES)
        return self


class WordErrorRate(_WordStatsMetric):
    """WER = edit errors / reference words; NaN before any update (0/0)."""

    def compute(self) -> torch.Tensor:
        return self.errors / self.target_total


class WordInformationPreserved(_WordStatsMetric):
    """WIP over all pairs seen; NaN before any update (0/0)."""

    def compute(self) -> torch.Tensor:
        return _wip_compute(self.errors, self.target_total, self.input_total)


class WordInformationLost(_WordStatsMetric):
    """WIL = 1 − WIP; NaN before any update (0/0)."""

    def compute(self) -> torch.Tensor:
        return 1.0 - _wip_compute(
            self.errors, self.target_total, self.input_total
        )
