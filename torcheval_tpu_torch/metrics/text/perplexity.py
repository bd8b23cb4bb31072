"""Perplexity class metric (the port of
``torcheval_tpu/metrics/text/perplexity.py``): two scalar counters (summed
NLL and token count) that merge by addition."""

from typing import Iterable, Optional

import torch

from torcheval_tpu_torch.metrics._fuse import accumulate, on_device
from torcheval_tpu_torch.metrics._merge import merge_add
from torcheval_tpu_torch.metrics.functional.classification.binary_normalized_entropy import (
    _accum_dtype,
)
from torcheval_tpu_torch.metrics.functional.text.perplexity import (
    _perplexity_compute,
    _perplexity_input_check,
    _perplexity_update_kernel,
)
from torcheval_tpu_torch.metrics.metric import Metric


class Perplexity(Metric[torch.Tensor]):
    """``exp(mean NLL)`` over all tokens seen, excluding ``ignore_index``."""

    # Accepts update(..., mask=) for bucketed ragged batches (_bucket.py):
    # a zero mask row zeroes every token of that sequence.
    _supports_mask = True

    def __init__(self, *, ignore_index: Optional[int] = None, device=None) -> None:
        super().__init__(device=device)
        self.ignore_index = ignore_index
        # float32 counters, as in the JAX package: a token count past 2^24
        # stops advancing.
        dtype = _accum_dtype()
        self._add_state("sum_log_probs", torch.tensor(0.0, dtype=dtype))
        self._add_state("num_total", torch.tensor(0.0, dtype=dtype))

    def update(self, input, target, *, mask=None) -> "Perplexity":
        input, target, mask = on_device(self.device, input, target, mask)
        _perplexity_input_check(input, target)
        self.sum_log_probs, self.num_total = accumulate(
            _perplexity_update_kernel,
            (self.sum_log_probs, self.num_total),
            input,
            target,
            statics=(self.ignore_index,),
            mask=mask,
        )
        return self

    def compute(self) -> torch.Tensor:
        """Perplexity; NaN before any update (exp(0/0))."""
        return _perplexity_compute(self.sum_log_probs, self.num_total)

    def merge_state(self, metrics: Iterable["Perplexity"]) -> "Perplexity":
        merge_add(self, metrics, "sum_log_probs", "num_total")
        return self
