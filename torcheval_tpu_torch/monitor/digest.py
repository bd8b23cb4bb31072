"""Streaming distribution digest of the monitor family (the port of
``torcheval_tpu/monitor/digest.py``).

:class:`StreamDigest` tracks a latency / score / loss distribution in a
fixed-size mergeable state: the dyadic ladder of
:mod:`torcheval_tpu_torch.ops.rank_sketch` (``levels`` levels of ``bins``
sub-bins, each level's bin width doubling; 32 x 64 int32 counters span
nine decades at <= 1/64 relative value error).  One accumulate a batch,
an integer-add merge (the same counts in every merge order), and
deterministic quantile reads (a quantile is its bin's left edge, so every
merge order reports the same p50 / p90 / p99).  It folds ``mask=``, so it
joins ``bucket=`` / ``slices=`` collections, and its update is plain
torch with no read back, so it runs inside the engine's CUDA graphs.
"""

from typing import Iterable, Tuple

import torch

from torcheval_tpu_torch.metrics._fuse import accumulate, on_device
from torcheval_tpu_torch.metrics._merge import merge_add
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.ops.rank_sketch import (
    ladder_counts,
    ladder_edges,
    ladder_fill,
    ladder_quantiles,
)

__all__ = ["StreamDigest"]


def _digest_kernel(values, edges, mask=None):
    return ladder_counts(values, edges, mask=mask)


class StreamDigest(Metric[torch.Tensor]):
    """Mergeable quantile digest over a non-negative value stream.

    ``base`` is the resolution floor (values below it land in level 0's
    uniform bins, absolute error <= ``base/bins``); above it the relative
    error is <= ``1/bins``.  ``compute()`` returns the configured
    ``quantiles`` (default p50 / p90 / p99) as one tensor, or an empty
    tensor before any update."""

    _supports_mask = True
    _fixed_states = ("edges",)

    def __init__(
        self,
        *,
        base: float = 1e-4,
        levels: int = 32,
        bins: int = 64,
        quantiles: Tuple[float, ...] = (0.5, 0.9, 0.99),
        device=None,
    ) -> None:
        super().__init__(device=device)
        self.base = float(base)
        self.levels = int(levels)
        self.bins = int(bins)
        self.quantiles = tuple(float(q) for q in quantiles)
        for q in self.quantiles:
            if not 0.0 < q <= 1.0:
                raise ValueError(f"quantiles must lie in (0, 1], got {q}")
        self._add_state("edges", ladder_edges(self.base, self.levels, self.bins))
        self._add_state("counts", torch.zeros(self.levels * self.bins, dtype=torch.int32))

    def update(self, values, *, mask=None) -> "StreamDigest":
        values, mask = on_device(self.device, values, mask)
        (self.counts,) = accumulate(_digest_kernel, (self.counts,), values, self.edges, mask=mask)
        return self

    def compute(self) -> torch.Tensor:
        """The configured quantile values; an empty tensor before any
        update."""
        if int(self.counts.sum()) == 0:
            return torch.zeros(0, device=self.device)
        return ladder_quantiles(self.counts, self.edges, self.quantiles)

    def quantile(self, q: float) -> torch.Tensor:
        """One quantile read (its bin's left edge)."""
        return ladder_quantiles(self.counts, self.edges, (float(q),))[0]

    def fill(self) -> torch.Tensor:
        """Per-level fill counters: how much mass each level of the ladder
        holds (to choose ``base`` / ``levels``)."""
        return ladder_fill(self.counts, self.levels)

    def merge_state(self, metrics: Iterable["StreamDigest"]) -> "StreamDigest":
        metrics = list(metrics)
        for m in metrics:
            if (m.base, m.levels, m.bins) != (self.base, self.levels, self.bins):
                raise ValueError(
                    "digest merge requires identical ladder geometry: "
                    f"(base={m.base}, levels={m.levels}, bins={m.bins}) vs "
                    f"(base={self.base}, levels={self.levels}, bins={self.bins})"
                )
        merge_add(self, metrics, "counts")
        return self
