"""Live model-quality monitor (the port of ``torcheval_tpu/monitor``):
decayed and windowed metric variants, a quantile digest, and the
streaming quality exporter.

* :class:`Decayed`: exponential time decay folded into a metric's
  counter / binned states inside its own update.
* :class:`SlidingWindow`: a tumbling / sliding bucket-of-epochs window over
  the same states; ``advance()`` rotates epochs between updates.
* :class:`StreamDigest`: a fixed-size mergeable quantile digest (the dyadic
  ladder of ``ops/rank_sketch.py``) for latency / score / loss
  distributions.
* :func:`~torcheval_tpu_torch.monitor.quality.publish`: streams every
  figure of a collection, global and per slice, into the telemetry ring.

All of them join collections (``bucket=``, ``slices=``) and the engine's
CUDA graphs.
"""

from torcheval_tpu_torch.monitor.decay import Decayed
from torcheval_tpu_torch.monitor.digest import StreamDigest
from torcheval_tpu_torch.monitor.quality import publish, window_kind
from torcheval_tpu_torch.monitor.window import SlidingWindow

__all__ = ["Decayed", "SlidingWindow", "StreamDigest", "publish", "window_kind"]
