"""Live model-quality monitor (the port's slice of ``torcheval_tpu/monitor``):
the streaming quality exporter only.

:func:`~torcheval_tpu_torch.monitor.quality.publish` streams a
collection's figures, global and per slice, into the telemetry ring as
``QualityEvent``s; the engine's snapshot path calls it when the bus is on.
``Decayed``, ``SlidingWindow`` and ``StreamDigest`` come with the sketch
tier (ROADMAP queue 1 item 7).
"""

from torcheval_tpu_torch.monitor.quality import publish, window_kind

__all__ = ["publish", "window_kind"]
