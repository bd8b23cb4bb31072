"""Streaming quality exporter: collection figures -> telemetry events (the
port of ``torcheval_tpu/monitor/quality.py``).

:func:`publish` turns one reading of a :class:`MetricCollection`, global
figures plus every slice of a sliced collection, into
:class:`~torcheval_tpu_torch.telemetry.events.QualityEvent`s on the
telemetry ring, labelled with the member name, the slice label ("" for
the global figure) and the window kind.  Callers gate on
``telemetry.events.ENABLED`` (the engine's snapshot hook does);
``publish`` itself assumes the bus is on.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from torcheval_tpu_torch.metrics.collection import MetricCollection
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.monitor.decay import Decayed
from torcheval_tpu_torch.monitor.window import SlidingWindow
from torcheval_tpu_torch.telemetry import events as _telemetry

__all__ = ["publish", "window_kind"]


def window_kind(metric: Metric) -> str:
    """The ``window`` label a member's readings carry: ``"decayed"`` for
    :class:`~torcheval_tpu_torch.monitor.Decayed`, ``"window"`` for
    :class:`~torcheval_tpu_torch.monitor.SlidingWindow`, else
    ``"lifetime"``."""
    if isinstance(metric, Decayed):
        return "decayed"
    if isinstance(metric, SlidingWindow):
        return "window"
    return "lifetime"


def _as_scalar(value: Any) -> Optional[float]:
    """A float for a size-1 result; ``None`` for anything an event cannot
    carry (confusion matrices, per-class vectors, tuples)."""
    if isinstance(value, tuple):
        return None
    if isinstance(value, torch.Tensor):
        return float(value.reshape(())) if value.numel() == 1 else None
    if isinstance(value, (int, float)):
        return float(value)
    return None


def publish(
    collection: MetricCollection,
    *,
    step: int = 0,
    values: Optional[Dict[str, Any]] = None,
) -> int:
    """Emit one :class:`QualityEvent` per scalar figure the collection
    holds: each member globally, and per slice for a sliced collection.
    ``values`` skips the global ``compute()`` when the caller has it (the
    engine's snapshot path); ``step`` is the publisher's cursor (engine
    blocks dispatched).  Returns the number of events emitted."""
    emitted = 0
    if values is None:
        values = collection.compute()
    scalar_names = []
    for name, value in values.items():
        scalar = _as_scalar(value)
        if scalar is None:
            continue
        scalar_names.append(name)
        _telemetry.record_quality(name, "", window_kind(collection[name]), scalar, step)
        emitted += 1
    if collection.slices is not None and scalar_names:
        # Only the members whose global figure was scalar: a member that
        # publishes nothing would have its K slice computes thrown away.
        for k, label in enumerate(collection.slice_labels):
            for name in scalar_names:
                scalar = _as_scalar(collection._slice_members[f"{name}@{k}"].compute())
                if scalar is None:
                    continue
                _telemetry.record_quality(
                    name, label, window_kind(collection[name]), scalar, step
                )
                emitted += 1
    return emitted
