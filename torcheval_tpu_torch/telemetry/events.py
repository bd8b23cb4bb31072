"""The span hook every metric phase runs under (the port's slice of
``torcheval_tpu/telemetry/events.py``: ``ENABLED``, ``timed_phase`` and
``record_bucket_pad``).

Off (the default) a wrapped ``update``/``compute`` costs one module-flag
branch.  On (``TORCHEVAL_TPU_TORCH_TELEMETRY=1`` at import, or
``events.ENABLED = True``), each phase records one :class:`Span` with its
host-clock seconds and the metric's state bytes.  A phase on the GPU
returns when its work is queued, so a span times the enqueue unless the
phase itself waited for the device (``compute()`` usually does: the route
decision reads a few numbers back).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, List

import torch

from torcheval_tpu_torch import _flags

ENABLED: bool = _flags.get("TELEMETRY")

_CAPACITY = 4096

_lock = threading.Lock()
_spans: "deque[Span]" = deque(maxlen=_CAPACITY)
_pads: "deque[BucketPad]" = deque(maxlen=_CAPACITY)


@dataclass(frozen=True)
class Span:
    phase: str
    metric: str
    seconds: float
    state_bytes: int


@dataclass(frozen=True)
class BucketPad:
    """One batch padded up to its shape bucket (``metrics/_bucket.py``):
    the bucket, the real rows and the pad rows, so a report can price the
    padding a ragged stream pays."""

    bucket: int
    rows_valid: int
    rows_padded: int


def state_nbytes(metric: Any) -> int:
    """Total bytes of a metric's registered tensor states."""
    total = 0
    for name in getattr(metric, "_state_name_to_default", {}):
        value = getattr(metric, name, None)
        if isinstance(value, dict):
            leaves = list(value.values())
        elif isinstance(value, (list, tuple, deque)):
            leaves = list(value)
        else:
            leaves = [value]
        total += sum(
            leaf.numel() * leaf.element_size()
            for leaf in leaves
            if isinstance(leaf, torch.Tensor)
        )
    return total


def timed_phase(obj: Any, phase: str, fn, args, kwargs):
    """Run ``fn(obj, *args, **kwargs)`` as a recorded ``phase`` span.
    Only called from the hook wrappers after their ``ENABLED`` branch."""
    t0 = time.monotonic()
    out = fn(obj, *args, **kwargs)
    seconds = time.monotonic() - t0
    span = Span(phase, type(obj).__name__, seconds, state_nbytes(obj))
    with _lock:
        _spans.append(span)
    return out


def record_bucket_pad(bucket: int, rows_valid: int, rows_padded: int) -> None:
    """Record one :class:`BucketPad`.  Only called behind an ``ENABLED``
    branch."""
    with _lock:
        _pads.append(BucketPad(int(bucket), int(rows_valid), int(rows_padded)))


def bucket_pads() -> List[BucketPad]:
    """The recorded pads, oldest first (at most the last 4096)."""
    with _lock:
        return list(_pads)


def spans() -> List[Span]:
    """The recorded spans, oldest first (at most the last 4096)."""
    with _lock:
        return list(_spans)


def clear() -> None:
    with _lock:
        _spans.clear()
        _pads.clear()
