"""Hot-path instrumentation: a process-wide capture counter (the port of
``torcheval_tpu/_stats.py``).

In the JAX package a "trace" is one build of a jitted update program.
PyTorch runs eagerly, so the port's counterpart of a compiled program is
a captured CUDA graph: the engine (``engine/scan.py``) bumps a counter
once a capture, from the Python body that runs only while capturing, and
never on a replay.  On the CPU, where nothing is captured, the engine
bumps it where a capture would have been: once a block signature.
``aot.warmup`` uses the delta to check its contract: after a warmup, the
stream adds zero captures.

Beside it, the read-back counter: :func:`readback` counts each read of
device values to the host by the site the caller names, always on, and
makes the read, inside the profiler range ``readback.<site>`` with the
telemetry ranges on (``telemetry.events.annotate``).  It costs one
increment at a site that is about to wait for the device anyway, with no
lock: the contract of ``ops._build.LAUNCHES``, exact in one thread, where
threads that read back at one site at once may lose an increment.

The member-update counter, in the same style: :func:`count_member_updates`
counts the member updates of ``MetricCollection.update`` by how their
device work ran: ``"replay"`` (one replay of the collection's captured
graph, ``metrics/_graphs.py``), ``"capture"`` (the call that captured it)
or ``"eager"`` (the member's own update, slice clones included).

The stacked-check counter, in the same style: :func:`count_stacked_checks`
counts each flush of a collection's queued value checks
(``metrics/functional/_host_checks.py::CheckQueue``): ``"requests"``,
the checks it answered, and ``"reads"``, its read backs (one a flush).

The capture counter's mutation is lock-guarded (captures may run in
several threads), and ``bump_trace`` is also the ``retrace`` hook of the telemetry bus: one
branch on the bus's module flag, taken only at capture time.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional

from torcheval_tpu_torch.telemetry import events as _telemetry

_trace_counts: Dict[str, int] = {}
_readback_counts: Dict[str, int] = {}
_member_update_counts: Dict[str, int] = {}
_stacked_check_counts: Dict[str, int] = {}
_lock = threading.Lock()


def bump_trace(kind: str) -> None:
    """Record one capture of the ``kind`` program (``"mega_scan"``,
    ``"engine_scan"``, or ``"collection_update"`` for
    ``MetricCollection.update``'s graphs)."""
    with _lock:
        _trace_counts[kind] = _trace_counts.get(kind, 0) + 1
    if _telemetry.ENABLED:
        _telemetry.record_retrace(kind)


def trace_count(kind: Optional[str] = None) -> int:
    """Captures recorded since process start (or the last reset): one
    ``kind`` or the total across all kinds."""
    with _lock:
        if kind is not None:
            return _trace_counts.get(kind, 0)
        return sum(_trace_counts.values())


def trace_counts() -> Dict[str, int]:
    """Per-kind snapshot (copy; safe to hold)."""
    with _lock:
        return dict(_trace_counts)


def reset_trace_count() -> None:
    """Zero every counter (test/benchmark hook).  Drops no captured graph:
    a signature already captured still replays without a capture."""
    with _lock:
        _trace_counts.clear()


def readback(site: str, read: Callable[..., Any], *args: Any) -> Any:
    """Count one read of device values to the host at ``site`` (a short
    literal the caller passes) and return ``read(*args)``, the read
    itself: ``_stats.readback("binary_route", stats.tolist)``."""
    _readback_counts[site] = _readback_counts.get(site, 0) + 1
    if _telemetry.ANNOTATE:
        with _telemetry.span("readback." + site):
            return read(*args)
    return read(*args)


def readback_counts() -> Dict[str, int]:
    """Read backs by site since process start (or the last reset); a copy."""
    return dict(_readback_counts)


def reset_readback_counts() -> None:
    """Zero the read-back counter (test/benchmark hook)."""
    _readback_counts.clear()


def count_member_updates(how: str, n: int) -> None:
    """Count ``n`` member updates of one ``MetricCollection.update`` whose
    device work ran ``how``: ``"replay"``, ``"capture"`` or ``"eager"``."""
    _member_update_counts[how] = _member_update_counts.get(how, 0) + n


def member_update_counts() -> Dict[str, int]:
    """Member updates by how their device work ran, since process start (or
    the last reset); a copy."""
    return dict(_member_update_counts)


def reset_member_update_counts() -> None:
    """Zero the member-update counter (test/benchmark hook)."""
    _member_update_counts.clear()


def count_stacked_checks(requests: int) -> None:
    """Count one read back of a collection's queued value checks that
    answered ``requests`` of them."""
    _stacked_check_counts["requests"] = _stacked_check_counts.get("requests", 0) + requests
    _stacked_check_counts["reads"] = _stacked_check_counts.get("reads", 0) + 1


def stacked_check_counts() -> Dict[str, int]:
    """The queued value checks answered (``"requests"``) and the read backs
    that answered them (``"reads"``), since process start (or the last
    reset); a copy."""
    return dict(_stacked_check_counts)


def reset_stacked_check_counts() -> None:
    """Zero the stacked-check counter (test/benchmark hook)."""
    _stacked_check_counts.clear()
