"""Double-buffered host-to-device prefetch for the streaming engine (the
port of ``torcheval_tpu/engine/prefetch.py``).

While the card replays block *k*, a background thread assembles and
stages block *k+1*, so the host's pad-and-stack work and the copy to the
card overlap the replay instead of following it.  The queue is bounded
(default depth 2, double buffering): the producer blocks once it is
``depth`` items ahead, so a fast source cannot balloon host or device
memory.  The engine's own staging (``Evaluator._stage_block``) assembles
blocks in pinned host memory reused as a ring and copies them on a copy
stream; the default ``stage`` here moves an item's arrays to ``device``.

Error contract: an exception from the source iterator (or from staging)
is captured in the producer thread and raised at the consumer's next
``__next__``, where a plain ``for batch in source`` loop would have seen
it, and everything already dispatched stays applied.
:meth:`Prefetcher.close` stops the producer from any state (mid-put
included) and joins the thread.
"""

import queue
import threading
import time
import warnings
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from torcheval_tpu_torch.metrics.metric import canonicalize_device
from torcheval_tpu_torch.resilience import faults as _faults
from torcheval_tpu_torch.telemetry import events as _telemetry
from torcheval_tpu_torch.telemetry import trace as _trace

DEFAULT_DEPTH = 2

# Producer-side poll period for stop-aware blocking puts: close() is
# observed within one tick even if the consumer never drains the queue.
_PUT_TICK_S = 0.05

# close() join budget.  A producer still alive past it is a leak,
# reported by a warning and a `degraded` telemetry event, never silent.
_JOIN_TIMEOUT_S = 5.0

# Staging gets one bounded retry for transient transfer failures; the
# stop flag is checked before every attempt so close() never waits out a
# retry loop on a dead device.
_STAGE_ATTEMPTS = 2
_STAGE_RETRY_DELAY_S = 0.02


class _Stopped(Exception):
    """Internal: the producer observed close() mid-item; exit quietly."""


class _SourceError:
    """Queue envelope carrying an exception out of the producer thread."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


_DONE = object()


def _to_device(item: Any, device: torch.device) -> Any:
    """``item`` with every array (tensor or numpy) on ``device``, its
    tuple/list/dict structure kept."""
    if isinstance(item, (torch.Tensor, np.ndarray)):
        return torch.as_tensor(item, device=device)
    if isinstance(item, (tuple, list)):
        return type(item)(_to_device(v, device) for v in item)
    if isinstance(item, dict):
        return {k: _to_device(v, device) for k, v in item.items()}
    return item


class Prefetcher:
    """Iterate ``source`` on a background thread, staging each item ahead
    of the consumer.

    ``stage`` maps a host item to its staged form; the default puts the
    item's arrays on ``device`` (``None``: the GPU, as a metric built
    without ``device=``; raises without one).  Yields items in source
    order.  Use as an iterator, ideally under ``try/finally: close()``
    (iterating to exhaustion also joins the thread).
    """

    def __init__(
        self,
        source: Iterable[Any],
        *,
        stage: Optional[Callable[[Any], Any]] = None,
        device: Any = None,
        depth: int = DEFAULT_DEPTH,
    ) -> None:
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        if stage is None:
            target = canonicalize_device(device)

            def stage(item: Any) -> Any:
                return _to_device(item, target)

        self._source = iter(source)
        self._stage = stage
        self._queue: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._finished = False
        # contextvars do not flow into Thread targets: hand the caller's
        # trace context across explicitly so the producer's fault/stall
        # events link under the consuming run's span.
        self._trace_ctx = _trace.capture() if _trace.ENABLED else None
        self._thread = threading.Thread(
            target=self._produce, name="torcheval-tpu-torch-prefetch", daemon=True
        )
        self._thread.start()

    # ------------------------------------------------------------- producer
    def _put(self, item: Any) -> bool:
        """Stop-aware blocking put; False means close() won the race."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=_PUT_TICK_S)
                return True
            except queue.Full:
                continue
        return False

    def _stage_with_retry(self, item: Any) -> Any:
        for attempt in range(1, _STAGE_ATTEMPTS + 1):
            if self._stop.is_set():
                raise _Stopped()
            try:
                return self._stage(item)
            except Exception:  # noqa: BLE001 - bounded retry, then relay
                if attempt >= _STAGE_ATTEMPTS or self._stop.is_set():
                    raise
                time.sleep(_STAGE_RETRY_DELAY_S)
        raise AssertionError("unreachable")  # pragma: no cover

    def _produce(self) -> None:
        if _trace.ENABLED:
            _trace.adopt(self._trace_ctx)
        produced = 0
        try:
            for item in self._source:
                if self._stop.is_set():
                    return
                staged = self._stage_with_retry(item)
                produced += 1
                if _faults.ENABLED:
                    _faults.fire("prefetch.produce", items=produced)
                if not self._put(staged):
                    return
            self._put(_DONE)
        except _Stopped:
            return
        except BaseException as exc:  # noqa: BLE001 - relayed to consumer
            self._put(_SourceError(exc))

    # ------------------------------------------------------------- consumer
    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        if self._finished:
            raise StopIteration
        if _telemetry.ENABLED:
            t0 = time.monotonic()
            stalled = False
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                # The pipeline bubbled: the producer is behind the
                # consumer.  Time the wait so report() can show it.
                stalled = True
                item = self._queue.get()
            waited = time.monotonic() - t0
            _telemetry.record_span("prefetch_wait", "Evaluator", waited, 0)
            if stalled:
                _telemetry.record_prefetch_stall(waited)
        else:
            item = self._queue.get()
        if item is _DONE:
            self._finished = True
            # Bounded: a close()-injected _DONE can arrive while the
            # producer is still wedged; never trade a get() hang for a
            # join() hang.
            self._thread.join(timeout=_JOIN_TIMEOUT_S)
            raise StopIteration
        if isinstance(item, _SourceError):
            self._finished = True
            self._thread.join()
            raise item.exc
        return item

    def close(self) -> None:
        """Stop the producer and join its thread.  Idempotent; safe from
        any consumer state (mid-stream, exhausted, errored)."""
        self._finished = True
        self._stop.set()
        # Drain so a producer blocked in put() observes the stop flag on
        # its next tick rather than waiting out a full queue.
        self._drain()
        self._thread.join(timeout=_JOIN_TIMEOUT_S)
        if not self._thread.is_alive():
            # The producer may have completed one last put() between the
            # drain and observing the stop flag: drain again so no staged
            # buffer stays held by the dead queue.
            self._drain()
        try:
            # Wake a consumer blocked in get() (close() raced __next__
            # from another thread): _DONE turns its wait into a clean
            # StopIteration instead of a hang.
            self._queue.put_nowait(_DONE)
        except queue.Full:  # pragma: no cover - the staged item wakes it
            pass
        if self._thread.is_alive():
            # The producer is wedged (a transfer that never returns).  The
            # thread is a daemon so the process can still exit, but a
            # silent leak would mask the wedge: report it.
            if _telemetry.ENABLED:
                _telemetry.record_degraded(
                    "prefetch.close",
                    f"producer thread still alive after {_JOIN_TIMEOUT_S:g}s join",
                    "leaked_thread",
                )
            warnings.warn(
                "Prefetcher.close(): producer thread did not exit within "
                f"{_JOIN_TIMEOUT_S:g}s and was leaked (daemon). A device "
                "transfer or the batch source is likely wedged.",
                RuntimeWarning,
                stacklevel=2,
            )

    def _drain(self) -> None:
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                return
