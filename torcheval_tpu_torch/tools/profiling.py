"""Runtime tracing and kernel timing (the port of
``torcheval_tpu/tools/profiling.py``).

The tracing half is a thin entry point over ``torch.profiler``, so an
evaluation loop does not import the profiler itself: :func:`trace`
records the CPU and (on a GPU host) the CUDA activity of a block and
writes a Chrome trace, :func:`annotate` and :func:`step_marker` label
spans in it (``torch.profiler.record_function``).

The timing half, :func:`device_seconds`, clocks a kernel without the
launch overhead of one call: it runs ``K`` calls between two CUDA events
and differences against one call, growing ``K`` until the loop dominates.
On the CPU the same loop runs under ``time.perf_counter``.

:class:`ProfiledMetric` wraps a metric and clocks each lifecycle phase;
:func:`profile_summary_table` renders the clocks.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import os
import pickle
import time
from typing import Any, Callable, Dict, Iterable, Iterator, Optional, Sequence

import torch

from torcheval_tpu_torch.telemetry import events as _telemetry


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[Any]:
    """Record the enclosed block with ``torch.profiler`` (CPU activity,
    and CUDA activity when a GPU is present) and write it as a Chrome
    trace into ``log_dir`` (``trace_<pid>_<ns>.json``, viewable in
    Perfetto).  Yields the profiler, for ``key_averages()``.

    The JAX ``create_perfetto_link`` option has no counterpart: the file
    opens in Perfetto as it is."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    )


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Label the enclosed host span in a profiler trace
    (``torch.profiler.record_function``), so a metric's phases are
    attributable in the timeline beside the kernels they launch."""
    with torch.profiler.record_function(name):
        yield


def step_marker(name: str, step: int):
    """Mark one evaluation step in a profiler trace; use as a context
    manager: ``with step_marker("eval", i): ...`` (the span is named
    ``"<name>#<step>"``)."""
    return torch.profiler.record_function(f"{name}#{int(step)}")


def device_memory_profile(device: Optional[Any] = None) -> bytes:
    """The CUDA caching allocator's snapshot (segments, blocks and their
    allocation traces, ``torch.cuda.memory._snapshot``) of ``device``,
    pickled to bytes: the allocator-level view of metric buffer
    residency.  Raises ``RuntimeError`` without a GPU."""
    if not torch.cuda.is_available():
        raise RuntimeError("device_memory_profile reads the CUDA caching allocator; no GPU.")
    return pickle.dumps(torch.cuda.memory._snapshot(device))


def device_seconds(
    step_kernel: Callable[..., Any],
    args: Sequence,
    *,
    iters: int = 8,
    reps: int = 3,
    max_iters: int = 16384,
) -> float:
    """Device seconds per call of ``step_kernel(*args, i)``.

    ``step_kernel`` takes the loop index ``i`` as its last argument (the
    JAX package folds it into the computation so that XLA cannot hoist the
    body; here it is only passed on).  ``K`` calls run between two CUDA
    events on the current stream (``time.perf_counter`` around a loop for
    CPU tensors), best of ``reps``, differenced against one call, so a
    call's launch overhead cancels as long as the launches keep ahead of
    the device; ``K`` grows eightfold until the ``K`` loop takes three
    times the single call or reaches ``max_iters``."""
    on_card = any(
        isinstance(a, torch.Tensor) and a.device.type == "cuda" for a in args
    )

    def loop(k: int) -> float:
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for i in range(k):
                step_kernel(*args, i)
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
        t0 = time.perf_counter()
        for i in range(k):
            step_kernel(*args, i)
        return time.perf_counter() - t0

    def best_of(k: int) -> float:
        return min(loop(k) for _ in range(reps))

    loop(1)  # first call: builds and loads what it launches
    t1 = best_of(1)
    while True:
        tk = best_of(iters)
        if tk >= 3.0 * t1 or iters >= max_iters:
            break
        iters *= 8
    return max((tk - t1) / (iters - 1), 1e-9)


# --------------------------------------------------------------------------
# Per-metric lifecycle instrumentation
# --------------------------------------------------------------------------

_PHASES = ("update", "compute", "merge_state", "reset")


@dataclasses.dataclass
class PhaseStats:
    """Aggregate clock for one lifecycle phase of one metric."""

    calls: int = 0
    seconds: float = 0.0

    @property
    def mean_ms(self) -> float:
        return 1e3 * self.seconds / self.calls if self.calls else 0.0


def _state_leaves(value: Any) -> list:
    """Tensor leaves of one metric state: a tensor, or a list, tuple,
    deque or dict of them (nested)."""
    if isinstance(value, torch.Tensor):
        return [value]
    if isinstance(value, dict):
        return [x for v in value.values() for x in _state_leaves(v)]
    if isinstance(value, (list, tuple, collections.deque)):
        return [x for v in value for x in _state_leaves(v)]
    return []


def _leaf_bytes(value: Any) -> int:
    return sum(t.numel() * t.element_size() for t in _state_leaves(value))


class ProfiledMetric:
    """Transparent instrumentation shell around a ``Metric``: counts and
    wall-clocks every lifecycle call and accounts the state memory.

    Wrap the metrics you feed, run the loop unchanged (every attribute
    that is not a lifecycle method goes to the wrapped metric, and
    ``update`` returns the wrapper so chaining works), then render
    :func:`profile_summary_table`.

    By default each phase's clock covers the host: Python and the kernel
    launches, which return before the card has finished; that is what an
    evaluation loop blocks on.  ``sync=True`` also waits for the card
    (``torch.cuda.synchronize`` of the states' device) inside the clocked
    span, at the cost of serializing the loop; :func:`device_seconds`
    gives a kernel's device time.

    Each phase runs under :func:`annotate`, so its span shows in a
    :func:`trace` timeline.
    """

    _OWN_ATTRS = frozenset({"_metric", "_name", "_sync", "_stats"})

    def __init__(self, metric, *, name: Optional[str] = None, sync: bool = False):
        self._metric = metric
        self._name = name or type(metric).__name__
        self._sync = sync
        self._stats: Dict[str, PhaseStats] = {p: PhaseStats() for p in _PHASES}

    # ------------------------------------------------------------ lifecycle
    def _clock(self, phase: str, fn: Callable, *args: Any, **kwargs: Any) -> Any:
        stats = self._stats[phase]
        with annotate(f"{self._name}.{phase}"):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if self._sync:
                device = getattr(self._metric, "device", None)
                if device is not None and torch.device(device).type == "cuda":
                    torch.cuda.synchronize(device)
            elapsed = time.perf_counter() - t0
            stats.seconds += elapsed
        stats.calls += 1
        if _telemetry.ENABLED and phase in ("merge_state", "reset"):
            # The two phases the Metric-level telemetry wrapper does not
            # cover; update / compute spans come from the inner metric, so
            # emitting them here would count them twice.
            _telemetry.record_span(phase, self._name, elapsed, self.state_bytes())
        return out

    def update(self, *args: Any, **kwargs: Any) -> "ProfiledMetric":
        self._clock("update", self._metric.update, *args, **kwargs)
        return self

    def compute(self) -> Any:
        return self._clock("compute", self._metric.compute)

    def merge_state(self, metrics: Iterable[Any]) -> "ProfiledMetric":
        unwrapped = [m._metric if isinstance(m, ProfiledMetric) else m for m in metrics]
        self._clock("merge_state", self._metric.merge_state, unwrapped)
        return self

    def reset(self) -> "ProfiledMetric":
        self._clock("reset", self._metric.reset)
        return self

    def to(self, device, *args: Any, **kwargs: Any) -> "ProfiledMetric":
        # Not a clocked phase, but it must return the wrapper: the inner
        # Metric.to returns the inner metric.
        self._metric.to(device, *args, **kwargs)
        return self

    def load_state_dict(self, *args: Any, **kwargs: Any) -> None:
        self._metric.load_state_dict(*args, **kwargs)

    # ------------------------------------------------------------- reporting
    @property
    def metric(self):
        """The wrapped metric (e.g. for toolkit sync, which needs the real
        object on every rank)."""
        return self._metric

    @property
    def stats(self) -> Dict[str, PhaseStats]:
        return self._stats

    def state_bytes(self) -> int:
        """Bytes held by the metric's registered states (list, dict and
        deque containers counted leaf by leaf)."""
        return sum(
            _leaf_bytes(getattr(self._metric, name, None))
            for name in self._metric._state_name_to_default
        )

    def report(self) -> Dict[str, Any]:
        """Plain-dict snapshot: per-phase calls / total seconds / mean ms,
        plus the current state memory."""
        row: Dict[str, Any] = {"name": self._name, "state_bytes": self.state_bytes()}
        for phase, stats in self._stats.items():
            row[phase] = {
                "calls": stats.calls,
                "seconds": round(stats.seconds, 6),
                "mean_ms": round(stats.mean_ms, 4),
            }
        return row

    def __getattr__(self, attr: str) -> Any:
        # Only attributes that are not lifecycle methods reach here.  While
        # unpickling or deep-copying, the instance exists before __init__
        # ran: guard via __dict__, or the _metric lookup would recurse.
        if "_metric" not in self.__dict__:
            raise AttributeError(attr)
        return getattr(self._metric, attr)

    def __setattr__(self, attr: str, value: Any) -> None:
        # A transparent proxy: writes to anything but its own four fields
        # land on the wrapped metric, so state installs (e.g. after a
        # collection's fused_update) reach the real states.
        if attr in self._OWN_ATTRS or "_metric" not in self.__dict__:
            object.__setattr__(self, attr, value)
        else:
            setattr(self._metric, attr, value)

    def __repr__(self) -> str:
        return f"ProfiledMetric({self._metric!r}, name={self._name!r})"


# A virtual subclass: isinstance(pm, Metric) holds (MetricCollection and
# the toolkit check it) without inheriting the base's state registry;
# every Metric API reaches the wrapped instance by delegation.
def _register_as_metric() -> None:
    from torcheval_tpu_torch.metrics.metric import Metric

    Metric.register(ProfiledMetric)


_register_as_metric()


def profile_summary_table(profiled: Sequence[ProfiledMetric]) -> str:
    """Text cost table over profiled metrics: one row a metric, one column
    block a lifecycle phase."""
    headers = ["Metric", "State bytes"]
    for phase in _PHASES:
        headers += [f"{phase} calls", f"{phase} ms/call"]
    rows = []
    for pm in profiled:
        row = [pm._name, f"{pm.state_bytes():,}"]
        for phase in _PHASES:
            st = pm.stats[phase]
            row += [str(st.calls), f"{st.mean_ms:.3f}"]
        rows.append(row)
    widths = [
        max(len(headers[i]), *(len(r[i]) for r in rows)) if rows else len(headers[i])
        for i in range(len(headers))
    ]
    line = " | ".join(h.ljust(w) for h, w in zip(headers, widths))
    sep = "-+-".join("-" * w for w in widths)
    body = [" | ".join(c.ljust(w) for c, w in zip(r, widths)) for r in rows]
    return "\n".join([line, sep] + body)
