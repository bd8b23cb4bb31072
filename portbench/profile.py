"""The traced run: ``torch.profiler`` over a few units, read from its
Chrome trace into a :class:`Trace` that the per-layer readers take.

The harness wraps its own calls into the library in ``portbench.*``
ranges (``record_function``); the whole traced stretch is
``portbench.window``.  Device operations are kernels, copies and fills;
each is tied to the runtime call that launched it by the trace's
correlation id.
"""

from __future__ import annotations

import json
import os
import tempfile
from bisect import bisect_right
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
# Runtime calls that make the host wait for the device.
BLOCKING = (
    "cudaStreamSynchronize",
    "cudaDeviceSynchronize",
    "cudaEventSynchronize",
    "cudaMemcpy",
    "cudaMemcpy2D",
)


@dataclass
class Event:
    name: str
    start: float  # microseconds, the profiler's clock
    end: float
    tid: Any = None
    correlation: Optional[int] = None


@dataclass
class Trace:
    """One traced stretch of a run, and what the harness counted over it.

    ``update_s`` and ``result_s`` are host times of the run's measured
    window (the untraced one), so a reader of host latency reads them
    without the profiler's cost.  ``launches`` (the port's
    ``ops._build.LAUNCHES`` by kernel) are the program's own counts over
    the traced units."""

    device_ops: List[Event]
    runtime: List[Event]
    ranges: List[Event]
    cpu_ops: List[Event]
    window: Tuple[float, float]
    batches: int
    updates: int
    computes: int
    launches: Dict[str, int] = field(default_factory=dict)
    update_s: Sequence[float] = ()
    result_s: Sequence[float] = ()
    config: Dict[str, Any] = field(default_factory=dict)
    suite: Dict[str, Any] = field(default_factory=dict)

    # ------------------------------------------------------------ helpers
    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def ranges_named(self, name: str) -> List[Event]:
        return [r for r in self.ranges if r.name == name]

    def inside(self, events: Sequence[Event], range_name: str) -> List[Event]:
        """``events`` that start inside a ``range_name`` range on its thread."""
        spans = sorted((r.start, r.end, r.tid) for r in self.ranges_named(range_name))
        starts = [s[0] for s in spans]
        out = []
        for e in events:
            i = bisect_right(starts, e.start) - 1
            if i >= 0 and spans[i][1] >= e.start and spans[i][2] == e.tid:
                out.append(e)
        return out

    def launched_inside(self, range_name: str) -> List[Event]:
        """Device operations whose launching runtime call lies inside a
        ``range_name`` range."""
        ids = {e.correlation for e in self.inside(self.runtime, range_name)}
        return [d for d in self.device_ops if d.correlation in ids]

    def device_seconds(self, events: Sequence[Event]) -> float:
        return sum(e.end - e.start for e in events) / 1e6

    def named(self, *parts: str) -> List[Event]:
        """Device operations whose name holds any of ``parts``."""
        return [d for d in self.device_ops if any(p in d.name for p in parts)]

    def busy_s(self) -> float:
        """Seconds of the window in which a device operation ran."""
        lo, hi = self.window
        total, reach = 0.0, lo
        for d in sorted(self.device_ops, key=lambda e: e.start):
            s, e = max(d.start, reach), min(d.end, hi)
            if e > s:
                total += e - s
            reach = max(reach, min(d.end, hi))
        return total / 1e6

    def idle_gaps(self) -> List[Tuple[float, float]]:
        """The stretches of the window with no device operation."""
        lo, hi = self.window
        gaps, reach = [], lo
        for d in sorted(self.device_ops, key=lambda e: e.start):
            if d.start > reach:
                gaps.append((reach, min(d.start, hi)))
            reach = max(reach, d.end)
            if reach >= hi:
                break
        if reach < hi:
            gaps.append((reach, hi))
        return [(s, e) for s, e in gaps if e > s]


def parse(events: Sequence[Dict[str, Any]]) -> Dict[str, List[Event]]:
    """Split Chrome-trace events into device operations, runtime calls,
    ``portbench.*`` ranges and CPU operators."""
    out: Dict[str, List[Event]] = {"device": [], "runtime": [], "ranges": [], "cpu": []}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = str(e.get("cat", "")).lower()
        name = str(e.get("name", ""))
        args = e.get("args") or {}
        ev = Event(name, float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("tid"),
                   args.get("correlation"))
        if cat in DEVICE_CATS:
            out["device"].append(ev)
        elif cat in RUNTIME_CATS:
            out["runtime"].append(ev)
        elif cat == "user_annotation" and name.startswith("portbench."):
            out["ranges"].append(ev)
        elif cat == "cpu_op":
            out["cpu"].append(ev)
    return out


def capture(body: Callable[[Callable[[str], Any]], None], on_device: bool) -> Dict[str, List[Event]]:
    """Run ``body(mark)`` under the profiler, inside ``portbench.window``,
    and parse its trace (written to a temporary file and removed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_device else [])
    with profile(activities=activities) as prof:
        with record_function("portbench.window"):
            body(record_function)
            if on_device:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    finally:
        os.unlink(path)
    return parse(raw.get("traceEvents", raw) if isinstance(raw, dict) else raw)


def _label_at(t: float, ops: List[Event], starts: List[float]) -> Optional[str]:
    """The innermost of ``ops`` (sorted by start) running at ``t``."""
    i = bisect_right(starts, t) - 1
    for j in range(i, max(i - 256, -1), -1):
        if ops[j].start <= t <= ops[j].end:
            return ops[j].name
    return None


def breakdown(trace: Trace, top: int = 10) -> Dict[str, List[List[Any]]]:
    """The device operations that took most time, and the idle time by
    what the host was doing: the runtime call or operator running at each
    gap's middle, under the ``portbench.*`` range around it."""
    by_op: Dict[str, float] = defaultdict(float)
    for d in trace.device_ops:
        by_op[d.name] += (d.end - d.start) / 1e6
    host = sorted(trace.runtime + trace.cpu_ops, key=lambda e: e.start)
    host_starts = [e.start for e in host]
    ranges = sorted((r for r in trace.ranges if r.name != "portbench.window"), key=lambda e: e.start)
    range_starts = [r.start for r in ranges]
    by_host: Dict[str, float] = defaultdict(float)
    for s, e in trace.idle_gaps():
        mid = (s + e) / 2
        where = _label_at(mid, ranges, range_starts) or "portbench.window"
        what = _label_at(mid, host, host_starts) or "python"
        by_host[f"{where}: {what}"] += (e - s) / 1e6
    rank = lambda d: sorted(([k, v] for k, v in d.items()), key=lambda kv: -kv[1])[:top]  # noqa: E731
    return {"device_ops": rank(by_op), "idle_gaps": rank(by_host)}
