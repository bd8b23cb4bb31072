"""The traced stretch with the program's own spans on, and the readings
of its spans and read-back counter.

A ``--trace 1`` run traces ``trace_units`` units with the port's spans
off (``run._trace``); every reader that reads that stretch reads it
alone, unchanged.  The readers of the program's spans
(``readbacks_per_batch``, ``update_idle_pct``, ``check_idle_pct``,
``compute_idle_pct``) read a second stretch, traced here once a run at
the first such reader's call: the same cell and seed (the run's command
line names them), its inputs made anew, a loop of its own warmed, then
``trace_units`` units under the profiler (:func:`profile.capture`) with
the port's ranges switched on through its API
(``telemetry.events.annotate``), never through an environment flag.  Its
answers are held to the reference as the run's are, and a wrong one
fails the run.  :class:`SpanTrace` holds that stretch: the
:class:`profile.Trace` of it, the ``torcheval_tpu_torch.*`` ranges, and
the port's read-back counter's delta over it
(``_stats.readback_counts``).

The port opens its ranges with torch's C++ record-function context,
which the profiler records as an operator: :func:`profile.parse` puts
them among the CPU operators, and they are taken from there.  A program
without those ranges or the counter (an older checkout, or a torch
without that context) gives no second stretch, and its readers read
nothing.

The idle time of the card is split by what the host's main thread was
inside, by interval overlap: a member's update span and no check
(``update``), a ``check.*`` or ``readback.*`` span under a member's
update (``check``), a compute span (``compute``: a ``*.compute`` span or
a ``compute.*`` stage).  The three do not overlap; the rest is the
collection's own code and the harness's.
"""

from __future__ import annotations

import argparse
import gc
import sys
import time
from bisect import bisect_right
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

from portbench import inputs, loops, profile
from portbench.judge import Reference, judge
from portbench.profile import Event, Trace
from portbench.reference.members import Data

PREFIX = "torcheval_tpu_torch."
CATEGORIES = ("update", "check", "compute")


@dataclass
class SpanTrace(Trace):
    """A traced stretch with the program's spans on: ``program`` holds its
    ``torcheval_tpu_torch.*`` ranges (name without the prefix), and
    ``readbacks`` the read-back counter's delta by site over it."""

    program: List[Event] = field(default_factory=list)
    readbacks: Dict[str, int] = field(default_factory=dict)
    split: Optional[Dict[str, Any]] = None  # idle_split(self), once taken

    def idle(self) -> Dict[str, Any]:
        """:func:`idle_split` of this stretch, taken once."""
        if self.split is None:
            self.split = idle_split(self)
        return self.split


# ---------------------------------------------------------------- capture
def program_api():
    """``(events, _stats)`` of the port when it has the switch of its
    profiler ranges and the read-back counter, else ``None``."""
    from torcheval_tpu_torch import _stats
    from torcheval_tpu_torch.telemetry import events

    if hasattr(events, "annotate") and hasattr(_stats, "readback_counts"):
        return events, _stats
    return None


def trace_with_spans(cell, seed: int, device, attempts: int = 3) -> Optional[SpanTrace]:
    """Trace ``trace_units`` units of ``cell`` with the port's ranges on,
    in a loop of its own over inputs made from ``seed``, and hold its
    answers to the reference; ``None`` where the program has no such
    ranges.  A trace without device rows (the profiler drops them now and
    then) is taken again."""
    import torch

    from portbench.run import _record

    api = program_api()
    if api is None:
        return None
    events, _stats = api
    on_device = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    loop_cls = loops.load(cell.traffic["loop"], cell.bench_dir)
    data = inputs.make(cell.config["inputs"], loop_cls.samples(cell.config, cell.traffic),
                       seed, device, cell.bench_dir)
    loop = loop_cls(cell.config, cell.traffic, cell.suite, data, device)
    loop.warm()
    units = int(cell.traffic["trace_units"])
    rec = _record(seed, "spans answers")
    try:
        for _ in range(attempts):
            trec = loops.Record()

            def body(mark):
                for _ in range(units):
                    loop.unit(trec, mark)

            before = _stats.readback_counts()
            t1 = time.perf_counter()
            events.annotate(True)
            try:
                parsed = profile.capture(body, on_device)
            finally:
                events.annotate(False)
            after = _stats.readback_counts()
            t2 = time.perf_counter()
            for position, values in trec.answers:
                rec.answer(position, values)
            window = next(r for r in parsed["ranges"] if r.name == "portbench.window")
            st = SpanTrace(
                device_ops=parsed["device"], runtime=parsed["runtime"], ranges=parsed["ranges"],
                cpu_ops=parsed["cpu"], window=(window.start, window.end),
                batches=trec.batches, updates=len(trec.update_s), computes=trec.computes,
                config=cell.config, suite=cell.suite,
                program=[Event(e.name[len(PREFIX):], e.start, e.end, e.tid)
                         for e in parsed["cpu"] if e.name.startswith(PREFIX)],
                readbacks={k: after[k] - before.get(k, 0) for k in after
                           if after[k] != before.get(k, 0)},
            )
            print(f"portbench: spans stretch: inputs and warm-up {t1 - t0:.3f} s, {units} units "
                  f"traced, the trace written and read, {t2 - t1:.3f} s", file=sys.stderr)
            if st.device_ops or not on_device:
                break
            print("profiler: a spans trace without device rows; tracing again", file=sys.stderr)
    finally:
        loop.free()
        del loop
    _check_answers(cell, data, rec)
    del data
    gc.collect()
    if on_device:
        torch.cuda.empty_cache()
    if not st.program:
        print("portbench: the spans stretch holds no program range: no spans readings",
              file=sys.stderr)
        return None
    return st


def _check_answers(cell, data, rec: loops.Record) -> None:
    """Hold the spans stretch's answers to the reference, as the run holds
    its own: a run whose spans path answers wrong fails."""
    import torch

    t0 = time.perf_counter()
    batch = cell.config[cell.traffic["batch"]]
    ref = Reference(cell.suite, Data(data, batch, torch.float64), cell.bench_dir)
    checks, attempted, failed = judge(cell.suite, ref, rec.answers)
    print(f"portbench: spans stretch: {attempted} answers of {rec.offered} checked against "
          f"the reference in {time.perf_counter() - t0:.3f} s", file=sys.stderr)
    if failed or not attempted:
        for name, c in checks.items():
            print(f"portbench: spans stretch check {name} {c['value']!r} limit {c['limit']!r}",
                  file=sys.stderr)
        raise RuntimeError(f"the spans stretch answered wrong: {failed} of {attempted} answers")


# ------------------------------------------------------ the run's stretch
def _run_args() -> Optional[argparse.Namespace]:
    """``--workload`` and ``--seed`` of a ``python -m portbench`` run."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--workload")
    parser.add_argument("--seed", type=int)
    args, _ = parser.parse_known_args(sys.argv[1:])
    return args if args.workload is not None and args.seed is not None else None


def for_run(first: Trace) -> Optional[SpanTrace]:
    """The spans stretch of the run whose own traced stretch is ``first``:
    traced at the first call and kept on ``first`` for the other readers.
    ``None`` outside a ``python -m portbench`` run, where the program has
    no spans, or where the command line names another cell than
    ``first``'s."""
    if not hasattr(first, "spans"):
        first.spans = _trace_run(first)
    return first.spans


def _trace_run(first: Trace) -> Optional[SpanTrace]:
    import torch

    from portbench.spec import load_cell

    args = _run_args()
    if args is None:
        print("portbench: no --workload and --seed on the command line: no spans stretch",
              file=sys.stderr)
        return None
    if program_api() is None:
        print("portbench: the program has no profiler-range switch or read-back counter: "
              "no spans stretch", file=sys.stderr)
        return None
    cell = load_cell(args.workload, Path.cwd())
    if cell.suite != first.suite or cell.config != first.config:
        print(f"portbench: {cell.name} is not the traced cell: no spans stretch", file=sys.stderr)
        return None
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    t0 = time.perf_counter()
    st = trace_with_spans(cell, args.seed, device)
    report(first, st, time.perf_counter() - t0)
    return st


# ------------------------------------------------------------- readings
def unit_seconds(trace: Trace) -> List[float]:
    """Each unit's wall time in a traced stretch: a unit ends where its
    ``portbench.compute`` range ends (its values are then on the host)."""
    ends = sorted(r.end for r in trace.ranges_named("portbench.compute"))
    starts = [trace.window[0]] + ends[:-1]
    return [(b - a) / 1e6 for a, b in zip(starts, ends)]


def _median(values: Sequence[float]) -> float:
    v = sorted(values)
    return v[len(v) // 2] if v else float("nan")


def main_thread(trace: Trace) -> Any:
    """The thread of the harness's ``portbench.window`` range."""
    return next(r.tid for r in trace.ranges if r.name == "portbench.window")


def is_member_update(name: str) -> bool:
    return name.endswith(".update") and not name.startswith("MetricCollection.")


def is_check(name: str) -> bool:
    return name.startswith(("check.", "readback."))


def is_compute(name: str) -> bool:
    return name.endswith(".compute") or name.startswith("compute.")


def category(open_names: Sequence[str]) -> Optional[str]:
    """What the host is in, given the program spans open at an instant."""
    if any(is_member_update(n) for n in open_names):
        return "check" if any(is_check(n) for n in open_names) else "update"
    if any(is_compute(n) for n in open_names):
        return "compute"
    return None


class Timeline:
    """The main thread's program spans as elementary segments: between
    two consecutive span boundaries the set of open spans is fixed.
    ``opened[i]`` lists the spans open on ``[bounds[i], bounds[i + 1])``,
    outermost first."""

    def __init__(self, spans: Sequence[Event]) -> None:
        points = sorted({t for s in spans for t in (s.start, s.end)})
        self.bounds = points
        adds: Dict[float, List[Event]] = defaultdict(list)
        ends: Dict[float, List[Event]] = defaultdict(list)
        for s in spans:
            adds[s.start].append(s)
            ends[s.end].append(s)
        self.opened: List[Tuple[Event, ...]] = []
        live: List[Event] = []
        for t in points[:-1]:
            gone = {id(s) for s in ends.get(t, ())}
            live = [s for s in live if id(s) not in gone]
            live.extend(sorted((s for s in adds.get(t, ()) if s.end > t), key=lambda s: -s.end))
            self.opened.append(tuple(live))

    def at(self, t: float) -> Tuple[Event, ...]:
        """The spans open at ``t``."""
        i = bisect_right(self.bounds, t) - 1
        return self.opened[i] if 0 <= i < len(self.opened) else ()

    def segments(self):
        """``(start, end, open spans)`` of each elementary segment."""
        for i, opened in enumerate(self.opened):
            yield self.bounds[i], self.bounds[i + 1], opened


def timeline(st: SpanTrace) -> Timeline:
    tid = main_thread(st)
    lo, hi = st.window
    return Timeline([Event(s.name, max(s.start, lo), min(s.end, hi), s.tid)
                     for s in st.program if s.tid == tid and s.end > lo and s.start < hi])


def _overlaps(segments, gaps: Sequence[Tuple[float, float]]):
    """``(seconds, open spans)`` of each overlap of a segment with a gap;
    both sorted and each free of overlaps within itself."""
    j = 0
    for s, e, opened in segments:
        while j < len(gaps) and gaps[j][1] <= s:
            j += 1
        k = j
        while k < len(gaps) and gaps[k][0] < e:
            both = min(e, gaps[k][1]) - max(s, gaps[k][0])
            if both > 0:
                yield both / 1e6, opened
            k += 1


def idle_split(st: SpanTrace) -> Dict[str, Any]:
    """The card's idle seconds in the stretch, split by what the main
    thread was in (:func:`category`): ``idle``, one entry a category,
    ``collection`` (in a ``MetricCollection`` span and no member's),
    ``harness`` (in no program span), and ``innermost``: the idle seconds
    by innermost open span, ``harness`` for none."""
    gaps = st.idle_gaps()
    out: Dict[str, Any] = {c: 0.0 for c in CATEGORIES}
    out.update(idle=sum(e - s for s, e in gaps) / 1e6, collection=0.0)
    innermost: Dict[str, float] = defaultdict(float)
    for seconds, opened in _overlaps(timeline(st).segments(), gaps):
        if opened:
            innermost[opened[-1].name] += seconds
            out[category([s.name for s in opened]) or "collection"] += seconds
    out["harness"] = out["idle"] - sum(out[c] for c in (*CATEGORIES, "collection"))
    innermost["harness"] = out["harness"]
    out["innermost"] = dict(innermost)
    return out


def uncounted(st: SpanTrace) -> List[Tuple[Event, str]]:
    """Blocking runtime calls on the main thread inside a
    ``portbench.update`` range or a program compute span but in no
    ``readback.*`` span, each with the innermost program span around it
    (``-`` for none): read backs the program's counter does not see."""
    tid = main_thread(st)
    line = timeline(st)
    updates = sorted((r.start, r.end) for r in st.ranges_named("portbench.update") if r.tid == tid)
    starts = [u[0] for u in updates]
    out = []
    for e in st.runtime:
        if e.tid != tid or e.name not in profile.BLOCKING:
            continue
        opened = line.at(e.start)
        names = [s.name for s in opened]
        i = bisect_right(starts, e.start) - 1
        in_update = i >= 0 and updates[i][1] >= e.start
        if (in_update or any(is_compute(n) for n in names)) and not any(
                n.startswith("readback.") for n in names):
            out.append((e, names[-1] if names else "-"))
    return out


def report(first: Trace, st: Optional[SpanTrace], seconds: float) -> None:
    """Standard error: both stretches' unit medians (the cost of the
    spans), the read backs by site, and the idle time's split."""
    if st is None:
        return
    a, b = _median(unit_seconds(first)), _median(unit_seconds(st))
    print(f"portbench: spans stretch ({seconds:.3f} s with its set-up): unit median "
          f"{a:.6f} s spans off, {b:.6f} s spans on ({100.0 * (b / a - 1.0):+.2f} %)",
          file=sys.stderr)
    print(f"portbench: read backs over {st.batches} batches: {dict(sorted(st.readbacks.items()))}",
          file=sys.stderr)
    if not st.device_ops:
        return
    split = st.idle()
    w = st.window_s
    print(f"portbench: spans stretch idle {split['idle']:.6f} s of {w:.6f} s: "
          + ", ".join(f"{k} {split[k]:.6f} s ({100.0 * split[k] / w:.3f} %)"
                      for k in (*CATEGORIES, "collection", "harness")),
          file=sys.stderr)
    top = sorted(split["innermost"].items(), key=lambda kv: -kv[1])[:10]
    print("portbench: idle by innermost program span: "
          + ", ".join(f"{k} {v:.6f} s" for k, v in top), file=sys.stderr)


def idle_pct(trace: Trace, kind: str) -> Optional[float]:
    """A reader's value: the share of the spans stretch's window in which
    the card was idle and the host in ``kind``; ``None`` without the
    stretch or its device rows."""
    st = for_run(trace)
    if st is None or not st.device_ops or st.window_s <= 0:
        return None
    return 100.0 * st.idle()[kind] / st.window_s
