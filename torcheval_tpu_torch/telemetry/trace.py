"""Causal tracing: contextvars-propagated trace identity for telemetry
events (the port of ``torcheval_tpu/telemetry/trace.py``).

The event bus (:mod:`torcheval_tpu_torch.telemetry.events`) records
*what* happened; this module records *why*.  Every event emitted while
tracing is on carries ``(trace_id, span_id, parent_span_id)``, stamped
at :func:`events.emit` time from a ``contextvars`` context, so the
exporters can rebuild the tree.

Context model
-------------
A :class:`TraceContext` names the *enclosing span*: every event emitted
while it is active carries ``span_id = ctx.span_id`` and
``parent_span_id = ctx.parent_span_id``.  Events sharing a span_id are
one tree node; a :class:`~torcheval_tpu_torch.telemetry.events.SpanEvent`
bearing that span_id names and times the node.  Ids are opaque strings,
unique per process (random process prefix + counter).

Propagation
-----------
``contextvars`` does NOT flow into ``threading.Thread`` targets.  The
one thread boundary the port's ported modules cross with a context is
``resilience/retry.py``'s deadline thread: ``capture()`` before the
spawn, ``adopt()`` in the thread's target.  The ranks of a
:class:`~torcheval_tpu_torch.distributed.LocalWorld` are threads too;
each roots its own spans, as in the JAX package.

Zero-cost-when-off
------------------
Same one-branch contract as the bus: every call site is
``if _trace.ENABLED: ...``.  Enable with ``TORCHEVAL_TPU_TORCH_TRACE=1``
or :func:`enable`.

The second half of this module (:func:`build_forest`,
:func:`select_trace`, :func:`critical_path`, :func:`format_forest`) is
the cold-path reconstruction used by the CLI ``--trace`` filter and the
flight recorder's bundles; it works on plain event dicts, so it runs
offline on a dump written by either package.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import os
from dataclasses import dataclass, replace
from typing import Any, Dict, Iterator, List, Optional, Sequence

from torcheval_tpu_torch import _flags

# Module-level flag: hook sites read this as a plain attribute (the
# one-branch zero-overhead contract, see events.ENABLED).
ENABLED: bool = _flags.get("TRACE")


@dataclass(frozen=True)
class TraceContext:
    """The enclosing span: events emitted under it carry these ids."""

    trace_id: str
    span_id: str
    parent_span_id: str = ""


_current: "contextvars.ContextVar[Optional[TraceContext]]" = (
    contextvars.ContextVar("torcheval_tpu_torch_trace", default=None)
)

# Random per-process prefix + atomic counter: ids unique per process and
# (with 4 random bytes) per fleet, with no lock and no wall clock.
_PROCESS_PREFIX = os.urandom(4).hex()
_counter = itertools.count(1)


def _new_id() -> str:
    return f"{_PROCESS_PREFIX}{next(_counter):06x}"


def new_span_id() -> str:
    """A fresh span id."""
    return _new_id()


# ------------------------------------------------------------------- control
def enable() -> None:
    """Turn tracing on (equivalently ``TORCHEVAL_TPU_TORCH_TRACE=1``)."""
    global ENABLED
    ENABLED = True


def disable() -> None:
    """Turn tracing off — hook sites go back to one cold branch.
    Already-installed contexts die with their scopes."""
    global ENABLED
    ENABLED = False


def enabled() -> bool:
    return ENABLED


# ------------------------------------------------------------------- context
def current() -> Optional[TraceContext]:
    """The active context in this thread, or None."""
    return _current.get()


def capture() -> Optional[TraceContext]:
    """Snapshot the active context for an explicit thread handoff
    (pair with :func:`adopt` inside the spawned thread)."""
    return _current.get()


def adopt(ctx: Optional[TraceContext]) -> None:
    """Install a captured context in the current thread, unscoped — the
    thread-entry half of a :func:`capture`/:func:`adopt` handoff.  A
    None context (captured while tracing was off) is a no-op."""
    if ctx is not None:
        _current.set(ctx)


def push(ctx: TraceContext) -> "contextvars.Token":
    """Install ``ctx`` and return the token for :func:`pop` — the
    non-context-manager form for long straight-line scopes."""
    return _current.set(ctx)


def pop(token: "contextvars.Token") -> None:
    _current.reset(token)


@contextlib.contextmanager
def activate(ctx: TraceContext) -> Iterator[TraceContext]:
    """Scoped install of an existing context."""
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


def root(name: str = "") -> TraceContext:
    """A fresh root context (new trace).  ``name`` is documentation at
    the call site only; nodes are named by the span events emitted under
    them."""
    del name
    return TraceContext(trace_id=_new_id(), span_id=_new_id())


def child(parent: Optional[TraceContext] = None) -> TraceContext:
    """A child context of ``parent`` (default: the active context); a
    fresh root when there is no parent."""
    base = parent if parent is not None else _current.get()
    if base is None:
        return root()
    return TraceContext(
        trace_id=base.trace_id,
        span_id=_new_id(),
        parent_span_id=base.span_id,
    )


def derive(trace_id: str, parent_span_id: str = "") -> TraceContext:
    """A context under wire-carried ids (cross-host adoption: the merge
    trace id all ranks agree on, plus the parent rank's span id when an
    ack has delivered it)."""
    return TraceContext(
        trace_id=trace_id,
        span_id=_new_id(),
        parent_span_id=parent_span_id,
    )


def reparent(ctx: TraceContext, parent_span_id: str) -> TraceContext:
    """The same span under a newly-learned parent (a fleet-merge child
    folds the parent span id its ack carried into its merge span)."""
    return replace(ctx, parent_span_id=parent_span_id)


@contextlib.contextmanager
def span(name: str = "") -> Iterator[TraceContext]:
    """Scoped child span of the active context (fresh root when none)."""
    ctx = child()
    del name
    token = _current.set(ctx)
    try:
        yield ctx
    finally:
        _current.reset(token)


# --------------------------------------------------- offline reconstruction
def _node_name(events: List[Dict[str, Any]]) -> str:
    for d in events:
        for key in ("name", "op", "program", "rule"):
            if d.get(key):
                return str(d[key])
    return str(events[0].get("kind", "span")) if events else "span"


def build_forest(
    event_dicts: Sequence[Dict[str, Any]],
) -> List[Dict[str, Any]]:
    """Span forest from plain event dicts (``export.event_to_dict`` /
    jsonl rows).  Events sharing a ``span_id`` form one node; nodes link
    on ``parent_span_id`` regardless of trace_id (the fleet-merge root
    span bridges the merge trace into the local engine trace via its
    parent link).  Parents referenced but absent from the sample get a
    synthesized placeholder so partial dumps still render.

    Each node: ``{span_id, parent_span_id, trace_ids, name, kind,
    seconds, time_s, host, thread, events, children}`` — ``children``
    sorted by first-event time, ``seconds`` the largest duration any of
    the node's events carries.
    """
    by_span: Dict[str, List[Dict[str, Any]]] = {}
    for d in event_dicts:
        sid = d.get("span_id") or ""
        if not sid:
            continue
        by_span.setdefault(sid, []).append(d)

    nodes: Dict[str, Dict[str, Any]] = {}
    for sid, evs in by_span.items():
        evs = sorted(evs, key=lambda d: d.get("time_s", 0.0))
        parent = ""
        for d in evs:
            if d.get("parent_span_id"):
                parent = d["parent_span_id"]  # last non-empty link wins
        nodes[sid] = {
            "span_id": sid,
            "parent_span_id": parent,
            "trace_ids": sorted(
                {d.get("trace_id", "") for d in evs if d.get("trace_id")}
            ),
            "name": _node_name(evs),
            "kind": evs[0].get("kind", "event"),
            "seconds": max(
                (float(d.get("seconds", 0.0)) for d in evs), default=0.0
            ),
            "time_s": evs[0].get("time_s", 0.0),
            "host": evs[0].get("host", None),
            "thread": evs[0].get("thread", ""),
            "events": evs,
            "children": [],
        }
    # Placeholders for referenced-but-missing parents (ring rotation,
    # partial host samples): the links still render.
    for node in list(nodes.values()):
        pid = node["parent_span_id"]
        if pid and pid not in nodes:
            nodes[pid] = {
                "span_id": pid,
                "parent_span_id": "",
                "trace_ids": list(node["trace_ids"]),
                "name": "(not in sample)",
                "kind": "missing",
                "seconds": 0.0,
                "time_s": node["time_s"],
                "host": None,
                "thread": "",
                "events": [],
                "children": [],
            }
    roots: List[Dict[str, Any]] = []
    for node in nodes.values():
        pid = node["parent_span_id"]
        if pid:
            nodes[pid]["children"].append(node)
        else:
            roots.append(node)
    for node in nodes.values():
        node["children"].sort(key=lambda n: n["time_s"])
    roots.sort(key=lambda n: n["time_s"])
    return roots


def _subtree_matches(node: Dict[str, Any], trace_id: str) -> bool:
    if trace_id in node["trace_ids"]:
        return True
    return any(_subtree_matches(c, trace_id) for c in node["children"])


def select_trace(
    roots: Sequence[Dict[str, Any]], trace_id: str
) -> List[Dict[str, Any]]:
    """The trees containing any span stamped with ``trace_id``.  Whole
    trees, not pruned subtrees: a merge trace bridged under an engine
    trace should render with its local ancestry."""
    return [r for r in roots if _subtree_matches(r, trace_id)]


def critical_path(root_node: Dict[str, Any]) -> List[Dict[str, Any]]:
    """The slowest root-to-leaf chain by per-node ``seconds`` — the
    fleet report's per-level critical path when run on a merge tree."""
    best: List[Dict[str, Any]] = []
    best_cost = -1.0

    def walk(node: Dict[str, Any], path, cost) -> None:
        nonlocal best, best_cost
        path = path + [node]
        cost = cost + float(node["seconds"])
        if not node["children"]:
            if cost > best_cost:
                best_cost = cost
                best = path
            return
        for c in node["children"]:
            walk(c, path, cost)

    walk(root_node, [], 0.0)
    return best


def _format_node(node: Dict[str, Any], depth: int, lines: List[str]) -> None:
    host = f" host={node['host']}" if node["host"] is not None else ""
    thread = f" [{node['thread']}]" if node["thread"] else ""
    secs = f" {node['seconds'] * 1e3:.2f}ms" if node["seconds"] else ""
    extras = ""
    kinds = [d.get("kind", "") for d in node["events"]]
    if len(kinds) > 1:
        extras = f" ({len(kinds)} events: {', '.join(sorted(set(kinds)))})"
    lines.append(
        "  " * depth
        + f"{node['name']} <{node['kind']}>{secs}{host}{thread}"
        + f" span={node['span_id']}{extras}"
    )
    for c in node["children"]:
        _format_node(c, depth + 1, lines)


def format_forest(roots: Sequence[Dict[str, Any]]) -> str:
    """Text render of :func:`build_forest` output (CLI ``--trace``, the
    flight-recorder bundle render)."""
    lines: List[str] = []
    for r in roots:
        tids = ",".join(r["trace_ids"]) or "(none)"
        lines.append(f"trace {tids}")
        _format_node(r, 1, lines)
    return "\n".join(lines)
