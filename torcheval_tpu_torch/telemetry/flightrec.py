"""Flight recorder: a bounded event tail dumped as an atomic post-mortem
bundle the moment something goes wrong (the port of
``torcheval_tpu/telemetry/flightrec.py``).

The telemetry ring answers questions asked *while the process is
healthy*; by the time an operator looks after an incident, the evidence
has rotated out.  This module keeps a cheap secondary index over the bus
(the last N events, appended by :func:`events.emit` under a one-branch
``ENABLED`` guard) and on a trigger writes everything a post-mortem needs
to one directory:

``events.jsonl``
    The retained tail, trace context included, one JSON object per line
    (readable by ``python -m torcheval_tpu_torch.telemetry`` and
    ``export.read_jsonl``).
``trace.perfetto.json``
    The same tail as a Chrome/Perfetto trace.
``MANIFEST.json``
    Written **last**: its presence marks the bundle complete (the
    tmp+fsync+rename writer of ``resilience/checkpoint.py``).  Carries the
    trigger reason, the non-default flags, the trace tree holding the
    trigger, the membership view and health state where the trigger site
    had them, and a SHA-256 for each data file, so :func:`validate_bundle`
    (CLI ``--flight``) can prove integrity.

The bundle layout (:data:`BUNDLE_FORMAT`, the manifest's fields, a
SHA-256 a file) is the JAX package's: a bundle written by either package
validates in the other.  ``program_profiles`` holds the perfscope
profiles among the bundle's events, and the ``tenants.json`` file is
written when a trigger passes tenant rows (serve's quarantine path, with
the metering ledger on).

Trigger sites (each under ``if _flightrec.ENABLED:``): a
:class:`~torcheval_tpu_torch.telemetry.health.DataCorruptionError` raise,
a membership excision (``resilience/membership.py``) and a fault-plan
rule firing (``resilience/faults.py``).  Triggers inside ``cooldown_s``
of the previous bundle are counted and suppressed.

Enable with ``TORCHEVAL_TPU_TORCH_FLIGHTREC=1`` (``_DIR`` / ``_LAST``
set the destination and tail length) or :func:`enable`.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional

from torcheval_tpu_torch import _flags

# Module-level flag: hook sites read this as a plain attribute (the
# one-branch zero-overhead contract, see events.ENABLED).
ENABLED: bool = _flags.get("FLIGHTREC")

DEFAULT_LAST_EVENTS = _flags.INT_FLAGS["FLIGHTREC_LAST"][0]
DEFAULT_DIR = "flightrec"
DEFAULT_COOLDOWN_S = 5.0

MANIFEST_NAME = "MANIFEST.json"
BUNDLE_FORMAT = "torcheval-tpu-flightrec/1"

_lock = threading.Lock()


def _env_last() -> int:
    return _flags.get_int("FLIGHTREC_LAST")


# The secondary buffer: a deque appended on every emit while enabled.
# deque.append is atomic under the GIL; the lock only guards triggers.
_recent: "deque" = deque(maxlen=_env_last())
_dir: str = _flags.get_str("FLIGHTREC_DIR") or DEFAULT_DIR
_cooldown_s: float = DEFAULT_COOLDOWN_S
_last_trigger_s: float = 0.0
_seq: int = 0
_suppressed: int = 0
_bundles: List[str] = []


class BundleError(Exception):
    """A bundle failed validation; ``problems`` lists every failure."""

    def __init__(self, path: str, problems: List[str]) -> None:
        super().__init__(
            f"corrupt flight-recorder bundle {path}: "
            + "; ".join(problems)
        )
        self.path = path
        self.problems = problems


# ------------------------------------------------------------------- control
def enable(
    *,
    dir: Optional[str] = None,
    last_events: Optional[int] = None,
    cooldown_s: Optional[float] = None,
) -> None:
    """Turn the recorder on (equivalently ``TORCHEVAL_TPU_TORCH_FLIGHTREC=1``).
    ``dir`` overrides the bundle destination, ``last_events`` resizes
    the retained tail, ``cooldown_s`` the trigger suppression window."""
    global ENABLED, _dir, _recent, _cooldown_s
    with _lock:
        if last_events is not None:
            if int(last_events) < 1:
                raise ValueError(
                    f"last_events must be >= 1, got {last_events}"
                )
            _recent = deque(_recent, maxlen=int(last_events))
        if dir is not None:
            _dir = dir
        if cooldown_s is not None:
            _cooldown_s = float(cooldown_s)
    ENABLED = True


def disable() -> None:
    """Turn the recorder off — hook sites go back to one cold branch.
    The retained tail and written bundles are kept."""
    global ENABLED
    ENABLED = False


def enabled() -> bool:
    return ENABLED


def reset() -> None:
    """Drop the tail, the cooldown state, and the bundle journal
    (test-isolation hook; bundle directories on disk are untouched)."""
    global _last_trigger_s, _seq, _suppressed, _bundles, _cooldown_s
    with _lock:
        _recent.clear()
        _last_trigger_s = 0.0
        _seq = 0
        _suppressed = 0
        _bundles = []
        _cooldown_s = DEFAULT_COOLDOWN_S


def suppressed() -> int:
    """Triggers swallowed by the cooldown window since :func:`reset`."""
    with _lock:
        return _suppressed


def bundles() -> List[str]:
    """Paths of bundles written by this process, oldest first."""
    with _lock:
        return list(_bundles)


def last_bundle() -> Optional[str]:
    with _lock:
        return _bundles[-1] if _bundles else None


# ------------------------------------------------------------------- hooks
def observe(event: Any) -> None:
    """Append one event to the retained tail.  Called by
    :func:`events.emit` under its own lock; the deque append is atomic,
    so no second lock on the hot path."""
    # tpulint: disable=TPU006 -- deque.append is atomic; emit holds its lock
    _recent.append(event)


def trigger(
    reason: str,
    detail: str = "",
    extra: Optional[Dict[str, Any]] = None,
) -> Optional[str]:
    """Dump a post-mortem bundle now.  Returns the bundle directory, or
    None when the cooldown window suppressed the trigger.  Never raises:
    a recorder that cannot write must not take the process down with a
    second failure — the problem is reported as a RuntimeWarning."""
    global _seq, _last_trigger_s, _suppressed
    now = time.monotonic()
    with _lock:
        if (
            _cooldown_s > 0
            and _last_trigger_s
            and now - _last_trigger_s < _cooldown_s
        ):
            _suppressed += 1
            return None
        _last_trigger_s = now
        _seq += 1
        seq = _seq
        tail = list(_recent)
    try:
        path = _write_bundle(seq, reason, detail, dict(extra or {}), tail)
    except Exception as exc:  # noqa: BLE001 - post-mortem must not kill
        import warnings

        warnings.warn(
            f"flight recorder failed to write bundle for {reason!r}: "
            f"{type(exc).__name__}: {exc}",
            RuntimeWarning,
            stacklevel=2,
        )
        return None
    with _lock:
        _bundles.append(path)
    return path


# ------------------------------------------------------------------ writing
def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _jsonable(value: Any) -> Any:
    """Best-effort conversion for trigger extras (tuple keys, sets,
    numpy scalars) so a weird payload never kills the dump."""
    try:
        json.dumps(value)
        return value
    except (TypeError, ValueError):
        if isinstance(value, dict):
            return {str(k): _jsonable(v) for k, v in value.items()}
        if isinstance(value, (list, tuple, set, frozenset)):
            return [_jsonable(v) for v in value]
        return repr(value)


def _write_bundle(
    seq: int,
    reason: str,
    detail: str,
    extra: Dict[str, Any],
    tail: List[Any],
) -> str:
    # Cold path: the exporters (and through them the event classes) are
    # imported lazily so this module stays importable from anywhere
    # without layering cycles.
    from torcheval_tpu_torch.resilience.checkpoint import _fsync_write
    from torcheval_tpu_torch.telemetry import events as _events
    from torcheval_tpu_torch.telemetry import export as _export
    from torcheval_tpu_torch.telemetry import trace as _trace

    dicts = [_export.event_to_dict(e) for e in tail]
    events_blob = (
        "\n".join(json.dumps(d, sort_keys=True) for d in dicts) + "\n"
        if dicts
        else ""
    ).encode("utf-8")
    perfetto_blob = json.dumps(
        _export.to_perfetto(tail), indent=1, sort_keys=True
    ).encode("utf-8")

    # The trace tree containing the trigger: the triggering thread's
    # active context pins it; fall back to the newest traced event.
    trigger_trace_id = ""
    trigger_span_id = ""
    if _trace.ENABLED:
        ctx = _trace.current()
        if ctx is not None:
            trigger_trace_id = ctx.trace_id
            trigger_span_id = ctx.span_id
    if not trigger_trace_id:
        for d in reversed(dicts):
            if d.get("trace_id"):
                trigger_trace_id = d["trace_id"]
                trigger_span_id = d.get("span_id", "")
                break
    forest = _trace.build_forest(dicts)
    tree = (
        _trace.select_trace(forest, trigger_trace_id)
        if trigger_trace_id
        else forest
    )

    health_state: Dict[str, Any] = {}
    try:
        from torcheval_tpu_torch.telemetry import health as _health

        health_state = {
            "enabled": _health.enabled(),
            "raise_on_corrupt": bool(
                getattr(_health, "RAISE_ON_CORRUPT", False)
            ),
        }
    except Exception:  # noqa: BLE001 - health state is optional
        health_state = {"enabled": None}

    # A "tenants" key in the trigger extra (the serve quarantine path
    # passes the metering ledger rows) becomes its own declared bundle
    # file — the postmortem's who-was-running-what record.
    tenants_blob: bytes = b""
    tenant_rows = extra.pop("tenants", None)
    if tenant_rows is not None:
        tenants_blob = json.dumps(
            _jsonable(tenant_rows), indent=1, sort_keys=True
        ).encode("utf-8")

    manifest: Dict[str, Any] = {
        "format": BUNDLE_FORMAT,
        "seq": seq,
        "reason": reason,
        "detail": detail,
        "time_unix": time.time(),
        "pid": os.getpid(),
        "thread": threading.current_thread().name,
        "flags": _flags.snapshot_non_default(),
        "event_count": len(dicts),
        "events_dropped_by_kind": _events.dropped_by_kind(),
        "trigger_trace_id": trigger_trace_id,
        "trigger_span_id": trigger_span_id,
        "trace_tree": _strip_tree(tree),
        "program_profiles": [
            d for d in dicts if d.get("kind") == "program_profile"
        ],
        "membership": _jsonable(extra.pop("membership", None)),
        "health": health_state,
        "extra": _jsonable(extra),
        "files": {
            "events.jsonl": {
                "sha256": _sha256(events_blob),
                "bytes": len(events_blob),
            },
            "trace.perfetto.json": {
                "sha256": _sha256(perfetto_blob),
                "bytes": len(perfetto_blob),
            },
        },
    }
    if tenants_blob:
        manifest["files"]["tenants.json"] = {
            "sha256": _sha256(tenants_blob),
            "bytes": len(tenants_blob),
        }

    # tpulint: disable=TPU006 -- str rebinds are atomic; enable() is rare
    base = _dir
    os.makedirs(base, exist_ok=True)
    final = os.path.join(base, f"bundle-{seq:04d}-{_slug(reason)}")
    while os.path.exists(final):
        final += "x"
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    _fsync_write(os.path.join(tmp, "events.jsonl"), events_blob)
    _fsync_write(os.path.join(tmp, "trace.perfetto.json"), perfetto_blob)
    if tenants_blob:
        _fsync_write(os.path.join(tmp, "tenants.json"), tenants_blob)
    # Manifest LAST: a bundle without one is by definition incomplete.
    _fsync_write(
        os.path.join(tmp, MANIFEST_NAME),
        json.dumps(manifest, indent=1, sort_keys=True).encode("utf-8"),
    )
    os.rename(tmp, final)
    return final


def _slug(reason: str) -> str:
    return "".join(
        c if c.isalnum() or c in "-_" else "-" for c in reason
    )[:40] or "trigger"


def _strip_tree(nodes: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The trace tree without the per-node raw event lists (those live
    in events.jsonl; the manifest keeps the shape small)."""
    return [
        {
            "span_id": n["span_id"],
            "parent_span_id": n["parent_span_id"],
            "trace_ids": n["trace_ids"],
            "name": n["name"],
            "kind": n["kind"],
            "seconds": n["seconds"],
            "host": n["host"],
            "thread": n["thread"],
            "event_kinds": [d.get("kind", "") for d in n["events"]],
            "children": _strip_tree(n["children"]),
        }
        for n in nodes
    ]


# ------------------------------------------------------------------ reading
def validate_bundle(path: str) -> List[str]:
    """Every integrity problem with the bundle at ``path`` (empty list
    means valid): manifest present and parseable, declared files present
    with matching size and sha256, events.jsonl well-formed."""
    problems: List[str] = []
    manifest_path = os.path.join(path, MANIFEST_NAME)
    if not os.path.isdir(path):
        return [f"not a directory: {path}"]
    if not os.path.exists(manifest_path):
        return [f"missing {MANIFEST_NAME} (incomplete bundle)"]
    try:
        with open(manifest_path, "r", encoding="utf-8") as fh:
            manifest = json.load(fh)
    except (OSError, json.JSONDecodeError) as exc:
        return [f"unreadable {MANIFEST_NAME}: {exc}"]
    if manifest.get("format") != BUNDLE_FORMAT:
        problems.append(
            f"unknown bundle format {manifest.get('format')!r}"
        )
    for name, meta in (manifest.get("files") or {}).items():
        fpath = os.path.join(path, name)
        if not os.path.exists(fpath):
            problems.append(f"missing data file {name}")
            continue
        with open(fpath, "rb") as fh:
            data = fh.read()
        if len(data) != meta.get("bytes"):
            problems.append(
                f"{name}: {len(data)} bytes, manifest says "
                f"{meta.get('bytes')}"
            )
        elif _sha256(data) != meta.get("sha256"):
            problems.append(f"{name}: sha256 mismatch")
    events_path = os.path.join(path, "events.jsonl")
    if os.path.exists(events_path):
        with open(events_path, "r", encoding="utf-8") as fh:
            for i, line in enumerate(fh, 1):
                if not line.strip():
                    continue
                try:
                    json.loads(line)
                except json.JSONDecodeError:
                    problems.append(f"events.jsonl:{i}: not valid JSON")
                    break
    return problems


def read_bundle(path: str) -> Dict[str, Any]:
    """Load a validated bundle: ``{"path", "manifest", "events"}``.
    Raises :class:`BundleError` when validation fails."""
    problems = validate_bundle(path)
    if problems:
        raise BundleError(path, problems)
    with open(
        os.path.join(path, MANIFEST_NAME), "r", encoding="utf-8"
    ) as fh:
        manifest = json.load(fh)
    events: List[Dict[str, Any]] = []
    events_path = os.path.join(path, "events.jsonl")
    if os.path.exists(events_path):
        with open(events_path, "r", encoding="utf-8") as fh:
            events = [
                json.loads(line) for line in fh if line.strip()
            ]
    return {"path": path, "manifest": manifest, "events": events}


def format_bundle(bundle: Dict[str, Any]) -> str:
    """Text render of a loaded bundle (CLI ``--flight``)."""
    from torcheval_tpu_torch.telemetry import trace as _trace

    m = bundle["manifest"]
    lines = [
        f"flight-recorder bundle {bundle['path']}",
        f"  reason: {m['reason']}"
        + (f" — {m['detail']}" if m.get("detail") else ""),
        f"  events: {m['event_count']} retained "
        f"(pid {m.get('pid')}, thread {m.get('thread')})",
    ]
    if m.get("flags"):
        flags = ", ".join(f"{k}={v}" for k, v in sorted(m["flags"].items()))
        lines.append(f"  flags: {flags}")
    by_kind = m.get("events_dropped_by_kind") or {}
    if by_kind:
        drops = ", ".join(f"{k}: {v}" for k, v in sorted(by_kind.items()))
        lines.append(f"  ring drops before capture: {drops}")
    if m.get("membership"):
        lines.append(f"  membership: {m['membership']}")
    if m.get("program_profiles"):
        lines.append(
            f"  program profiles: {len(m['program_profiles'])} row(s)"
        )
    if m.get("trigger_trace_id"):
        lines.append(f"  trigger trace: {m['trigger_trace_id']}")
    forest = _trace.build_forest(bundle["events"])
    if m.get("trigger_trace_id"):
        selected = _trace.select_trace(forest, m["trigger_trace_id"])
        forest = selected or forest
    if forest:
        lines.append("  trace tree:")
        for block in _trace.format_forest(forest).splitlines():
            lines.append("    " + block)
    return "\n".join(lines)
