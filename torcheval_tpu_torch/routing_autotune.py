"""Self-tuning routing: the persisted measured-cost store (the port of
``torcheval_tpu/routing_autotune.py``).

The static deciders rank routes with constants; this module lets a
measurement on the card overrule them where a route is a real choice:

* a **route-cost store**: one JSON file,
  ``<TORCHEVAL_TPU_TORCH_AUTOTUNE_DIR>/torcheval_tpu_torch_route_costs.json``,
  written with the ``resilience/checkpoint.py`` discipline (tmp + flush +
  fsync + atomic rename, a SHA-256 sidecar validating the payload; a
  corrupt file is quarantined with a ``.corrupt`` suffix instead of
  poisoning startup).  Without a directory the store lives in memory;
* two **feeds**: :func:`record_measurement` stores the wall clock that
  ``aot.warmup(autotune=True)`` measures when it races the candidates of
  a decision on real shapes (``site="race"``), and :func:`observe_profile`
  turns a priced program profile (perfscope's, bytes only) into a
  roofline-priced row;
* one **consumer**: :func:`decide`, called from the auto branch of
  ``ops/_mega_plan.plan_for`` and from the confusion matrix's row-chunk
  resolution (``_cm_row_chunk``): a dict lookup on the hot path, a store
  scan only when the decision cache is cold for the current epoch.

Staleness never binds: every row is stamped with the port's version, the
card (``tools.roofline.current_device_kind()``: a row measured on one
card never decides on another) and the ``_mega_plan.route_token()``
context, with the decided element masked (a race forces it while
measuring).  A row of another version is dropped at load; a row whose
context or card does not match never wins a lookup.

The layer is off unless turned on: every call site guards on
``if _autotune.ENABLED:``, and with it off the static heuristics decide as
before this module existed.  Unset, ``TORCHEVAL_TPU_TORCH_AUTOTUNE``
means on exactly when a store directory is configured.  An explicit route
flag always outranks a measured pick (:func:`decide`).

No decision may send a CUDA tensor to a kernel's plain version: every
choice here is a route that launches a kernel (or, for ``cm_row_chunk``,
the tile height of the one-hot product).  ``rank_sketch`` rows are
advisory: a measured pick never changes a metric's state layout, which
the ``sketch=`` argument or the ``RANK_SKETCH`` flag fixes at
construction.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Any, Dict, List, Mapping, Optional, Tuple

from torcheval_tpu_torch import _flags
from torcheval_tpu_torch.ops import _flags as _oflags

__all__ = [
    "ENABLED",
    "EPOCH",
    "enable",
    "disable",
    "enabled",
    "batch_signature",
    "observe_profile",
    "record_measurement",
    "preference",
    "decide",
    "measured_crossover",
    "store_path",
    "store_rows",
    "flush",
    "clear",
    "probe_budget",
]

# Decisions this layer ranks.  ``cm_row_chunk`` choices are stringified
# powers of two; ``megakernel`` is "mega" (the collection kernel) or
# "fused" (each member on its own kernels); ``rank_sketch`` is "sketch" or
# "sort" (advice only).  The JAX package's ``wavefront`` decision has no
# counterpart: its other choice is an XLA sweep, which in the port would
# send a CUDA tensor to the edit distance's plain version.
DECISIONS: Tuple[str, ...] = (
    "megakernel",
    "rank_sketch",
    "cm_row_chunk",
)

# The element of ``_mega_plan.route_token()`` each decision controls,
# masked in a row's stamp: a race forces that element while measuring it
# (an unmasked stamp would never bind under auto mode).
_TOKEN_INDEX = {
    "megakernel": 0,
    "cm_row_chunk": 1,
    "rank_sketch": 3,
}
_MASK = "*"
_TOKEN_LEN = 4

# Pricing sites, most trustworthy first: a race is wall clock on the real
# entry point; the others price one program from its bytes and FLOPs.
# preference() only compares two choices measured at the SAME site.
_SITE_RANK = ("race", "collection", "scan")

_STORE_BASENAME = "torcheval_tpu_torch_route_costs.json"
_LOCK = threading.RLock()

# key -> row; None until the first load.  EPOCH counts store mutations:
# route_token() folds it into the engine's graph keys while ENABLED, so a
# new measurement recaptures through the existing rebuild rule.
_STORE: Optional[Dict[str, Dict[str, Any]]] = None
_DIRTY = False
EPOCH = 0

# (decision, signature) -> (epoch, choice or None, preference): the hot
# path's decision cache, recomputed when the epoch moved.
_DECISION_CACHE: Dict[Tuple[str, str], Tuple[int, Optional[str], Any]] = {}


def _resolve_enabled() -> bool:
    mode = _oflags.autotune_mode()
    if mode is not None:
        return bool(mode)
    return bool(_flags.get_str("AUTOTUNE_DIR"))


ENABLED = _resolve_enabled()


def enable() -> None:
    """Turn the measured-cost layer on for this process (the runtime twin
    of ``TORCHEVAL_TPU_TORCH_AUTOTUNE=1``)."""
    global ENABLED, EPOCH
    with _LOCK:
        ENABLED = True
        EPOCH += 1
        _DECISION_CACHE.clear()


def disable() -> None:
    """Turn the layer off: the static heuristics decide again, and the
    route token stops carrying the store epoch."""
    global ENABLED
    with _LOCK:
        ENABLED = False
        _DECISION_CACHE.clear()


def enabled() -> bool:
    with _LOCK:
        return ENABLED


def probe_budget() -> int:
    """How many candidate timings one ``aot.warmup(autotune=True)`` call
    may run (``TORCHEVAL_TPU_TORCH_AUTOTUNE_PROBE_BUDGET``, default 8)."""
    return _flags.get_int("AUTOTUNE_PROBE_BUDGET")


def _library_version() -> str:
    from torcheval_tpu_torch.version import __version__

    return __version__


def _device_kind() -> str:
    from torcheval_tpu_torch.tools import roofline

    return roofline.current_device_kind()


# ---------------------------------------------------------------- store I/O
def store_path() -> Optional[str]:
    """Where the store persists, or ``None`` when no directory is
    configured (the store then lives in memory and dies with the
    process)."""
    directory = _flags.get_str("AUTOTUNE_DIR")
    if not directory:
        return None
    return os.path.join(directory, _STORE_BASENAME)


def _fsync_write(path: str, data: bytes) -> None:
    """tmp file + flush + fsync + atomic rename into ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        fh.write(data)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)


def _quarantine(path: str) -> None:
    for p in (path, path + ".sha256"):
        if os.path.exists(p):
            try:
                os.replace(p, p + ".corrupt")
            except OSError:  # pragma: no cover - concurrent cleanup
                pass


def _load_store() -> Dict[str, Dict[str, Any]]:
    """Read the persisted store, validating the SHA-256 sidecar before
    parsing; a torn or tampered file is quarantined (``*.corrupt``) and an
    empty store returned: a bad write costs measurements, never startup.
    Rows stamped by another version are dropped here."""
    path = store_path()
    if path is None or not os.path.exists(path):
        return {}
    try:
        with open(path, "rb") as fh:
            payload = fh.read()
        with open(path + ".sha256", "r", encoding="utf-8") as fh:
            expected = fh.read().strip()
        if hashlib.sha256(payload).hexdigest() != expected:
            _quarantine(path)
            return {}
        doc = json.loads(payload.decode("utf-8"))
        rows = doc.get("rows", {})
        if not isinstance(rows, dict):
            _quarantine(path)
            return {}
    except (OSError, ValueError, UnicodeDecodeError, AttributeError):
        _quarantine(path)
        return {}
    version = _library_version()
    return {
        key: row
        for key, row in rows.items()
        if isinstance(row, dict) and row.get("version") == version
    }


def _store() -> Dict[str, Dict[str, Any]]:
    global _STORE
    if _STORE is None:
        _STORE = _load_store()
    return _STORE


def flush() -> Optional[str]:
    """Persist the store now (atomic write + sidecar): the path written,
    or ``None`` when there is nothing to do (no directory, or no change
    since the last flush)."""
    global _DIRTY
    with _LOCK:
        path = store_path()
        if path is None or not _DIRTY or _STORE is None:
            return None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        payload = json.dumps(
            {"version": _library_version(), "rows": _STORE},
            sort_keys=True,
            indent=1,
        ).encode("utf-8")
        _fsync_write(path, payload)
        _fsync_write(
            path + ".sha256",
            (hashlib.sha256(payload).hexdigest() + "\n").encode("utf-8"),
        )
        _DIRTY = False
        return path


def clear() -> None:
    """Drop the in-memory store and the decision cache (the persisted
    file stays)."""
    global _STORE, _DIRTY, EPOCH
    with _LOCK:
        _STORE = None
        _DIRTY = False
        EPOCH += 1
        _DECISION_CACHE.clear()


def store_rows() -> List[Dict[str, Any]]:
    """A copy of every live row (loaded, and recorded in this process)."""
    with _LOCK:
        return [dict(row) for row in _store().values()]


# ------------------------------------------------------------- row stamping
def _context_token(decision: str) -> List[str]:
    """The route-token context a measurement is valid under, with the
    decided element masked and the trailing store epoch dropped (stamping
    the epoch would unbind every row on every write)."""
    from torcheval_tpu_torch.ops import _mega_plan

    token = list(_mega_plan.route_token())[:_TOKEN_LEN]
    idx = _TOKEN_INDEX.get(decision)
    if idx is not None:
        token[idx] = _MASK
    return [str(t) for t in token]


def batch_signature(args: Any) -> str:
    """A stable 16-hex digest of the positional batch's shapes and dtypes:
    the store's shape-bucket key.  Walks nested tuples, lists and dicts;
    a leaf without a shape contributes its type name, so values never
    matter."""
    leaves: List[str] = []

    def _walk(x: Any) -> None:
        if isinstance(x, (tuple, list)):
            for item in x:
                _walk(item)
            return
        if isinstance(x, Mapping):
            for key in sorted(x, key=str):
                leaves.append(str(key))
                _walk(x[key])
            return
        shape = getattr(x, "shape", None)
        dtype = getattr(x, "dtype", None)
        if shape is not None:
            leaves.append(f"{tuple(shape)}:{str(dtype).replace('torch.', '')}")
        else:
            leaves.append(type(x).__name__)

    _walk(args)
    digest = hashlib.sha256("|".join(leaves).encode("utf-8")).hexdigest()
    return digest[:16]


def _row_key(decision: str, signature: str, site: str, choice: str, device: str) -> str:
    return f"{decision}|{signature}|{site}|{choice}|{device}"


def _put_row(
    *,
    decision: str,
    choice: str,
    signature: str,
    site: str,
    kind: str,
    seconds: float,
    nbytes: float = 0.0,
    flops: float = 0.0,
) -> None:
    global _DIRTY, EPOCH
    device = _device_kind()
    row = {
        "decision": decision,
        "choice": choice,
        "signature": signature,
        "site": site,
        "kind": kind,
        "seconds": float(seconds),
        "bytes": float(nbytes),
        "flops": float(flops),
        "device_kind": device,
        "token": _context_token(decision),
        "version": _library_version(),
        "updated": time.time(),
    }
    with _LOCK:
        _store()[_row_key(decision, signature, site, choice, device)] = row
        _DIRTY = True
        EPOCH += 1
        _DECISION_CACHE.clear()


def record_measurement(
    decision: str,
    choice: str,
    signature: str,
    seconds: float,
    *,
    site: str = "race",
    nbytes: float = 0.0,
    flops: float = 0.0,
) -> None:
    """Store one measured cost row: the ``aot.warmup(autotune=True)`` feed
    (``site="race"``, the wall clock of one steady-state entry call under
    the forced candidate route, ending in a device sync)."""
    if decision not in DECISIONS:
        raise ValueError(f"unknown decision {decision!r}; expected one of {DECISIONS}")
    _put_row(
        decision=decision,
        choice=choice,
        signature=signature,
        site=site,
        kind="measured",
        seconds=seconds,
        nbytes=nbytes,
        flops=flops,
    )


# The program names a profile prices, mapped onto (decision, choice,
# site).  Scan-site programs are per block: observe_profile strips their
# leading block axis so scan rows share the per-step signature.
_PROGRAM_ROWS = {
    "mega_collection": ("megakernel", "mega", "collection"),
    "fused_collection": ("megakernel", "fused", "collection"),
    "mega_scan": ("megakernel", "mega", "scan"),
    "engine_scan": ("megakernel", "fused", "scan"),
}


class _Shape:
    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype):
        self.shape = shape
        self.dtype = dtype


def _strip_leading_axis(args: Any) -> Any:
    if isinstance(args, (tuple, list)):
        return tuple(_strip_leading_axis(x) for x in args)
    if isinstance(args, Mapping):
        return {k: _strip_leading_axis(v) for k, v in args.items()}
    shape = getattr(args, "shape", None)
    if shape is not None and len(shape) >= 1:
        return _Shape(tuple(shape)[1:], getattr(args, "dtype", None))
    return args


def observe_profile(program: str, batch_args: Any, profile: Mapping[str, Any]) -> None:
    """Turn one priced program profile (``bytes_accessed`` and ``flops``)
    into a cost row, its seconds the roofline's ``max(bytes / memory
    peak, flops / compute peak)`` for this card.  Only programs whose name
    maps onto a known decision contribute.  Its caller is
    ``telemetry.perfscope.profile_program``, while this layer is on."""
    mapped = _PROGRAM_ROWS.get(program)
    if mapped is None:
        return
    decision, choice, site = mapped
    args = batch_args[0] if isinstance(batch_args, tuple) and batch_args else batch_args
    if site == "scan":
        args = _strip_leading_axis(args)
    from torcheval_tpu_torch.tools import roofline

    peaks = roofline.device_peaks()
    nbytes = float(profile.get("bytes_accessed", 0.0) or 0.0)
    flops = float(profile.get("flops", 0.0) or 0.0)
    seconds = max(nbytes / (peaks["hbm_gbps"] * 1e9), flops / peaks["flops"])
    if seconds <= 0.0:
        return
    _put_row(
        decision=decision,
        choice=choice,
        signature=batch_signature(args),
        site=site,
        kind="priced",
        seconds=seconds,
        nbytes=nbytes,
        flops=flops,
    )


# ---------------------------------------------------------------- decisions
def _binding_rows(decision: str, signature: str) -> List[Dict[str, Any]]:
    """Rows that may decide (decision, signature) in THIS process: the
    same card, the same masked route-token context, the same version."""
    device = _device_kind()
    context = _context_token(decision)
    return [
        row
        for row in _store().values()
        if row.get("decision") == decision
        and row.get("signature") == signature
        and row.get("device_kind") == device
        and row.get("token") == context
    ]


def preference(decision: str, signature: str) -> Optional[Dict[str, Any]]:
    """The measured verdict for one (decision, shape bucket): the cheapest
    choice at the most trustworthy site where AT LEAST TWO choices have
    rows, or ``None`` when the store cannot rank it (unmeasured,
    one-sided, or context drift).  The dict carries ``choice``,
    ``seconds``, ``alt_choice``, ``alt_seconds``, ``site`` and ``kind``."""
    with _LOCK:
        rows = _binding_rows(decision, signature)
    for site in _SITE_RANK:
        by_choice: Dict[str, Dict[str, Any]] = {}
        for row in rows:
            if row.get("site") != site:
                continue
            prior = by_choice.get(row["choice"])
            if prior is None or row["seconds"] < prior["seconds"]:
                by_choice[row["choice"]] = row
        if len(by_choice) < 2:
            continue
        best, runner_up = sorted(by_choice.values(), key=lambda r: r["seconds"])[:2]
        return {
            "choice": best["choice"],
            "seconds": best["seconds"],
            "alt_choice": runner_up["choice"],
            "alt_seconds": runner_up["seconds"],
            "site": site,
            "kind": best["kind"],
        }
    return None


def _explicit(decision: str) -> Optional[str]:
    """The choice an explicitly set route flag pins for ``decision``, or
    ``None``: ``MEGAKERNEL`` pins ``megakernel``, ``CM_ROW_CHUNK`` pins
    ``cm_row_chunk``, ``RANK_SKETCH`` pins ``rank_sketch``."""
    if decision == "megakernel":
        mode = _oflags.megakernel_mode()
        return None if mode is None else ("mega" if mode else "fused")
    if decision == "cm_row_chunk":
        raw = _flags.raw("CM_ROW_CHUNK")
        return None if raw is None or not raw.strip() else str(_oflags.cm_row_chunk())
    if decision == "rank_sketch":
        mode = _oflags.rank_sketch_mode()
        return None if mode is None else ("sketch" if mode else "sort")
    return None


def decide(decision: str, signature: str, default: str) -> str:
    """The hot-path consumer: the choice for (decision, signature).  An
    explicitly set route flag wins; else the measured pick; else
    ``default`` (the static heuristic's choice).  A dict lookup when the
    decision cache is warm for the current epoch; the preference scan
    runs once per (decision, signature, epoch), and a
    ``RouteDecisionEvent`` is emitted on exactly those recomputes."""
    pinned = _explicit(decision)
    if pinned is not None:
        return pinned
    key = (decision, signature)
    with _LOCK:
        cached = _DECISION_CACHE.get(key)
        if cached is not None and cached[0] == EPOCH:
            return cached[1] if cached[1] is not None else default
        pref = preference(decision, signature)
        choice = pref["choice"] if pref is not None else None
        _DECISION_CACHE[key] = (EPOCH, choice, pref)
    _emit_decision(decision, signature, pref, default)
    return choice if choice is not None else default


def _emit_decision(
    decision: str, signature: str, pref: Optional[Dict[str, Any]], default: str
) -> None:
    from torcheval_tpu_torch.telemetry import events as _events

    if not _events.ENABLED:
        return
    if pref is None:
        _events.record_route_decision(
            decision=decision,
            route=default,
            verdict="unmeasured",
            signature=signature,
            seconds=0.0,
            alt_seconds=0.0,
            source="static",
        )
        return
    _events.record_route_decision(
        decision=decision,
        route=pref["choice"],
        verdict="measured",
        signature=signature,
        seconds=pref["seconds"],
        alt_seconds=pref["alt_seconds"],
        source=f"{pref['kind']}-{pref['site']}",
    )


def measured_crossover(decision: str) -> Optional[Dict[str, Any]]:
    """The best measured comparison for ``decision`` across every shape
    bucket: the preference of the bucket with the largest measured margin,
    plus its ``signature``, or ``None`` when no bucket has two binding
    choices."""
    with _LOCK:
        signatures = {
            row["signature"] for row in _store().values() if row.get("decision") == decision
        }
        best: Optional[Dict[str, Any]] = None
        for signature in sorted(signatures):
            pref = preference(decision, signature)
            if pref is None:
                continue
            pref = dict(pref, signature=signature)
            if best is None or (
                pref["alt_seconds"] - pref["seconds"] > best["alt_seconds"] - best["seconds"]
            ):
                best = pref
        return best
