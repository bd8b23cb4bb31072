"""The port's environment flags, every one read through :func:`get`.

The port's own copy of the slice of ``torcheval_tpu/_flags.py`` it reads,
under the prefix ``TORCHEVAL_TPU_TORCH_`` so the two packages never share
a switch.  ``DISABLE_PALLAS`` has no counterpart here: in the port it
would send CUDA tensors to the plain versions, a switch that hides the
kernel.  Call-time flags re-read the environment on every :func:`get`;
the telemetry, trace, flight-recorder, data-health and fault-plan switches
are read once by their own modules at import (each module's ``enable()``
turns it on later).  Integer flags are read through :func:`get_int`,
tri-state flags (forced on, forced off, or unset for auto) through
:func:`get_tristate`, the path flags through :func:`get_str` and the
fault plan through :func:`get_json`, and :func:`raw` says whether one is
set at all; :func:`overridden` sets one for a
block (the route races of ``aot.warmup(autotune=True)``).  :func:`snapshot_non_default` lists
every flag set away from its default (the flight recorder writes it into
each bundle).
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any, Dict, Iterator, Optional, Tuple

PREFIX = "TORCHEVAL_TPU_TORCH_"

TRUTHY = ("1", "true", "yes", "on")
FALSY = ("0", "false", "no", "off")

# name -> one-line doc; every flag is a boolean, default off.
FLAGS: Dict[str, str] = {
    "DISABLE_USTAT": (
        "Route switch: keep the sort path for AUROC rows the rank-sum "
        "(ustat) route would take (read per call)."
    ),
    "SKIP_VALUE_CHECKS": (
        "Skip the data-dependent validation of update and pinned-route "
        "inputs (read per call)."
    ),
    "TELEMETRY": "Turn the telemetry event bus on (read at import).",
    "TELEMETRY_ANNOTATE": (
        "Open a torch.profiler.record_function range at each span hook site (members' "
        "update/compute, value checks, read backs, compute stages), so the spans show in "
        "a profiler trace beside the kernels, with or without the bus (read at import; "
        "telemetry.events.annotate() at run time)."
    ),
    "TRACE": (
        "Turn causal tracing on: every event carries trace and span ids "
        "(read at import)."
    ),
    "FLIGHTREC": (
        "Turn the flight recorder on: keep the last events and write a "
        "post-mortem bundle when a fault fires or corrupt data raises "
        "(read at import)."
    ),
    "DATA_HEALTH": (
        "Turn the data-health monitor on for MetricCollection.fused_update "
        "(read at import)."
    ),
    "DATA_HEALTH_RAISE": (
        "Raise DataCorruptionError on NaN, Inf or out-of-range labels, after "
        "the batch is applied (read at import)."
    ),
    "PERFSCOPE": (
        "Turn perfscope on: price each hot-path program once a signature and "
        "evaluate the installed SLO rules (read at import)."
    ),
}


# name -> (default, rule, one-line doc); a value that does not parse as an
# integer, or breaks its rule ("power_of_two" or "positive"), reads as the
# default, except under the rule "strict_positive", where it raises.
INT_FLAGS: Dict[str, Tuple[int, str, str]] = {
    "CM_ROW_CHUNK": (
        4096,
        "power_of_two",
        "Row-tile height of the one-hot matmul confusion-matrix route; the "
        "result is bit-identical at every chunking (read per call).",
    ),
    "TELEMETRY_CAPACITY": (
        4096,
        "positive",
        "Capacity of the bounded telemetry event ring (read at import).",
    ),
    "FLIGHTREC_LAST": (
        256,
        "positive",
        "How many of the newest events the flight recorder keeps for a "
        "bundle (read at import).",
    ),
    "COMPILE_CACHE_CAP": (
        256,
        "positive",
        "Capacity of each LRU program cache (parallel/_compile_cache.py), "
        "e.g. the engine's captured CUDA graphs, one a block signature "
        "(read when a cache is built).",
    ),
    "AUTOTUNE_PROBE_BUDGET": (
        8,
        "strict_positive",
        "How many candidate timings one aot.warmup(autotune=True) call may run "
        "(routing_autotune.probe_budget); anything but a positive integer raises "
        "(read per call).",
    ),
    "PERFSCOPE_SLO_EVERY": (
        8,
        "positive",
        "Dispatched engine blocks between two evaluations of perfscope's SLO "
        "rules (read at import).",
    ),
    "SERVE_VNODES": (
        64,
        "strict_positive",
        "Virtual nodes a host on the serve cluster's consistent-hash placement "
        "ring (serve/placement.py); more vnodes smooth the tenant load a host "
        "at O(hosts x vnodes) ring-build cost; anything but a positive integer "
        "raises (read when a ServeCluster is built).",
    ),
    "SERVE_ROUTE_WINDOW": (
        64,
        "strict_positive",
        "A tenant's in-flight window of cross-host routed batches "
        "(serve/cluster.py): a sender with this many unacked batches sheds "
        "locally instead of piling more onto a backlogged owner; anything but "
        "a positive integer raises (read when a ServeCluster is built).",
    ),
    "SERVE_HEARTBEAT_MS": (
        1000,
        "strict_positive",
        "Serve-cluster heartbeat / gossip period (milliseconds); a host is "
        "declared dead after 5 missed heartbeats and the ring repairs around "
        "it; anything but a positive integer raises (read when a ServeCluster "
        "is built).",
    ),
    "KV_TIMEOUT_MS": (
        600_000,
        "strict_positive",
        "Per-message wait budget (milliseconds) of the torch.distributed "
        "group's store collectives and point-to-point receives; anything but "
        "a positive integer raises, so a mistyped deployment fails loudly "
        "(read per call).",
    ),
}


# name -> one-line doc; unset or empty reads as None.
STR_FLAGS: Dict[str, str] = {
    "FLIGHTREC_DIR": (
        "Directory the flight recorder writes its bundles under (default "
        "./flightrec; read at import)."
    ),
    "SERVE_SPILL_DIR": (
        "Default directory EvalService spills idle tenant sessions into "
        "(EvalService(spill_dir=...) outranks it); unset, spill is off unless "
        "a directory is passed (read at construction)."
    ),
    "AUTOTUNE_DIR": (
        "Directory of the measured route-cost store "
        "(torcheval_tpu_torch_route_costs.json); unset keeps the store in memory "
        "and leaves the AUTOTUNE auto mode off (read per call)."
    ),
}


# name -> one-line doc; parsed as JSON, and a value that is not JSON raises.
JSON_FLAGS: Dict[str, str] = {
    "FAULT_PLAN": (
        "JSON fault-injection plan installed at import "
        "(resilience.faults.install_from_env)."
    ),
}


# name -> one-line doc; truthy forces on, falsy forces off, anything else
# (unset included) reads as None: auto.
TRISTATE_FLAGS: Dict[str, str] = {
    "MEGAKERNEL": (
        "Route switch of MetricCollection.fused_update: truthy sends every "
        "supported member through the one-pass collection kernel on any "
        "device, falsy keeps each member on its own path, unset takes the "
        "kernel when the states live on a GPU and at least two members are "
        "supported (read per call)."
    ),
    "RANK_SKETCH": (
        "State layout of BinaryAUROC, BinaryAUPRC and MulticlassAUROC built "
        "without sketch=: truthy gives the fixed-size rank-sketch counts, "
        "anything else the exact sample buffers (read at construction; the "
        "engine's route token carries it). It chooses a layout, never a "
        "plain version for a GPU tensor."
    ),
    "AUTOTUNE": (
        "The measured route-cost layer (routing_autotune): truthy on, falsy off "
        "(and aot.warmup(autotune=True) races nothing), unset on exactly when "
        "AUTOTUNE_DIR names a directory (read at import; enable() / disable() "
        "flip it later). An explicit route flag always outranks a measured pick."
    ),
    "TENANT_METERING": (
        "The serve plane's per-tenant ledger (serve/metering.py): truthy on at "
        "import, falsy off, unset off until the first EvalService is built, "
        "then on (metering.enable() / disable() outrank it)."
    ),
}


def get(name: str) -> bool:
    """Read ``TORCHEVAL_TPU_TORCH_<name>`` now: truthy strings are True."""
    if name not in FLAGS:
        raise KeyError(f"unknown flag {name!r}; known: {sorted(FLAGS)}")
    return os.environ.get(PREFIX + name, "").strip().lower() in TRUTHY


def raw(name: str) -> Optional[str]:
    """The raw string of ``TORCHEVAL_TPU_TORCH_<name>``, or ``None`` when
    unset: whether a flag is set at all, for the callers that let an
    explicit setting outrank a measured pick (``routing_autotune``)."""
    _check_known(name)
    return os.environ.get(PREFIX + name)


def _check_known(name: str) -> None:
    if not any(name in table for table in (
            FLAGS, INT_FLAGS, STR_FLAGS, JSON_FLAGS, TRISTATE_FLAGS)):
        raise KeyError(f"unknown flag {name!r}")


def get_int(name: str) -> int:
    """Read the integer flag ``TORCHEVAL_TPU_TORCH_<name>`` now; unset gives
    its default, and so does an invalid value, except under the rule
    ``"strict_positive"``, where it raises ``ValueError``."""
    if name not in INT_FLAGS:
        raise KeyError(f"unknown integer flag {name!r}; known: {sorted(INT_FLAGS)}")
    return _parse_int(name, os.environ.get(PREFIX + name))


def _parse_int(name: str, raw: Optional[str]) -> int:
    default, rule, _ = INT_FLAGS[name]
    if raw is None or not raw.strip():
        return default
    try:
        value = int(raw.strip())
    except ValueError:
        value = 0
    if value <= 0 or (rule == "power_of_two" and value & (value - 1)):
        if rule == "strict_positive":
            raise ValueError(
                f"{PREFIX}{name} must be a positive integer, got {raw!r}"
            )
        return default
    return value


def get_str(name: str) -> Optional[str]:
    """Read the string flag ``TORCHEVAL_TPU_TORCH_<name>`` now; unset or
    blank gives None."""
    if name not in STR_FLAGS:
        raise KeyError(f"unknown string flag {name!r}; known: {sorted(STR_FLAGS)}")
    raw = os.environ.get(PREFIX + name)
    return raw if raw and raw.strip() else None


def get_json(name: str) -> Any:
    """Read the JSON flag ``TORCHEVAL_TPU_TORCH_<name>`` now; unset or blank
    gives None, a value that is not JSON raises ``ValueError``."""
    if name not in JSON_FLAGS:
        raise KeyError(f"unknown JSON flag {name!r}; known: {sorted(JSON_FLAGS)}")
    return _parse_json(name, os.environ.get(PREFIX + name))


def _parse_json(name: str, raw: Optional[str]) -> Any:
    if raw is None or not raw.strip():
        return None
    try:
        return json.loads(raw.strip())
    except json.JSONDecodeError as exc:
        raise ValueError(f"{PREFIX}{name} is not valid JSON: {exc}") from exc


def get_tristate(name: str) -> Optional[bool]:
    """Read the tri-state flag ``TORCHEVAL_TPU_TORCH_<name>`` now: True
    when truthy, False when falsy, None (auto) otherwise."""
    if name not in TRISTATE_FLAGS:
        raise KeyError(
            f"unknown tri-state flag {name!r}; known: {sorted(TRISTATE_FLAGS)}"
        )
    raw = os.environ.get(PREFIX + name, "").strip().lower()
    if raw in TRUTHY:
        return True
    if raw in FALSY:
        return False
    return None


@contextlib.contextmanager
def overridden(name: str, raw: Optional[str]) -> Iterator[None]:
    """Set ``TORCHEVAL_TPU_TORCH_<name>`` to ``raw`` (``None``: unset) for
    the enclosed block, then put back what was there: how a route race
    forces each candidate through the flag a user would pin."""
    _check_known(name)
    env = PREFIX + name
    before = os.environ.get(env)
    try:
        if raw is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = raw
        yield
    finally:
        if before is None:
            os.environ.pop(env, None)
        else:
            os.environ[env] = before


def snapshot_non_default() -> Dict[str, Any]:
    """Env name -> parsed value for every flag set away from its default
    (the flight recorder's ``flags`` field).  Never raises: a value its
    flag would reject is reported as ``{"raw": <string>, "invalid": True}``."""
    out: Dict[str, Any] = {}
    for name in (*FLAGS, *INT_FLAGS, *TRISTATE_FLAGS, *STR_FLAGS, *JSON_FLAGS):
        env = PREFIX + name
        raw = os.environ.get(env)
        if raw is None:
            continue
        if name in FLAGS:
            value, default = raw.strip().lower() in TRUTHY, False
        elif name in INT_FLAGS:
            try:
                value = _parse_int(name, raw)
            except ValueError:
                out[env] = {"raw": raw, "invalid": True}
                continue
            default = INT_FLAGS[name][0]
        elif name in TRISTATE_FLAGS:
            value, default = get_tristate(name), None
        elif name in STR_FLAGS:
            value, default = get_str(name), None
        else:
            try:
                value = _parse_json(name, raw)
            except ValueError:
                out[env] = {"raw": raw, "invalid": True}
                continue
            default = None
        if value != default:
            out[env] = value
    return out
