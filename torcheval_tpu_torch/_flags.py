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
:func:`get_tristate`, the one path flag through :func:`get_str` and the
fault plan through :func:`get_json`.  :func:`snapshot_non_default` lists
every flag set away from its default (the flight recorder writes it into
each bundle).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

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
        "Also run each update/compute span under torch.profiler.record_function, "
        "so the spans show in a profiler trace beside the kernels (read at import)."
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
}


# name -> (default, rule, one-line doc); a value that does not parse as an
# integer, or breaks its rule ("power_of_two" or "positive"), reads as the
# default.
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
}


# name -> one-line doc; unset or empty reads as None.
STR_FLAGS: Dict[str, str] = {
    "FLIGHTREC_DIR": (
        "Directory the flight recorder writes its bundles under (default "
        "./flightrec; read at import)."
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
}


def get(name: str) -> bool:
    """Read ``TORCHEVAL_TPU_TORCH_<name>`` now: truthy strings are True."""
    if name not in FLAGS:
        raise KeyError(f"unknown flag {name!r}; known: {sorted(FLAGS)}")
    return os.environ.get(PREFIX + name, "").strip().lower() in TRUTHY


def get_int(name: str) -> int:
    """Read the integer flag ``TORCHEVAL_TPU_TORCH_<name>`` now; unset or
    invalid (not a power of two) gives its default."""
    if name not in INT_FLAGS:
        raise KeyError(f"unknown integer flag {name!r}; known: {sorted(INT_FLAGS)}")
    return _parse_int(name, os.environ.get(PREFIX + name))


def _parse_int(name: str, raw: Optional[str]) -> int:
    default, rule, _ = INT_FLAGS[name]
    try:
        value = int((raw or "").strip())
    except ValueError:
        return default
    if value <= 0 or (rule == "power_of_two" and value & (value - 1)):
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
            value, default = _parse_int(name, raw), INT_FLAGS[name][0]
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
