"""The port's environment flags, every one read through :func:`get`.

The port's own copy of the slice of ``torcheval_tpu/_flags.py`` it reads,
under the prefix ``TORCHEVAL_TPU_TORCH_`` so the two packages never share
a switch.  ``DISABLE_PALLAS`` has no counterpart here: in the port it
would send CUDA tensors to the plain versions, a switch that hides the
kernel.  Call-time flags re-read the environment on every :func:`get`;
``TELEMETRY`` is read once by ``telemetry/events.py`` at import.
Integer flags are read through :func:`get_int`, tri-state flags (forced
on, forced off, or unset for auto) through :func:`get_tristate`.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

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
    "TELEMETRY": "Record a span for every update/compute (read at import).",
}


# name -> (default, one-line doc); every integer flag is a power of two,
# and a value that does not parse as one reads as the default.
INT_FLAGS: Dict[str, Tuple[int, str]] = {
    "CM_ROW_CHUNK": (
        4096,
        "Row-tile height of the one-hot matmul confusion-matrix route; the "
        "result is bit-identical at every chunking (read per call).",
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
    default = INT_FLAGS[name][0]
    try:
        value = int(os.environ.get(PREFIX + name, "").strip())
    except ValueError:
        return default
    return value if value > 0 and value & (value - 1) == 0 else default


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
