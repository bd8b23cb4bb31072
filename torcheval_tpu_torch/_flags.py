"""The port's environment flags, every one read through :func:`get`.

The port's own copy of the slice of ``torcheval_tpu/_flags.py`` it reads,
under the prefix ``TORCHEVAL_TPU_TORCH_`` so the two packages never share
a switch.  ``DISABLE_PALLAS`` has no counterpart here: in the port it
would send CUDA tensors to the plain versions, a switch that hides the
kernel.  Call-time flags re-read the environment on every :func:`get`;
``TELEMETRY`` is read once by ``telemetry/events.py`` at import.
Integer flags are read through :func:`get_int`.
"""

from __future__ import annotations

import os
from typing import Dict, Tuple

PREFIX = "TORCHEVAL_TPU_TORCH_"

TRUTHY = ("1", "true", "yes", "on")

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
