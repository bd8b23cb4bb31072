"""What a run refuses: JAX in the process, a flag of the port set away
from its default, and a plain fallback on the card."""

from __future__ import annotations

import sys
from typing import Iterable, List

# Compared with each loaded module's top-level name, whole: the port's
# package name begins with the JAX package's and is allowed.
FORBIDDEN = ("jax", "jaxlib", "flax", "torcheval_tpu")


def forbidden_modules(names: Iterable[str] = ()) -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`
    (``sys.modules`` unless ``names`` is given)."""
    names = list(names) or list(sys.modules)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def non_default_flags() -> dict:
    """The port's flags set away from their defaults."""
    from torcheval_tpu_torch import _flags

    return _flags.snapshot_non_default()


def plain_calls() -> dict:
    """Calls of a kernel's plain version so far in this process."""
    from torcheval_tpu_torch.ops import _build

    return {k: v for k, v in _build.PLAIN_CALLS.items() if v}
