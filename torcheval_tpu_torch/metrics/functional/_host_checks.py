"""Switches for the data-dependent (value) validation of inputs.

The port's slice of ``torcheval_tpu/metrics/functional/_host_checks.py``.
A value check reads numbers back from the device, which waits for it; the
switches let a throughput-critical loop on pre-validated data skip that.
"""

from contextlib import contextmanager
from contextvars import ContextVar

from torcheval_tpu_torch import _flags

_SKIP_CHECKS: ContextVar = ContextVar(
    "torcheval_tpu_torch_skip_value_checks", default=False
)


@contextmanager
def skip_value_checks():
    """Disable data-dependent (value) validation inside the block.  Shape
    and parameter validation still applies.  Process-wide:
    ``TORCHEVAL_TPU_TORCH_SKIP_VALUE_CHECKS=1``."""
    token = _SKIP_CHECKS.set(True)
    try:
        yield
    finally:
        _SKIP_CHECKS.reset(token)


def value_checks_enabled() -> bool:
    """False inside :func:`skip_value_checks` or when
    ``TORCHEVAL_TPU_TORCH_SKIP_VALUE_CHECKS`` is truthy (read per call)."""
    if _SKIP_CHECKS.get():
        return False
    return not _flags.get("SKIP_VALUE_CHECKS")


def all_concrete(*tensors) -> bool:
    """Always True: PyTorch runs eagerly, so every input's values can be
    read.  Kept so code ported from the JAX package, where this is False
    under tracing, reads the same."""
    return True
