"""Where functional inputs live, and the data-dependent (value) checks of
update inputs.

The port's slice of ``torcheval_tpu/metrics/functional/_host_checks.py``.
A value check reads numbers back from the device, which waits for it; the
helpers fuse all of a validation's reductions into ONE read back, and the
switches let a throughput-critical loop on pre-validated data skip it.
"""

from contextlib import contextmanager
from contextvars import ContextVar
from functools import reduce
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

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


def place_inputs(*values) -> Tuple[torch.Tensor, ...]:
    """The tensors a functional metric computes on.  A ``torch.Tensor``
    stays on its own device: the caller chose it.  Anything else (a numpy
    array, a list, a number) goes where the call's first tensor lies, or
    to the GPU when no argument is a tensor, as a metric built without
    ``device=`` does; with no GPU that raises, naming CPU tensors as the
    way to run on the CPU.  The port never picks the CPU on its own."""
    device = next((v.device for v in values if isinstance(v, torch.Tensor)), None)
    if device is None and not all(isinstance(v, torch.Tensor) for v in values):
        if not torch.cuda.is_available():
            raise RuntimeError(
                "torcheval_tpu_torch functional metrics place numpy arrays and "
                "lists on the GPU, but no CUDA device is available; pass CPU "
                "tensors (torch.as_tensor(x)) to run on the CPU."
            )
        device = torch.device("cuda")
    return tuple(
        v if isinstance(v, torch.Tensor) else torch.as_tensor(v, device=device)
        for v in values
    )


def to_host(*tensors: torch.Tensor) -> Tuple[np.ndarray, ...]:
    """numpy copies of ``tensors`` with ONE wait for the device: every copy
    is queued before the stream is synchronized once."""
    if all(t.device.type == "cpu" for t in tensors):
        return tuple(t.numpy() for t in tensors)
    host = [t.to("cpu", non_blocking=True) for t in tensors]
    for device in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.current_stream(device).synchronize()
    return tuple(h.numpy() for h in host)


def bounds(*tensors: torch.Tensor) -> np.ndarray:
    """``[min0, max0, min1, max1, ...]`` of the tensors with ONE read back,
    in their promoted dtype (float32 at least, float64 when an input is).
    Exact for integer class indices below 2^24.  Callers skip empty
    tensors themselves (their min does not exist)."""
    dtype = reduce(torch.promote_types, (t.dtype for t in tensors), torch.float32)
    stacked = torch.stack([m.to(dtype) for t in tensors for m in torch.aminmax(t)])
    return stacked.cpu().numpy()


def check_index_ranges(
    pairs: Sequence[Tuple[torch.Tensor, str]], upper: Optional[int]
) -> None:
    """Range-check several class-index tensors with one read back for all
    of them; raises for the first one outside ``[0, upper)``, in order
    (the JAX scatters drop such indices where torch's raise)."""
    if upper is None or not value_checks_enabled():
        return
    pairs = [(v, n) for v, n in pairs if v.numel()]
    if not pairs:
        return
    vals = bounds(*(v for v, _ in pairs))
    for i, (_, name) in enumerate(pairs):
        lo, hi = vals[2 * i], vals[2 * i + 1]
        if lo < 0 or hi >= upper:
            raise ValueError(
                f"{name} values should be in [0, {upper}), got min "
                f"{int(lo)} max {int(hi)}."
            )
