"""Update-accumulate for counter-state metrics (the port's slice of
``torcheval_tpu/metrics/_fuse.py``: :func:`accumulate` only).

The JAX package folds a metric's kernel and every ``state + delta`` into
one jitted program, with the states donated.  PyTorch runs eagerly, so
here it is what it says: run the kernel, then add each delta into its
state.  The sums are new tensors that the caller rebinds, so no state is
written in place (``metric.py``).  With the telemetry bus on, each call is
a ``dispatch`` span named after the kernel, as in the JAX package: host
time, no device synchronisation.
"""

import time
from typing import Tuple

import torch

from torcheval_tpu_torch.telemetry import events as _telemetry


def accumulate(
    kernel,
    states: Tuple[torch.Tensor, ...],
    *args,
    statics: tuple = (),
    grow: bool = False,
    mask=None,
) -> Tuple[torch.Tensor, ...]:
    """Run ``kernel(*args, *statics)`` and return each state plus its
    delta.  ``grow=True`` gives the per-output regression states'
    semantics: a scalar state meeting a vector delta is replaced by it,
    not broadcast into it (the first 2-D update).  ``mask`` (a validity
    tensor, or ``None``) is passed to the kernel as a trailing ``mask=``
    keyword; only pass it to mask-aware kernels."""
    if not _telemetry.ENABLED:
        return _accumulate(kernel, states, args, statics, grow, mask)
    t0 = time.monotonic()
    out = _accumulate(kernel, states, args, statics, grow, mask)
    _telemetry.record_span(
        "dispatch",
        getattr(kernel, "__name__", str(kernel)),
        time.monotonic() - t0,
        sum(s.numel() * s.element_size() for s in out),
    )
    return out


def _accumulate(kernel, states, args, statics, grow, mask) -> Tuple[torch.Tensor, ...]:
    if mask is None:
        deltas = kernel(*args, *statics)
    else:
        deltas = kernel(*args, *statics, mask=mask)
    if not isinstance(deltas, tuple):
        deltas = (deltas,)
    return tuple(
        d if grow and s.dim() == 0 and d.dim() == 1 else s + d
        for s, d in zip(states, deltas)
    )


def on_device(device: torch.device, *values):
    """Each of ``values`` as a tensor on ``device`` (a class metric's
    inputs go where its states live); ``None`` stays ``None``."""
    return tuple(
        None if v is None else torch.as_tensor(v, device=device) for v in values
    )
