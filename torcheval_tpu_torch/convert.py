"""Carry a JAX metric's state into the port.

``state_from_jax`` takes a ``torcheval_tpu`` metric's ``state_dict()``
with every array leaf passed through ``np.asarray`` (so this module never
sees a JAX type) and returns the tensors a port metric's
``load_state_dict`` takes: a metric's buffers continue in the port where
the JAX metric left them.

    numpy_state = {k: [np.asarray(a) for a in v] if isinstance(v, list)
                   else np.asarray(v) for k, v in jax_metric.state_dict().items()}
    port_metric.load_state_dict(state_from_jax(numpy_state))

A windowed metric's ``state_dict()`` carries its ring bookkeeping (capacity,
cursor, fill level and counters) under ``"window_bookkeeping"`` as an int64
array, in the same layout in both packages, so a JAX window continues
mid-wrap in the port.

A JAX ``MetricCollection.state_dict()`` is a flat mapping too, keyed
``"name/state"`` and, for slice clones, ``"name@k/state"``; it loads into
the port's collection the same way:

    port_collection.load_state_dict(state_from_jax(
        {k: np.asarray(v) for k, v in jax_collection.state_dict().items()}))

``params_from_jax`` does the same for the flagship model's weights.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Dict, List, Union

import numpy as np
import torch

State = Union[torch.Tensor, List[torch.Tensor], Dict[Any, torch.Tensor]]


def _tensor(value: Any) -> torch.Tensor:
    if not isinstance(value, (np.ndarray, np.generic)):
        raise TypeError(
            f"state leaves must be numpy arrays (np.asarray of the JAX "
            f"arrays), got {type(value).__name__}"
        )
    # A copy: the tensor owns its memory, whatever the caller does next.
    return torch.from_numpy(np.array(value, copy=True))


def state_from_jax(numpy_state: Dict[str, Any]) -> Dict[str, State]:
    """Map a numpy'd JAX ``state_dict()`` to tensors on the CPU; the
    metric's ``load_state_dict`` moves them to its device.  dtypes carry
    over as they are (JAX runs 32-bit: float32 scores, int32 labels)."""
    out: Dict[str, State] = {}
    for name, value in numpy_state.items():
        if isinstance(value, (list, tuple, deque)):
            out[name] = [_tensor(v) for v in value]
        elif isinstance(value, dict):
            out[name] = {k: _tensor(v) for k, v in value.items()}
        else:
            out[name] = _tensor(value)
    return out


def params_from_jax(numpy_params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Map the JAX flagship's parameter dict (``w1``, ``b1``, ``w2``,
    ``b2``, each passed through ``np.asarray``) to the ``state_dict`` of
    :class:`torcheval_tpu_torch.flagship.FlagshipMLP`.  The JAX code
    multiplies ``x @ w`` with ``w`` as ``(in, out)``; ``nn.Linear`` keeps
    ``(out, in)``, so the weights are transposed."""
    p = {name: _tensor(value) for name, value in numpy_params.items()}
    return {
        "fc1.weight": p["w1"].T.contiguous(),
        "fc1.bias": p["b1"],
        "fc2.weight": p["w2"].T.contiguous(),
        "fc2.bias": p["b2"],
    }
