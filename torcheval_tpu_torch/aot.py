"""Ahead-of-time warmup for the metric update hot path (the port of
``torcheval_tpu/aot.py``).

A stream's first block of each signature pays for a CUDA graph capture
(``engine/scan.py``), and a process's first launch builds and loads the
kernels (``ops/_build.py``).  Bucketing (``metrics/_bucket.py``) keeps
the signatures to O(log max_batch); :func:`warmup` moves those costs off
the measured path by running a representative batch through every
reachable bucket size before the real stream starts.

The JAX package pairs this with ``TORCHEVAL_TPU_CACHE_DIR``, a
persistent compilation cache that lets the next process skip its
compiles.  The port has no counterpart: its kernels build once into
``ops/_build/`` (keyed by a hash of the sources), and a captured graph
lives only in its process.

Capture accounting lives in :mod:`torcheval_tpu_torch._stats`:
:func:`trace_count` after a warmed stream shows zero additional captures.
"""

from typing import Any, Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

from torcheval_tpu_torch._stats import (  # noqa: F401  (re-exported)
    reset_trace_count,
    trace_count,
    trace_counts,
)
from torcheval_tpu_torch.metrics._bucket import bucket_sizes

__all__ = [
    "warmup",
    "trace_count",
    "trace_counts",
    "reset_trace_count",
    "bucket_sizes",
]


def _tile_to(a: Any, n: int) -> Any:
    """A length-``n`` batch with the same trailing shape and dtype as
    ``a`` (a tensor stays a tensor on its device, anything else becomes
    numpy), cycling ``a``'s rows: real rows keep class indices in range
    for the update path's value checks."""
    if not isinstance(a, torch.Tensor):
        a = np.asarray(a)
    if a.shape[0] == n:
        return a
    reps = -(-n // max(a.shape[0], 1))
    if isinstance(a, torch.Tensor):
        return torch.cat([a] * reps)[:n]
    return np.concatenate([a] * reps, axis=0)[:n]


def warmup(
    metric_or_collection: Any,
    example_batch: Sequence[Any],
    *,
    max_batch: Optional[int] = None,
    sizes: Optional[Iterable[int]] = None,
    fused: Optional[bool] = None,
    autotune: bool = False,
) -> Tuple[int, ...]:
    """Run every update program a ragged evaluation stream can reach, so
    the stream itself captures and builds nothing.

    ``example_batch`` is one representative update's positional args
    (e.g. ``(input, target)``); its leading dim seeds the size sweep.
    ``max_batch`` extends the sweep to the largest batch the stream will
    produce (default: the example's size); ``sizes`` overrides the sweep.
    For a bucketed ``MetricCollection`` the swept sizes are the reachable
    bucket sizes.  ``fused`` picks the entry point for collections
    (default: ``fused_update`` when its members allow it); plain metrics
    warm ``update``.  State is snapshotted before and restored after, so
    warmup is invisible to the metric values.  Returns the batch sizes
    warmed.

    An :class:`~torcheval_tpu_torch.engine.Evaluator` delegates to its own
    :meth:`~torcheval_tpu_torch.engine.Evaluator.warmup`, which captures
    the block graph of every swept bucket (``fused`` does not apply).

    ``autotune=True`` (the JAX package's route racing) needs the
    measured-cost store, ``routing_autotune``, which the port does not
    have yet (ROADMAP queue 1 item 8): it raises ``NotImplementedError``.
    """
    from torcheval_tpu_torch.engine import Evaluator
    from torcheval_tpu_torch.metrics.collection import MetricCollection

    if autotune:
        raise NotImplementedError(
            "aot.warmup(autotune=True) races routes through routing_autotune, which "
            "the port does not have yet (ROADMAP queue 1 item 8)."
        )
    if isinstance(metric_or_collection, Evaluator):
        return metric_or_collection.warmup(example_batch, max_batch=max_batch, sizes=sizes)

    obj = metric_or_collection
    arrays = list(example_batch)
    if not arrays:
        raise ValueError("example_batch must contain at least one array.")
    n = arrays[0].shape[0]
    top = int(max_batch) if max_batch is not None else n

    is_collection = isinstance(obj, MetricCollection)
    if sizes is not None:
        sweep = tuple(int(s) for s in sizes)
    elif is_collection and obj._bucket:
        sweep = bucket_sizes(top, min_bucket=obj._min_bucket)
    else:
        sweep = (top,)

    if is_collection:
        if fused is None:
            try:
                obj._check_fusable()
                fused = True
            except ValueError:
                fused = False
        entry = obj.fused_update if fused else obj.update
    else:
        entry = obj.update

    # state_dict() hands back copies, so the snapshot survives donated
    # warmup updates untouched.
    snapshot = obj.state_dict()
    try:
        for b in sweep:
            entry(*(_tile_to(a, b) for a in arrays))
    finally:
        obj.load_state_dict(snapshot)
    return tuple(sweep)
