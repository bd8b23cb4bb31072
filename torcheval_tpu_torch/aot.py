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

    ``autotune=True`` also RACES the top-2 candidates of each routing
    decision that is a real choice at the warmed shape, and records the
    wall-clock outcomes as ``site="race"`` rows of the route-cost store
    (:mod:`torcheval_tpu_torch.routing_autotune`), which then decides the
    auto routes (the layer is turned on for the process):

    * ``megakernel`` on a collection's ``fused_update`` whose members the
      forced-on plan covers: the collection kernel (``mega.cu``) against
      each member on its own kernels (``cm_slab.cu``, ``binned_count.cu``);
    * ``cm_row_chunk`` where a confusion-matrix member takes the one-hot
      matmul route at this shape: the flag's row height against twice it;
    * ``rank_sketch`` for a ``BinaryAUROC``, ``BinaryAUPRC`` or
      ``MulticlassAUROC``, on fresh twins (one update and one compute
      each): advice only, never a change of the metric's state layout.

    Each candidate is forced through the flag a user would pin
    (``_flags.overridden``), so it launches exactly that route's kernels;
    no candidate sends a CUDA tensor to a plain version.  The race runs at
    most ``TORCHEVAL_TPU_TORCH_AUTOTUNE_PROBE_BUDGET`` candidate timings
    (default 8), skips a decision the store already measured for this
    shape, flags and card, and an explicit ``TORCHEVAL_TPU_TORCH_AUTOTUNE=0``
    outranks the argument and races nothing.  The snapshot restore erases
    what the race wrote into the states.  An ``Evaluator`` warms its own
    blocks and races nothing.
    """
    from torcheval_tpu_torch.engine import Evaluator
    from torcheval_tpu_torch.metrics.collection import MetricCollection

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
        if autotune:
            _race_routes(obj, entry, arrays, max(sweep), is_collection)
    finally:
        obj.load_state_dict(snapshot)
    return tuple(sweep)


# Members whose (C, C) counts follow the confusion-matrix route, and so
# read the row height where that route is the one-hot matmul.
_CM_CLASSES = (
    "MulticlassConfusionMatrix",
    "MulticlassF1Score",
    "MulticlassPrecision",
    "MulticlassRecall",
)
_SKETCH_CLASSES = ("BinaryAUROC", "BinaryAUPRC", "MulticlassAUROC")


def _takes_matmul(member: Any, batch: Tuple[Any, ...]) -> bool:
    """Whether ``member``'s update of ``batch`` counts through the one-hot
    matmul route, the only route that reads the row height."""
    from torcheval_tpu_torch.metrics.functional.classification.confusion_matrix import (
        _cm_route,
    )

    if type(member).__name__ not in _CM_CLASSES:
        return False
    if getattr(member, "average", None) == "micro":
        return False
    num_classes = getattr(member, "num_classes", None)
    if not isinstance(num_classes, int) or not batch:
        return False
    return _cm_route(num_classes, int(batch[0].shape[0])) == "matmul"


def _sketch_twin(obj: Any, sketch: bool) -> Any:
    kwargs = {"sketch": sketch, "device": obj.device}
    if type(obj).__name__ == "MulticlassAUROC":
        kwargs.update(num_classes=obj.num_classes, average=obj.average)
    else:
        kwargs["num_tasks"] = obj.num_tasks
    return type(obj)(**kwargs)


def _race_routes(obj, entry, arrays, top, is_collection) -> int:
    """Race the top-2 candidates of each decision that is a real choice on
    ``obj``'s warmed shape and persist the wall-clock outcomes as
    ``site="race"`` rows.  Returns the number of candidate timings spent
    (0 when the layer is explicitly off)."""
    import time

    from torcheval_tpu_torch import _flags
    from torcheval_tpu_torch import routing_autotune as _autotune
    from torcheval_tpu_torch.ops import _flags as _oflags

    if _oflags.autotune_mode() is False:
        return 0  # the explicit kill-switch outranks the argument
    if not _autotune.ENABLED:
        _autotune.enable()

    batch = tuple(_tile_to(a, top) for a in arrays)
    signature = _autotune.batch_signature(batch)
    budget = _autotune.probe_budget()
    spent = 0
    device = getattr(obj, "device", None)
    on_card = device is not None and torch.device(device).type == "cuda"

    def sync() -> None:
        if on_card:
            torch.cuda.synchronize(device)

    def timed(call) -> float:
        call()  # untimed: builds, loads and warms what the route launches
        sync()
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            call()
            sync()
            best = min(best, time.perf_counter() - t0)
        return best

    def race(decision, sig, candidates) -> None:
        """candidates: [(choice, thunk), ...]."""
        nonlocal spent
        if spent + len(candidates) > budget:
            return
        pref = _autotune.preference(decision, sig)
        if pref is not None and pref["kind"] == "measured":
            return  # already raced for this shape, flag context and card
        for choice, call in candidates:
            seconds = timed(call)
            if _autotune.ENABLED:
                _autotune.record_measurement(decision, choice, sig, seconds, site="race")
            spent += 1

    def under(flag, raw):
        def call():
            with _flags.overridden(flag, raw):
                entry(*batch)

        return call

    members = list(obj._metrics.values()) if is_collection else [obj]

    # Collection kernel on or off: only where the forced-on plan covers
    # this collection (else there is nothing to choose).
    if is_collection and getattr(entry, "__name__", "") == "fused_update":
        from torcheval_tpu_torch.ops import _mega_plan

        # The plan and its measured pick see the batch as fused_update
        # does: on the collection's device, padded to its bucket; the
        # pick is keyed on that batch and the plan's members.
        prepared, kw = obj._prepare(batch, {})
        with _flags.overridden("MEGAKERNEL", "1"):
            plan = _mega_plan.plan_for(obj._metrics, prepared, kw, obj._slices)
        if plan is not None:
            race(
                "megakernel",
                _mega_plan.plan_signature(prepared, plan.members),
                [("mega", under("MEGAKERNEL", "1")), ("fused", under("MEGAKERNEL", "0"))],
            )

    # One-hot row height: the flag's value against twice it.
    if any(_takes_matmul(m, batch) for m in members):
        base = _oflags.cm_row_chunk()
        race(
            "cm_row_chunk",
            "*",
            [
                (str(base), under("CM_ROW_CHUNK", str(base))),
                (str(base * 2), under("CM_ROW_CHUNK", str(base * 2))),
            ],
        )

    # Sketch against exact: a construction-time state layout, so the race
    # runs on fresh twins, and its rows stay advice.  The exact route
    # defers its cost to compute(), so a step is one update and one
    # compute.
    if not is_collection and type(obj).__name__ in _SKETCH_CLASSES:
        twins = [("sketch", _sketch_twin(obj, True)), ("sort", _sketch_twin(obj, False))]

        def step(twin):
            def call():
                twin.reset()
                twin.update(*batch)
                twin.compute()

            return call

        race("rank_sketch", signature, [(choice, step(t)) for choice, t in twins])

    _autotune.flush()
    return spent
