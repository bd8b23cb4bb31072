"""Metric core runtime — the state-machine base class every metric builds
on (the port of ``torcheval_tpu/metrics/metric.py``).

State registry (``_add_state``), the update/compute/merge_state lifecycle,
``reset``/``state_dict``/``load_state_dict``/``to``/``device``, the
``_prepare_for_merge_state`` pre-sync hook, state-type validation and
pickling.  States are ``torch.Tensor``s (or a list / deque / dict of
them) on one ``torch.device``.  Where the JAX package re-binds immutable
arrays, the port re-binds too: no state tensor is written in place, so a
registry default, a ``state_dict()`` snapshot and the live state never
share storage (the JAX ``_fresh_array`` copy is ``.clone()`` here).

A metric constructed without ``device=`` lives on the GPU.  Where no GPU
exists it raises, naming ``device="cpu"``: the port never picks the CPU
on its own.
"""

from __future__ import annotations

import functools
import logging
from abc import ABC, abstractmethod
from collections import defaultdict, deque
from typing import Any, Deque, Dict, Generic, Iterable, List, Tuple, TypeVar, Union

import torch

from torcheval_tpu_torch.telemetry import events as _telemetry

_usage_log = logging.getLogger("torcheval_tpu_torch.telemetry")

TComputeReturn = TypeVar("TComputeReturn")

TState = Union[
    torch.Tensor,
    List[torch.Tensor],
    Dict[Any, torch.Tensor],
    Deque[torch.Tensor],
]

TSelf = TypeVar("TSelf", bound="Metric")

DeviceLike = Union[str, torch.device, None]


def canonicalize_device(device: DeviceLike) -> torch.device:
    """Resolve ``None`` / ``"cpu"`` / ``"cuda:0"`` / ``torch.device``.

    ``None`` means the GPU: ``torch.device("cuda")`` when one exists, else
    a ``RuntimeError`` that tells the caller to pass ``device="cpu"``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "torcheval_tpu_torch metrics default to the GPU, but no CUDA "
                'device is available; pass device="cpu" to run on the CPU.'
            )
        return torch.device("cuda")
    if isinstance(device, (str, torch.device)):
        return torch.device(device)
    raise ValueError(f"Invalid device {device!r}.")


def _check_state_variable_type(name: str, value: Any) -> None:
    """Enforce the four legal state types (reference ``metric.py:278-300``)."""
    if isinstance(value, torch.Tensor):
        return
    if isinstance(value, (list, deque)) and all(
        isinstance(v, torch.Tensor) for v in value
    ):
        return
    if isinstance(value, dict) and all(
        isinstance(v, torch.Tensor) for v in value.values()
    ):
        return
    raise TypeError(
        "The value of state variable must be a Tensor, a list of Tensors, "
        f"a dict with Tensor values, or a deque of Tensors. Got {name}={value!r} "
        "instead."
    )


def _zero_scalar() -> torch.Tensor:
    """Picklable default factory for dict states (reference resets dict
    states to a defaultdict of scalar zeros, ``metric.py:142-148``)."""
    return torch.tensor(0.0)


def _move_state(value: TState, device: torch.device, fresh: bool = False) -> TState:
    """Copy a state value onto ``device`` (containers are shallow-copied;
    defaultdict-ness is preserved).  ``fresh=True`` gives tensor leaves
    their own storage, so the registry default, a snapshot and the live
    state never alias; container leaves keep the cheap ``.to``."""
    if isinstance(value, torch.Tensor):
        moved = value.to(device)
        return moved.clone() if fresh and moved is value else moved
    if isinstance(value, list):
        return [v.to(device) for v in value]
    if isinstance(value, deque):
        return deque((v.to(device) for v in value), maxlen=value.maxlen)
    if isinstance(value, defaultdict):
        out = defaultdict(value.default_factory)
        for k, v in value.items():
            out[k] = v.to(device)
        return out
    if isinstance(value, dict):
        return {k: v.to(device) for k, v in value.items()}
    raise TypeError(f"Unsupported state type: {type(value)}")


def _wrap_phase(fn, phase: str):
    """Wrap a subclass's ``update``/``compute`` as a telemetry span hook:
    one module-flag branch when the bus and the profiler ranges are off."""

    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if not _telemetry.SPANS:
            return fn(self, *args, **kwargs)
        return _telemetry.timed_phase(self, phase, fn, args, kwargs)

    wrapped.__torcheval_tpu_phase__ = phase
    return wrapped


class Metric(Generic[TComputeReturn], ABC):
    """Base class for all metrics: a registry of tensor states plus the
    update/compute/merge lifecycle (reference ``Metric``, ``metric.py:23``)."""

    # True on metrics whose update takes mask= (rows with mask 0 add
    # nothing); MetricCollection's bucket= and slices= need it.
    _supports_mask: bool = False

    # States fixed at construction that configure the metric rather than
    # count what it saw (the binned family's ``threshold`` edges): merge
    # never adds them, and the monitor wrappers neither decay them nor
    # give them a bucket axis.
    _fixed_states: Tuple[str, ...] = ()

    # States that merge by max or min (an extremum seen so far, e.g.
    # ``Max.max``): zero is no identity for them and their buckets do not
    # add, so ``monitor.SlidingWindow`` refuses a metric that has one.
    _extremum_states: Tuple[str, ...] = ()

    # True on classes whose ``update`` is ``_validate`` (every shape,
    # parameter and value check, with its read backs) then
    # ``_update_body`` (device work only: no read back, host branches on
    # shapes, dtypes and constructor parameters alone, tensor states
    # only, their shapes fixed before the update): ``MetricCollection.update``
    # replays the bodies of such members as one captured CUDA graph on a
    # GPU (``metrics/_graphs.py``).  A ring window
    # (``_buffer.RingWindowMixin``) adds a third part: its ``_update_body``
    # takes first ``start``, the ring cursor as a 0-dim int64 device
    # tensor, and ``_update_host`` (same arguments as ``update``) then
    # moves the host bookkeeping; in the graph, ``_advance_start`` moves
    # ``start`` on as ``_update_host`` moves the cursor.  A subclass that
    # defines its own ``update`` is not eligible unless it sets this again.
    _graph_update: bool = False

    def __init_subclass__(cls, **kwargs: Any) -> None:
        super().__init_subclass__(**kwargs)
        if "update" in cls.__dict__ and "_graph_update" not in cls.__dict__:
            cls._graph_update = False
        # Every concrete update/compute a subclass defines is wrapped ONCE
        # (inherited already-wrapped methods are left alone).
        for phase in ("update", "compute"):
            fn = cls.__dict__.get(phase)
            if (
                callable(fn)
                and not getattr(fn, "__isabstractmethod__", False)
                and getattr(fn, "__torcheval_tpu_phase__", None) is None
            ):
                setattr(cls, phase, _wrap_phase(fn, phase))

    def __init__(self: TSelf, *, device: DeviceLike = None) -> None:
        _usage_log.debug("torcheval_tpu_torch.metrics.%s", type(self).__name__)
        self._device: torch.device = canonicalize_device(device)
        self._state_name_to_default: Dict[str, TState] = {}

    # ------------------------------------------------------------------ state
    def _add_state(self, name: str, default: TState) -> None:
        """Register a named state with its default value
        (reference ``metric.py:52-68``).  The registry keeps its own copy,
        so later changes to the caller's object or the live state can never
        corrupt ``reset()``."""
        _check_state_variable_type(name, default)
        if isinstance(default, torch.Tensor):
            stored: TState = default.clone()
        elif isinstance(default, list):
            stored = list(default)
        elif isinstance(default, deque):
            stored = deque(default, maxlen=default.maxlen)
        else:
            # A plain-dict copy (picklable); the live state keeps the
            # caller's defaultdict-ness via _move_state.
            stored = dict(default)
        self._state_name_to_default[name] = stored
        setattr(self, name, _move_state(default, self._device, fresh=True))

    # ------------------------------------------------------------- lifecycle
    @abstractmethod
    def update(self: TSelf, *_: Any, **__: Any) -> TSelf:
        """Absorb a batch into the sufficient statistics. Returns ``self``."""

    @abstractmethod
    def compute(self) -> TComputeReturn:
        """Turn the sufficient statistics into the final value.  Must be
        idempotent and safe to call before any update."""

    @abstractmethod
    def merge_state(self: TSelf, metrics: Iterable[TSelf]) -> TSelf:
        """Merge the state of ``metrics`` into ``self``; must not modify the
        input metrics."""

    def _prepare_for_merge_state(self) -> None:
        """Optional pre-sync hook: canonicalize list-states to a single
        tensor so a cross-process gather ships one buffer."""

    # ---------------------------------------------------------------- sketch
    def sketch_state(self, kind: str = "exact", **options: Any) -> Any:
        """This metric's state as a mergeable sketch
        (:mod:`torcheval_tpu_torch.metrics._sketch`).  The base class
        supports only ``kind="exact"``: the whole prepared metric, lossless,
        payload O(samples).  ``BinaryAUROC`` / ``BinaryAUPRC`` also offer
        ``"reservoir"`` / ``"histogram"`` / ``"count"`` / ``"rank"``, and a
        ``sketch=True`` curve metric ships its counts as ``"rank"``."""
        from torcheval_tpu_torch.metrics._sketch import ExactSketch

        if kind != "exact":
            raise ValueError(
                f"{type(self).__name__} supports only kind='exact' "
                f"sketches, got {kind!r}"
            )
        return ExactSketch.from_metric(self)

    def merge_sketch(self: TSelf, sketch: Any) -> TSelf:
        """Absorb a (merged) sketch into this metric, so that ``compute()``
        reflects the fleet.  Sample-domain sketches (exact, reservoir)
        restore; bin-domain ones (histogram, count, rank) raise: read their
        value from ``sketch.compute()``."""
        sketch.merge_into(self)
        return self

    def reset(self: TSelf) -> TSelf:
        """Re-initialize every state from its default on the current device."""
        device = self._device
        for name, default in self._state_name_to_default.items():
            if isinstance(default, dict):
                fresh: TState = defaultdict(
                    lambda: torch.tensor(0.0, device=device)
                )
                for k, v in default.items():
                    fresh[k] = v.to(device)
                setattr(self, name, fresh)
            else:
                setattr(self, name, _move_state(default, device, fresh=True))
        return self

    # ---------------------------------------------------------- checkpointing
    def state_dict(self) -> Dict[str, TState]:
        """Snapshot of all states: tensor states are cloned, containers
        shallow-copied (deques become lists)."""
        out: Dict[str, TState] = {}
        for name in self._state_name_to_default:
            value = getattr(self, name)
            if isinstance(value, torch.Tensor):
                out[name] = value.clone()
            elif isinstance(value, (list, deque)):
                out[name] = list(value)
            else:
                out[name] = dict(value)
        return out

    def load_state_dict(
        self, state_dict: Dict[str, TState], strict: bool = True
    ) -> None:
        """Restore states from a snapshot (reference ``metric.py:188-219``)."""
        state_dict = dict(state_dict)
        metric_state_names = set(self._state_name_to_default.keys())
        provided_keys = set(state_dict.keys())
        for name in metric_state_names:
            if name in state_dict:
                value = state_dict.pop(name)
                default = self._state_name_to_default[name]
                if isinstance(default, deque) and isinstance(value, list):
                    value = deque(value, maxlen=default.maxlen)
                _check_state_variable_type(name, value)
                # fresh=True: the caller keeps its checkpoint tensors.
                setattr(self, name, _move_state(value, self._device, fresh=True))
        if strict:
            unexpected_keys = set(state_dict.keys())
            missing_keys = metric_state_names - provided_keys
            if missing_keys or unexpected_keys:
                raise RuntimeError(
                    "Error(s) in loading state_dict for "
                    f"{self.__class__.__name__}. "
                    f"Encountered missing keys: {missing_keys} and unexpected "
                    f"keys: {unexpected_keys}."
                )

    # --------------------------------------------------------------- devices
    def to(self: TSelf, device: DeviceLike, *args: Any, **kwargs: Any) -> TSelf:
        """Move every state onto ``device``.  Extra args are accepted for
        reference-signature parity and ignored."""
        device = canonicalize_device(device)
        for name in self._state_name_to_default:
            value = getattr(self, name)
            if isinstance(value, defaultdict):
                moved: TState = defaultdict(
                    lambda: torch.tensor(0.0, device=device)
                )
                for k, v in value.items():
                    moved[k] = v.to(device)
                setattr(self, name, moved)
            else:
                setattr(self, name, _move_state(value, device))
        self._device = device
        return self

    @property
    def device(self) -> torch.device:
        """The device all state currently lives on."""
        return self._device

    # ---------------------------------------------------------------- pickle
    def __getstate__(self) -> Dict[str, Any]:
        state = self.__dict__.copy()
        state["_device_str"] = str(state.pop("_device"))
        return {k: _to_cpu_tree(v) for k, v in state.items()}

    def __setstate__(self, state: Dict[str, Any]) -> None:
        device = canonicalize_device(state.pop("_device_str"))
        self.__dict__.update({k: _to_device_tree(v, device) for k, v in state.items()})
        self._device = device
        # Dict states come back as plain dicts; restore defaultdict-ness
        # with the standard scalar-zero factory.
        for name, default in self._state_name_to_default.items():
            value = getattr(self, name, None)
            if isinstance(default, dict) and isinstance(value, dict):
                restored = defaultdict(_zero_scalar)
                restored.update(value)
                setattr(self, name, restored)


def _to_cpu_tree(value: Any) -> Any:
    """Tensors (possibly nested in state containers) onto the CPU for
    pickling, so a metric pickled on the GPU unpickles anywhere."""
    if isinstance(value, torch.Tensor):
        return value.cpu()
    if isinstance(value, list):
        return [_to_cpu_tree(v) for v in value]
    if isinstance(value, deque):
        return deque((_to_cpu_tree(v) for v in value), maxlen=value.maxlen)
    if isinstance(value, dict):
        return {k: _to_cpu_tree(v) for k, v in value.items()}
    return value


def _to_device_tree(value: Any, device: torch.device) -> Any:
    if isinstance(value, torch.Tensor):
        return value.to(device)
    if isinstance(value, list):
        return [_to_device_tree(v, device) for v in value]
    if isinstance(value, deque):
        return deque((_to_device_tree(v, device) for v in value), maxlen=value.maxlen)
    if isinstance(value, dict):
        return {k: _to_device_tree(v, device) for k, v in value.items()}
    return value
