"""MetricCollection: one object driving a named set of metrics (the port of
``torcheval_tpu/metrics/collection.py``).

State-dict keys are namespaced ``"{name}/{state}"`` (and ``"{name}@{k}/
{state}"`` for slice clones), so a collection checkpoints like any single
metric, and a JAX collection's ``state_dict()`` loads here through
:func:`torcheval_tpu_torch.convert.state_from_jax`.

:meth:`MetricCollection.fused_update` is the fast path.  The JAX package
traces every member's update into one jitted program; PyTorch runs
eagerly, so here the gain comes from the one-pass collection kernel
(``ops/mega.py``): every member whose update it supports
(``ops/_mega_plan.py``) is counted in ONE read of the batch, slice clones
included, and only the others run their own update.  With the telemetry
bus on, each call is one ``update`` span named ``MetricCollection.fused``;
with the data-health monitor on (``telemetry/health.py``), the batch is
screened on its device and the screen read back once, after the states
are installed (a flagged batch is then counted exactly).  With perfscope
on (``telemetry/perfscope.py``), the first call of each signature is
priced as ``"mega_collection"`` (the collection kernel took the members)
or ``"fused_collection"``.  Left out of the JAX method, because they serve
the JAX program cache: the per-collection signature set (``_fused_seen``)
and the compilation-cache bypass around donated programs.
:func:`_call_signature` keys the engine's captured graphs
(``engine/scan.py``), and :meth:`MetricCollection._scan_step` is the body
each step of an engine block runs.

On a GPU, :meth:`MetricCollection.update` of an unsliced collection
runs the checks of its graph-eligible members (``Metric._graph_update``)
eagerly, in member order, their value checks queued and read back
together (one read back for all that are pending, ``_host_checks.CheckQueue``),
then their device work as one replay of a
captured CUDA graph a call signature (``metrics/_graphs.py``), ring windows
at their cursors, then the ring windows' host bookkeeping; every other
member updates on its own path, in member order, after the pending checks
are judged.  A batch that fails a check raises the message the member's
own update raises, writes no eligible member's state and moves no ring
cursor.  On the
CPU, in a sliced collection, or for a call no graph can take, every member
updates on its own path.  ``_stats.member_update_counts()`` counts the member updates by
how their device work ran.

With the profiler ranges on (``telemetry.events.annotate``),
:meth:`~MetricCollection.update` and :meth:`~MetricCollection.compute`
are ``MetricCollection.update`` / ``.compute`` ranges, and each member's
call inside is its own, named ``<Class>[<member>].<phase>``; an eligible
member's range holds its checks, the read back of the queued value checks
is one range, ``checks[<member>,...].update``, and the replay is one
range, ``graph[<member>,...].update``.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from torcheval_tpu_torch import _stats
from torcheval_tpu_torch.metrics._bucket import DEFAULT_MIN_BUCKET, pad_to_bucket
from torcheval_tpu_torch.metrics._buffer import RingWindowMixin
from torcheval_tpu_torch.metrics._graphs import GraphedUpdate, install_states, read_states
from torcheval_tpu_torch.metrics.functional._host_checks import CheckQueue, skip_value_checks
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.ops import _mega_plan, mega
from torcheval_tpu_torch.telemetry import events as _telemetry
from torcheval_tpu_torch.telemetry import health as _health
from torcheval_tpu_torch.telemetry import perfscope as _perfscope


def _call_signature(args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> Any:
    """Hashable structure, shape, dtype and device signature of one call:
    equal signatures can replay one captured graph (the JAX package's
    counterpart mirrors its jit cache key)."""

    def leaf(v: Any) -> Any:
        if isinstance(v, torch.Tensor):
            return (tuple(v.shape), str(v.dtype), str(v.device))
        return (type(v).__name__,)

    return (
        tuple(leaf(a) for a in args),
        tuple((k, leaf(v)) for k, v in sorted(kwargs.items())),
    )


class MetricCollection:
    """A named, ordered set of metrics updated with the same batch.

    All members must accept the same ``update(*args, **kwargs)``
    signature (e.g. ``(input, target)`` classification metrics).

    ``bucket=True`` pads every update batch's leading dim up to a
    power-of-two bucket (``metrics/_bucket.py``) and passes the validity
    mask to every member, so every member must take ``mask=``
    (``Metric._supports_mask``).

    ``donate=True`` lets :meth:`fused_update` add the kernel's counts into
    the member states in place instead of binding new tensors; the states
    come out bit-equal either way, and ``state_dict()`` copies, so a
    snapshot never changes.  ``None`` (the default) means False.

    ``slices=K`` adds a slice axis: every update carries a per-row
    ``slice_ids=`` int vector (values in ``[0, K)``), and the collection
    keeps K per-slice clones of each member beside the global one.  Clone
    ``k`` updates with ``mask * (slice_ids == k)``; read the per-slice
    results with :meth:`compute_slices`.  Every member must take
    ``mask=``.
    """

    def __init__(
        self,
        metrics: Mapping[str, Metric],
        *,
        bucket: bool = False,
        min_bucket: int = DEFAULT_MIN_BUCKET,
        donate: Optional[bool] = None,
        slices: Optional[int] = None,
        slice_labels: Optional[Sequence[str]] = None,
    ) -> None:
        if not metrics:
            raise ValueError("MetricCollection requires at least one metric.")
        if slices is None and slice_labels is not None:
            raise ValueError("slice_labels requires slices=.")
        if slices is not None and slices < 1:
            raise ValueError(f"slices must be >= 1, got {slices}.")
        for name, metric in metrics.items():
            if not isinstance(metric, Metric):
                raise TypeError(
                    f"MetricCollection values must be Metric instances, got "
                    f"{name}={type(metric).__name__}."
                )
            if "/" in name:
                # "/" separates the state_dict namespace.
                raise ValueError(f"Metric names must not contain '/', got {name!r}.")
            if slices is not None and "@" in name:
                # "@" namespaces the slice clones ("name@k/state").
                raise ValueError(
                    f"Metric names must not contain '@' when slices= is set, got {name!r}."
                )
            if bucket and not metric._supports_mask:
                raise ValueError(
                    f"bucket=True requires mask-aware members; "
                    f"{name}={type(metric).__name__} does not support "
                    f"update(..., mask=)."
                )
            if slices is not None and not metric._supports_mask:
                raise ValueError(
                    f"slices= requires mask-aware members (slice restriction is a "
                    f"masked reduction); {name}={type(metric).__name__} does not "
                    f"support update(..., mask=)."
                )
        self._metrics: Dict[str, Metric] = dict(metrics)
        self._bucket = bool(bucket)
        self._min_bucket = int(min_bucket)
        self._donate = donate
        self._slices: Optional[int] = None if slices is None else int(slices)
        if slices is None:
            self._slice_labels: Tuple[str, ...] = ()
            self._slice_members: Dict[str, Metric] = {}
        else:
            labels = (
                tuple(str(v) for v in slice_labels)
                if slice_labels is not None
                else tuple(str(k) for k in range(slices))
            )
            if len(labels) != slices:
                raise ValueError(
                    f"slice_labels must name all {slices} slices; got {len(labels)}."
                )
            if len(set(labels)) != len(labels):
                raise ValueError(f"slice_labels must be unique; got {labels}.")
            self._slice_labels = labels
            self._slice_members = {
                f"{name}@{k}": copy.deepcopy(metric)
                for name, metric in self._metrics.items()
                for k in range(slices)
            }
        # Every state-carrying member, plain metrics and slice clones, under
        # its state_dict namespace key.
        self._all_members: Dict[str, Metric] = dict(self._metrics)
        self._all_members.update(self._slice_members)
        # The health monitor's (member, num_classes) pairs: taken once, at
        # the first fused_update with the monitor on (the members are fixed).
        self._health_bounds: Optional[Tuple[Tuple[str, int], ...]] = None
        # Perfscope's program name of each call signature (the plan is a
        # function of it), so a priced signature costs no plan again.
        self._perf_programs: Dict[Any, str] = {}
        # The members whose device work update() replays as one captured
        # graph on a GPU (none in a sliced collection), and their graphs,
        # made at the first such call.
        self._graphed: Dict[str, Metric] = (
            {n: m for n, m in self._metrics.items() if m._graph_update}
            if self._slices is None
            else {}
        )
        self._graphs: Optional[GraphedUpdate] = None

    # ------------------------------------------------------------- container
    def __getitem__(self, name: str) -> Metric:
        return self._metrics[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._metrics)

    def __len__(self) -> int:
        return len(self._metrics)

    def items(self) -> Iterable[Tuple[str, Metric]]:
        return self._metrics.items()

    @property
    def slices(self) -> Optional[int]:
        """Number of slices, or ``None`` for an unsliced collection."""
        return self._slices

    @property
    def slice_labels(self) -> Tuple[str, ...]:
        """Slice labels in slice-id order (empty when unsliced)."""
        return self._slice_labels

    # ----------------------------------------------------------------- inputs
    def _prepare(
        self, args: Tuple[Any, ...], kwargs: Dict[str, Any]
    ) -> Tuple[Tuple[Any, ...], Dict[str, Any]]:
        """Put the batch arrays on the collection's device, then pad them
        to their bucket and merge the validity mask into ``kwargs``
        (combined with a caller's ``mask=``) when ``bucket=True``."""
        device = self.device

        def place(v):
            if isinstance(v, (torch.Tensor, np.ndarray)):
                return torch.as_tensor(v, device=device)
            return v

        args = tuple(place(a) for a in args)
        kwargs = {
            k: place(v) if k in ("mask", "slice_ids") else v for k, v in kwargs.items()
        }
        if not self._bucket or not args:
            return args, kwargs
        mask = kwargs.pop("mask", None)
        slice_ids = kwargs.pop("slice_ids", None)
        if slice_ids is not None:
            # Pad the slice ids with the batch; the mask keeps the pad rows
            # out of every slice.
            padded, mask = pad_to_bucket(
                *args, slice_ids, mask=mask, min_bucket=self._min_bucket
            )
            args, kwargs["slice_ids"] = padded[:-1], padded[-1]
        else:
            args, mask = pad_to_bucket(*args, mask=mask, min_bucket=self._min_bucket)
        kwargs["mask"] = mask
        return args, kwargs

    # -------------------------------------------------------------- lifecycle
    def _split_slice_ids(
        self, kwargs: Dict[str, Any]
    ) -> Tuple[Dict[str, Any], Optional[torch.Tensor]]:
        """``kwargs`` without ``slice_ids=``, and the slice ids, which a
        sliced collection requires and an unsliced one refuses."""
        kwargs = dict(kwargs)
        slice_ids = kwargs.pop("slice_ids", None)
        if self._slices is None and slice_ids is not None:
            raise TypeError(
                "slice_ids= passed to an unsliced MetricCollection; construct it "
                "with slices=K first."
            )
        if self._slices is not None and slice_ids is None:
            raise TypeError(
                f"This MetricCollection has slices={self._slices}; every update "
                f"must carry slice_ids= (per-row int vector in [0, {self._slices}))."
            )
        return kwargs, slice_ids

    def _update_each(
        self, names: List[str], args: Tuple[Any, ...], kwargs: Dict[str, Any], slice_ids: Any
    ) -> None:
        """Each of the members ``names`` by its own update, in member
        order.  Global members see the base validity mask; slice clone
        ``k`` sees ``mask * (slice_ids == k)``."""
        # Each member's update is its span, named by its member name.
        spans = _telemetry.SPANS
        for name in names:
            if spans:
                _telemetry.member_phase(self._metrics[name], name, "update", args, kwargs)
            else:
                self._metrics[name].update(*args, **kwargs)
        if self._slices is not None and names:
            base_mask = kwargs.get("mask")
            for k in range(self._slices):
                smask = (slice_ids == k).to(torch.int32)
                if base_mask is not None:
                    smask = smask * base_mask
                kwargs["mask"] = smask
                for name in names:
                    self._slice_members[f"{name}@{k}"].update(*args, **kwargs)

    def _fused_body(self, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> List[mega.Fold]:
        """The update body of :meth:`fused_update`: the members the
        collection kernel supports are counted in one pass and returned as
        folds, not yet added (the caller adds them); the rest update here."""
        kwargs, slice_ids = self._split_slice_ids(kwargs)
        folds: List[mega.Fold] = []
        rest = list(self._metrics)
        plan = _mega_plan.plan_for(self._metrics, args, kwargs, self._slices)
        if plan is not None:
            folds = mega.run_plan(
                plan, self._metrics, self._slice_members, args,
                kwargs.get("mask"), slice_ids,
            )
            rest = [name for name in rest if name not in plan.member_names]
        self._update_each(rest, args, kwargs, slice_ids)
        return folds

    def _update_graphed(
        self,
        args: Tuple[Any, ...],
        kwargs: Dict[str, Any],
        key: Tuple[Any, ...],
        current: Dict[str, Dict[str, torch.Tensor]],
    ) -> None:
        """:meth:`update`'s members on a GPU: each member in member order,
        an eligible one by its checks alone, any other by its own update;
        then the eligible members' device work as one replay, and the ring
        members' host bookkeeping (:meth:`GraphedUpdate.run`).  The
        eligible members' value checks are queued and read back together
        (:class:`CheckQueue`) before the next ineligible member's update,
        before the replay, or when a later member's check raises, where
        an earlier member's failing value check raises first."""
        spans = _telemetry.SPANS
        checks = CheckQueue()
        for name, m in self._metrics.items():
            if name not in self._graphed:
                checks.flush()
                if spans:
                    _telemetry.member_phase(m, name, "update", args, kwargs)
                else:
                    m.update(*args, **kwargs)
                continue
            try:
                with checks.scope(name):
                    if spans:
                        _telemetry.timed_phase(m, "update", type(m)._validate, args, kwargs, name)
                    else:
                        m._validate(*args, **kwargs)
            except Exception:
                try:
                    checks.flush()
                except ValueError as earlier:
                    raise earlier from None
                raise
        checks.flush()
        eager = len(self._metrics) - len(self._graphed)
        if eager:
            _stats.count_member_updates("eager", eager)
        graphs = self._graphs
        t0 = time.monotonic() if _telemetry.ENABLED else 0.0
        if _telemetry.ANNOTATE:
            with _telemetry.span(graphs.name):
                graphs.run(key, args, kwargs, current)
        else:
            graphs.run(key, args, kwargs, current)
        if _telemetry.ENABLED:
            _telemetry.record_span("update", graphs.name, time.monotonic() - t0, 0)

    def update(self, *args: Any, **kwargs: Any) -> "MetricCollection":
        """Update every member with the batch, with every member's value
        checks; on a GPU the graph-eligible members' device work is one
        replay of a captured graph (the module's docstring)."""
        if _telemetry.ANNOTATE:
            with _telemetry.span("MetricCollection.update"):
                return self._update(args, kwargs)
        return self._update(args, kwargs)

    def _update(self, args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> "MetricCollection":
        """The update body of :meth:`update`: a call the collection's
        graphs can take runs :meth:`_update_graphed`, any other updates
        every member on its own path."""
        args, kwargs = self._prepare(args, kwargs)
        kwargs, slice_ids = self._split_slice_ids(kwargs)
        if self._graphed and (self._graphs is not None or self.device.type == "cuda"):
            if self._graphs is None:
                self._graphs = GraphedUpdate(self._graphed)
            current = self._graphs.read()
            key = self._graphs.key(args, kwargs, current)
            if key is not None:
                self._update_graphed(args, kwargs, key, current)
                return self
        self._update_each(list(self._metrics), args, kwargs, slice_ids)
        _stats.count_member_updates("eager", len(self._metrics) * (1 + (self._slices or 0)))
        return self

    def fused_update(self, *args: Any, **kwargs: Any) -> "MetricCollection":
        """Update every member, the supported ones in ONE pass of the
        collection kernel over the batch.

        The members' data-dependent value checks are skipped (as inside
        the JAX package's traced program); shape and parameter checks
        still apply.  Every member state must be a tensor: sample-buffer
        members (list states) take :meth:`update`.

        Abort-safe: every delta is computed before any state is written,
        and if anything raises, every state is put back as it was.  Under
        ``health.enable(raise_on_corrupt=True)`` a corrupt batch raises
        ``DataCorruptionError`` after it was applied."""
        self._check_fusable()
        args, kwargs = self._prepare(args, kwargs)
        t0 = time.monotonic() if _telemetry.ENABLED else 0.0
        health_stats = None
        if _health.ENABLED:
            if self._health_bounds is None:
                self._health_bounds = _health.label_bounds(self._metrics)
            health_stats = _health.stats_for_update(args, kwargs, self._health_bounds)
        pending = self._perfscope_begin(args, kwargs) if _perfscope.ENABLED else None
        before = self._read_states()
        try:
            with skip_value_checks():
                folds = self._fused_body(args, kwargs)
            mega.apply_folds(folds, donate=bool(self._donate))
        except BaseException:
            self._install_states(before)
            raise
        if _perfscope.ENABLED and pending is not None:
            # Priced once per (signature, donation, health, route token).
            _perfscope.profile_program(
                pending, before, self._read_states(), batch_args=(args, kwargs),
                donate=bool(self._donate),
            )
        if _telemetry.ENABLED:
            _telemetry.record_span(
                "update",
                "MetricCollection.fused",
                time.monotonic() - t0,
                sum(_telemetry.state_nbytes(m) for m in self._all_members.values()),
            )
        if health_stats is not None:
            # After the states are installed: a raise-on-corrupt escalation
            # leaves the applied batch in place; the monitor only reports.
            # tpulint: disable=TPU001 -- health_stats is non-None only when the program was built with health=_health.ENABLED
            _health.inspect(health_stats, source="fused_update", bounds=self._health_bounds)
        return self

    def _perfscope_begin(
        self, args: Tuple[Any, ...], kwargs: Dict[str, Any]
    ) -> Optional[_perfscope.Pending]:
        """Perfscope's gate for one :meth:`fused_update` (only called
        with perfscope on): the program is ``"mega_collection"`` when the
        collection kernel takes the members, else ``"fused_collection"``."""
        signature = (
            _call_signature(args, kwargs),
            bool(self._donate),
            _health.ENABLED,
            _mega_plan.route_token(),
        )
        program = self._perf_programs.get(signature)
        if program is None:
            kw = {k: v for k, v in kwargs.items() if k != "slice_ids"}
            program = self._perf_programs[signature] = (
                "mega_collection"
                if _mega_plan.plan_for(self._metrics, args, kw, self._slices) is not None
                else "fused_collection"
            )
        return _perfscope.begin(program, signature, self.device)

    def _scan_step(
        self, args: Tuple[Any, ...], kwargs: Dict[str, Any], donate: bool
    ) -> None:
        """One step of an engine block (the counterpart of the JAX scan
        body's ``_trace_update`` call): the update body of
        :meth:`fused_update` on a batch already on the collection's device
        and already padded, so no ``_prepare``.  The caller runs it under
        ``skip_value_checks`` and owns abort safety; ``donate`` adds the
        collection kernel's counts in place."""
        folds = self._fused_body(args, kwargs)
        mega.apply_folds(folds, donate=donate)

    def _check_fusable(self) -> None:
        for name, m in self._all_members.items():
            if isinstance(m, RingWindowMixin):
                raise ValueError(
                    f"fused_update does not support windowed member {name!r}: "
                    "its update writes a ring column at a cursor kept on the host "
                    "and advanced by each call, not a count the collection folds. "
                    "Use update() for windowed metrics."
                )
            for s in m._state_name_to_default:
                if not isinstance(getattr(m, s), torch.Tensor):
                    raise ValueError(
                        f"fused_update requires tensor states; member {name!r} "
                        f"state {s!r} is {type(getattr(m, s)).__name__}. "
                        "Use update() for buffer-state metrics."
                    )

    def _read_states(self) -> Dict[str, Dict[str, Any]]:
        return read_states(self._all_members)

    def _install_states(self, states: Dict[str, Dict[str, Any]]) -> None:
        install_states(self._all_members, states)

    def compute(self) -> Dict[str, Any]:
        if _telemetry.ANNOTATE:
            with _telemetry.span("MetricCollection.compute"):
                return self._compute()
        return self._compute()

    def _compute(self) -> Dict[str, Any]:
        spans = _telemetry.SPANS
        return {
            name: _telemetry.member_phase(m, name, "compute") if spans else m.compute()
            for name, m in self._metrics.items()
        }

    def compute_slices(self) -> Dict[str, Dict[str, Any]]:
        """Per-slice results: ``{slice_label: {metric_name: value}}``,
        labels in slice-id order.  The global figures stay in
        :meth:`compute`."""
        if self._slices is None:
            raise ValueError(
                "compute_slices() on an unsliced MetricCollection; construct it "
                "with slices=K first."
            )
        return {
            label: {
                name: self._slice_members[f"{name}@{k}"].compute()
                for name in self._metrics
            }
            for k, label in enumerate(self._slice_labels)
        }

    def reset(self) -> "MetricCollection":
        for metric in self._all_members.values():
            metric.reset()
        return self

    def merge_state(
        self, collections: Iterable["MetricCollection"]
    ) -> "MetricCollection":
        """Merge same-shaped collections memberwise, each member by its own
        ``merge_state``.  Members must be the same metric type under each
        name and identically configured."""
        collections = list(collections)
        for other in collections:
            if set(other._metrics) != set(self._metrics):
                raise ValueError(
                    "Merged collections must hold the same metric names; got "
                    f"{sorted(self._metrics)} vs {sorted(other._metrics)}."
                )
            if other._slices != self._slices or other._slice_labels != self._slice_labels:
                raise ValueError(
                    "Merged collections must share the slice axis; got "
                    f"slices={self._slices} labels={self._slice_labels} vs "
                    f"slices={other._slices} labels={other._slice_labels}."
                )
            for name, metric in self._metrics.items():
                if type(other._metrics[name]) is not type(metric):
                    raise ValueError(
                        f"Member {name!r} is {type(metric).__name__} here but "
                        f"{type(other._metrics[name]).__name__} in a merged collection."
                    )
        for name, metric in self._all_members.items():
            metric.merge_state([other._all_members[name] for other in collections])
        return self

    # -------------------------------------------------------- toolkit hooks
    # The sync toolkit treats a collection like any metric: it is pickled
    # whole through the process group, pre-concatenated with
    # _prepare_for_merge_state, moved with to() and merged memberwise.
    @property
    def device(self) -> torch.device:
        return next(iter(self._metrics.values())).device

    def _prepare_for_merge_state(self) -> None:
        for metric in self._all_members.values():
            metric._prepare_for_merge_state()

    # ------------------------------------------------------------ checkpoint
    def state_dict(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, metric in self._all_members.items():
            for key, value in metric.state_dict().items():
                out[f"{name}/{key}"] = value
        return out

    def load_state_dict(self, state_dict: Mapping[str, Any], strict: bool = True) -> None:
        """Load a ``state_dict()`` mapping.  With ``strict``, unexpected
        keys and members with no key at all raise before anything loads;
        and a failure while loading puts every member back as it was."""
        per_metric: Dict[str, Dict[str, Any]] = {name: {} for name in self._all_members}
        unexpected = []
        for key, value in state_dict.items():
            name, _, state_key = key.partition("/")
            if name in per_metric and state_key:
                per_metric[name][state_key] = value
            else:
                unexpected.append(key)
        if strict:
            problems = []
            if unexpected:
                problems.append(f"Unexpected keys in state_dict: {sorted(unexpected)}")
            missing_members = sorted(
                name
                for name, states in per_metric.items()
                if not states and self._all_members[name]._state_name_to_default
            )
            if missing_members:
                problems.append(
                    f"state_dict is missing every state of member(s) {missing_members}"
                )
            if problems:
                raise RuntimeError("; ".join(problems) + ".")
        before = self._read_states()
        try:
            for name, metric in self._all_members.items():
                metric.load_state_dict(per_metric[name], strict=strict)
        except BaseException:
            self._install_states(before)
            raise

    def to(self, device: Any) -> "MetricCollection":
        for metric in self._all_members.values():
            metric.to(device)
        return self

    def __getstate__(self) -> Dict[str, Any]:
        # Captured graphs stay with the process that made them: a pickled
        # or deep-copied collection captures its own.
        state = self.__dict__.copy()
        state["_graphs"] = None
        return state

    def __repr__(self) -> str:
        inner = ", ".join(f"{name}={type(m).__name__}" for name, m in self._metrics.items())
        if self._slices is not None:
            inner += f", slices={self._slices}"
        return f"MetricCollection({inner})"


__all__ = ("MetricCollection",)
