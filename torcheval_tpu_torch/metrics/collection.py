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
are installed (a flagged batch is then counted exactly).  Left out of the
JAX method, because they serve the JAX program cache or a module not
ported yet: the perfscope hook, the call-signature cache
(``_call_signature`` / ``_fused_seen``) and the compilation-cache bypass
around donated programs.
"""

from __future__ import annotations

import copy
import time
from typing import Any, Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.metrics._bucket import DEFAULT_MIN_BUCKET, pad_to_bucket
from torcheval_tpu_torch.metrics._buffer import RingWindowMixin
from torcheval_tpu_torch.metrics.functional._host_checks import skip_value_checks
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.ops import _mega_plan, mega
from torcheval_tpu_torch.telemetry import events as _telemetry
from torcheval_tpu_torch.telemetry import health as _health


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
    def _update_members(
        self, args: Tuple[Any, ...], kwargs: Dict[str, Any], fused: bool
    ) -> List[mega.Fold]:
        """The one update body of :meth:`update` and :meth:`fused_update`.
        Global members see the base validity mask; slice clone ``k`` sees
        ``mask * (slice_ids == k)``.  With ``fused``, the members the
        collection kernel supports are counted in one pass and returned as
        folds, not yet added (the caller adds them); the rest update here."""
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
        folds: List[mega.Fold] = []
        handled = frozenset()
        if fused:
            plan = _mega_plan.plan_for(self._metrics, args, kwargs, self._slices)
            if plan is not None:
                folds = mega.run_plan(
                    plan, self._metrics, self._slice_members, args,
                    kwargs.get("mask"), slice_ids,
                )
                handled = plan.member_names
        rest = [name for name in self._metrics if name not in handled]
        for name in rest:
            self._metrics[name].update(*args, **kwargs)
        if self._slices is not None and rest:
            base_mask = kwargs.get("mask")
            for k in range(self._slices):
                smask = (slice_ids == k).to(torch.int32)
                if base_mask is not None:
                    smask = smask * base_mask
                kwargs["mask"] = smask
                for name in rest:
                    self._slice_members[f"{name}@{k}"].update(*args, **kwargs)
        return folds

    def update(self, *args: Any, **kwargs: Any) -> "MetricCollection":
        """Update every member with the batch, each on its own path and with
        its own value checks."""
        args, kwargs = self._prepare(args, kwargs)
        self._update_members(args, kwargs, fused=False)
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
        before = self._read_states()
        try:
            with skip_value_checks():
                folds = self._update_members(args, kwargs, fused=True)
            mega.apply_folds(folds, donate=bool(self._donate))
        except BaseException:
            self._install_states(before)
            raise
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
            _health.inspect(health_stats, source="fused_update", bounds=self._health_bounds)
        return self

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
        return {
            name: {s: getattr(m, s) for s in m._state_name_to_default}
            for name, m in self._all_members.items()
        }

    def _install_states(self, states: Dict[str, Dict[str, Any]]) -> None:
        for name, per_state in states.items():
            m = self._all_members[name]
            for s, v in per_state.items():
                setattr(m, s, v)

    def compute(self) -> Dict[str, Any]:
        return {name: m.compute() for name, m in self._metrics.items()}

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

    def __repr__(self) -> str:
        inner = ", ".join(f"{name}={type(m).__name__}" for name, m in self._metrics.items())
        if self._slices is not None:
            inner += f", slices={self._slices}"
        return f"MetricCollection({inner})"


__all__ = ("MetricCollection",)
