"""Tenant sessions coalesced onto shared sliced collections (the port of
``torcheval_tpu/serve/registry.py``).

The serve layer's cost model: N tenants evaluating the same metric suite
must not cost N dispatches per batch mix.  A :class:`SessionRegistry`
groups tenants by *collection signature* (metric names, types,
configuration, state layout and device) and seats every same-signature
tenant on one shared :class:`~torcheval_tpu_torch.metrics.MetricCollection`
built with ``slices=K``: tenant *t*'s batch rides the sliced update with
``slice_ids`` pinned to *t*'s seat, so its per-seat clone sees ``mask *
(slice_ids == seat)``, exactly the masked update a solo run performs
(bit-identical results, the quarantine suite's isolation property).  On a
GPU the collection kernel (``mega.cu``, ``ops/_mega_plan.py::plan_for``)
counts every supported member of the dispatch, seat clones included, in
one pass over the batch.

The shared program of a signature is a :class:`_ApplyBundle`, built once
over a registry-owned **template** collection and cached in a bounded
:class:`~torcheval_tpu_torch.parallel._compile_cache.LruCache` under
``(signature, width, health, _mega_plan.route_token())``.  The JAX package
jits one apply over the template; PyTorch runs eagerly, so here a bundle
holds the template and its health bounds and nothing compiled.  Its apply
installs a group's states into the template, runs the template's fused
update body (``MetricCollection._fused_body`` and
``mega.apply_folds``) on the batch and returns the new states; every
group of the signature runs the same template over its own states.  As in
the JAX bundle, nothing is donated: the apply writes no state tensor of
the group in place (each state is rebound to a new tensor), so the
service's pre-dispatch snapshot is the quarantine path's rollback point.
The bundle is not captured as a CUDA graph.

Seats are fungible: spilling a tenant frees its seat entirely and a later
resume may land on a different seat or group; seat state dicts are keyed
``"{metric}/{state}"`` with no seat index for exactly this reason.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch

import torcheval_tpu_torch.serve.metering as _metering
from torcheval_tpu_torch._stats import bump_trace
from torcheval_tpu_torch.metrics.collection import MetricCollection
from torcheval_tpu_torch.metrics.functional._host_checks import skip_value_checks
from torcheval_tpu_torch.metrics.metric import Metric
from torcheval_tpu_torch.ops import _mega_plan, mega
from torcheval_tpu_torch.parallel._compile_cache import LruCache
from torcheval_tpu_torch.telemetry import health as _health
from torcheval_tpu_torch.telemetry import perfscope as _perfscope

DEFAULT_GROUP_WIDTH = 8

# Config-attr values folded into signature_of by value.  Anything else
# (tensors, callables, user objects) is fingerprinted by identity, which
# over-splits (two tenants with distinct exotic config objects get
# separate groups) but can never wrongly coalesce differently configured
# metrics onto one program.
_PLAIN = (str, int, float, bool, bytes, type(None))


def _config_fingerprint(metric: Metric) -> Tuple[Tuple[str, Any], ...]:
    """Public non-state instance attributes, by value where safe.

    Metric configuration lives in public scalar attributes (``self.k``,
    ``self.threshold``, ``self.num_classes``, ``self.average``, ...);
    states and private attributes are excluded.  Two same-type metrics
    with different config therefore never share a signature even when
    their state layouts coincide.
    """
    states = set(metric._state_name_to_default)
    out = []
    for key in sorted(vars(metric)):
        if key.startswith("_") or key in states:
            continue
        value = vars(metric)[key]
        if isinstance(value, _PLAIN):
            out.append((key, value))
        elif isinstance(value, tuple) and all(isinstance(v, _PLAIN) for v in value):
            out.append((key, ("tuple",) + value))
        else:
            out.append((key, f"<id:{type(value).__qualname__}@{id(value):#x}>"))
    return tuple(out)


def signature_of(metrics: Mapping[str, Metric]) -> Tuple[Any, ...]:
    """Hashable coalescing signature of a metric suite: sorted ``(name,
    qualified type, config fingerprint, state layout, device)`` per member.
    Tenants opened with equal signatures share seats on one sliced
    collection (and one bundle); pass an explicit ``signature=`` to
    :meth:`SessionRegistry.open` to override.  The device is part of the
    signature (the JAX package's has none): a group's states live on one
    device, and seating a tenant never moves its states to another."""
    sig = []
    for name in sorted(metrics):
        m = metrics[name]
        cls = type(m)
        layout = tuple(
            (
                s,
                tuple(getattr(getattr(m, s), "shape", ())),
                str(getattr(getattr(m, s), "dtype", type(getattr(m, s)).__name__)),
            )
            for s in sorted(m._state_name_to_default)
        )
        sig.append(
            (name, f"{cls.__module__}.{cls.__qualname__}",
             _config_fingerprint(m), layout, str(m.device))
        )
    return tuple(sig)


@dataclass
class _ApplyBundle:
    """The shared program of one (signature, width, health, route token)
    key: the template collection the apply runs through and the health
    bounds it screens with."""

    template: MetricCollection
    health: bool
    bounds: Tuple[Tuple[str, int], ...]

    def apply(
        self,
        states: Dict[str, Dict[str, torch.Tensor]],
        args: Tuple[Any, ...],
        kwargs: Dict[str, Any],
    ) -> Tuple[Dict[str, Dict[str, torch.Tensor]], Optional[Any]]:
        """``(new states, health screen or None)`` of one batch over
        ``states`` (a group collection's ``_read_states()``; the batch is
        placed, bucketed and carries ``slice_ids``).  The update body of
        ``MetricCollection.fused_update`` without donation: ``states`` are
        not written."""
        template = self.template
        template._install_states(states)
        screen = (
            # tpulint: disable=TPU001 -- traced only when the bundle was built with health on (keyed on _health.ENABLED)
            _health.stats_for_update(args, kwargs, self.bounds) if self.health else None
        )
        with skip_value_checks():
            folds = template._fused_body(args, kwargs)
        mega.apply_folds(folds, donate=False)
        return template._read_states(), screen


def _build_bundle(template: MetricCollection, health: bool) -> _ApplyBundle:
    bump_trace("serve_group")
    # tpulint: disable=TPU001 -- cold compile path: `health` is _health.ENABLED captured at the bundle cache key, not a hot-path probe
    bounds = _health.label_bounds(template._metrics) if health else ()
    return _ApplyBundle(template=template, health=health, bounds=bounds)


def _rows(leaf: Any) -> int:
    shape = getattr(leaf, "shape", None)
    return int(shape[0]) if shape else len(leaf)


class TenantGroup:
    """One ``slices=width`` collection plus its seat bookkeeping.

    Seat clones (``"{name}@{seat}"``) hold per-tenant state; the global
    members accumulate the union of every seated tenant's batches and are
    never read by the serve layer.
    """

    def __init__(
        self,
        signature: Tuple[Any, ...],
        template_metrics: Mapping[str, Metric],
        width: int,
        *,
        bucket: bool = True,
    ) -> None:
        self.signature = signature
        self.width = int(width)
        self.collection = MetricCollection(
            {n: copy.deepcopy(m) for n, m in template_metrics.items()},
            bucket=bucket,
            donate=False,
            slices=self.width,
        )
        # States are tensors for the group's lifetime (resets and
        # load_state_dict both install tensors), so one fusability sweep
        # at construction covers every dispatch.
        self.collection._check_fusable()
        self.free: List[int] = list(range(self.width))
        self.occupants: Dict[int, str] = {}

    def acquire(self, tenant: str) -> int:
        seat = self.free.pop(0)
        self.occupants[seat] = tenant
        return seat

    def release(self, seat: int) -> None:
        """Free a seat for the next tenant: reset its clones so no state
        leaks across occupancies."""
        self.reset_seat(seat)
        self.occupants.pop(seat, None)
        self.free.append(seat)

    def reset_seat(self, seat: int) -> None:
        for name in self.collection._metrics:
            self.collection._slice_members[f"{name}@{seat}"].reset()

    def seat_state_dict(self, seat: int) -> Dict[str, Any]:
        """Flat ``"{metric}/{state}"`` snapshot of one seat: no seat index
        in the keys, so a resume can load it into any seat."""
        out: Dict[str, Any] = {}
        for name in self.collection._metrics:
            clone = self.collection._slice_members[f"{name}@{seat}"]
            for state, value in clone.state_dict().items():
                out[f"{name}/{state}"] = value
        return out

    def load_seat(self, seat: int, flat: Mapping[str, Any]) -> None:
        device = self.collection.device
        per_metric: Dict[str, Dict[str, Any]] = {
            name: {} for name in self.collection._metrics
        }
        for key, value in flat.items():
            name, _, state = key.partition("/")
            if name in per_metric:
                # Spill checkpoints hold host numpy: back onto the group's
                # device, bit-exact, dtype kept.
                per_metric[name][state] = torch.as_tensor(value, device=device)
        for name, states in per_metric.items():
            if states:
                self.collection._slice_members[f"{name}@{seat}"].load_state_dict(states)

    def seat_compute(self, seat: int) -> Dict[str, Any]:
        return {
            name: self.collection._slice_members[f"{name}@{seat}"].compute()
            for name in self.collection._metrics
        }


# Session lifecycle states.
ACTIVE = "active"
SPILLED = "spilled"
QUARANTINED = "quarantined"
CLOSED = "closed"


@dataclass
class Session:
    """One tenant's registration: lifecycle state plus (while resident)
    the group/seat holding its metric states."""

    tenant: str
    signature: Tuple[Any, ...]
    state: str = ACTIVE
    group: Optional[TenantGroup] = None
    seat: int = -1
    batches: int = 0
    last_touch: int = 0
    quarantine_reason: str = ""
    extras: Dict[str, Any] = field(default_factory=dict)

    @property
    def resident(self) -> bool:
        return self.group is not None


class SessionRegistry:
    """Tenant → session map with signature-coalesced seating and the
    per-signature shared-program cache.

    Not thread-safe on its own; :class:`~torcheval_tpu_torch.serve.service.
    EvalService` serializes access under its lock.
    """

    def __init__(
        self,
        *,
        group_width: int = DEFAULT_GROUP_WIDTH,
        bucket: bool = True,
        program_cache: Optional[LruCache] = None,
    ) -> None:
        if group_width < 1:
            raise ValueError(f"group_width must be >= 1, got {group_width}")
        self._group_width = int(group_width)
        self._bucket = bool(bucket)
        self._groups: Dict[Tuple[Any, ...], List[TenantGroup]] = {}
        self._templates: Dict[Tuple[Any, ...], Dict[str, Metric]] = {}
        # Bounded by COMPILE_CACHE_CAP like the engine's graph caches,
        # evictions on the telemetry bus.
        self._programs = (
            program_cache
            if program_cache is not None
            else LruCache(name="serve_programs", telemetry_events=True)
        )
        self._sessions: Dict[str, Session] = {}
        self._clock = 0

    # -- lifecycle --------------------------------------------------------
    def open(
        self,
        tenant: str,
        metrics: Mapping[str, Metric],
        *,
        signature: Optional[Tuple[Any, ...]] = None,
    ) -> Session:
        """Register ``tenant`` and seat it on a (possibly shared) group.
        The tenant's current metric states are adopted into its seat, so
        opening with pre-accumulated metrics resumes them."""
        existing = self._sessions.get(tenant)
        if existing is not None and existing.state != CLOSED:
            raise ValueError(f"tenant {tenant!r} already has an open session")
        if not metrics:
            raise ValueError("open() requires at least one metric")
        sig = signature if signature is not None else signature_of(metrics)
        if sig not in self._templates:
            self._templates[sig] = {n: copy.deepcopy(m) for n, m in metrics.items()}
        session = Session(tenant=tenant, signature=sig)
        self._sessions[tenant] = session
        self.attach(session)
        for name, metric in metrics.items():
            session.group.collection._slice_members[
                f"{name}@{session.seat}"
            ].load_state_dict(metric.state_dict())
        return session

    def attach(self, session: Session) -> None:
        """Seat a session on a group with a free slot, creating an
        overflow group when the signature's groups are all full."""
        groups = self._groups.setdefault(session.signature, [])
        group = next((g for g in groups if g.free), None)
        if group is None:
            group = TenantGroup(
                session.signature,
                self._templates[session.signature],
                self._group_width,
                bucket=self._bucket,
            )
            groups.append(group)
        session.seat = group.acquire(session.tenant)
        session.group = group
        session.state = ACTIVE
        self.touch(session)

    def release(self, session: Session) -> None:
        """Free the session's seat (resetting its clones).  The caller sets
        the session's next lifecycle state."""
        if session.group is not None:
            session.group.release(session.seat)
        session.group = None
        session.seat = -1

    def session(self, tenant: str) -> Optional[Session]:
        return self._sessions.get(tenant)

    def sessions(self) -> Dict[str, Session]:
        return dict(self._sessions)

    def touch(self, session: Session) -> None:
        self._clock += 1
        session.last_touch = self._clock

    def forget(self, session: Session) -> None:
        """Drop a session from the registry entirely (seat freed, map entry
        removed) WITHOUT touching its spill namespace: the durable state
        now belongs elsewhere, so ``close()``'s namespace deletion must not
        run here."""
        self.release(session)
        self._sessions.pop(session.tenant, None)

    def resident_lru(self) -> List[Session]:
        """Resident sessions, least-recently-touched first."""
        return sorted(
            (s for s in self._sessions.values() if s.resident),
            key=lambda s: s.last_touch,
        )

    # -- dispatch ---------------------------------------------------------
    def bundle(self, group: TenantGroup) -> _ApplyBundle:
        """The shared program for ``group``'s signature (and the current
        health flag), built on first use and LRU-bounded."""
        health = _health.ENABLED
        # The route token joins the key so a flag flip (or a
        # routing_autotune epoch bump after a new measurement) rebuilds
        # the bundle instead of reusing a stale route.
        key = (group.signature, group.width, health, _mega_plan.route_token())

        def factory() -> _ApplyBundle:
            template = MetricCollection(
                {
                    n: copy.deepcopy(m)
                    for n, m in self._templates[group.signature].items()
                },
                bucket=self._bucket,
                donate=False,
                slices=group.width,
            )
            return _build_bundle(template, health)

        return self._programs.get_or_create(key, factory)

    def dispatch(
        self,
        session: Session,
        args: Tuple[Any, ...],
        kwargs: Dict[str, Any],
    ) -> None:
        """Apply one batch to ``session``'s seat through the shared bundle.
        Raises whatever the update (or the data-health monitor) raises; the
        batch may already be installed when a health escalation fires:
        callers snapshot and restore around this (the service's quarantine
        path)."""
        if session.group is None:
            raise RuntimeError(
                f"tenant {session.tenant!r} is not resident (state={session.state})"
            )
        if not args:
            raise TypeError("dispatch requires at least one batch array")
        group = session.group
        col = group.collection
        kwargs = dict(kwargs)
        kwargs["slice_ids"] = torch.full(
            (_rows(args[0]),), session.seat, dtype=torch.int32, device=col.device
        )
        args, kwargs = col._prepare(tuple(args), kwargs)
        bundle = self.bundle(group)
        before = col._read_states()
        pending = (
            _perfscope.begin(
                "serve_group", (group.signature, group.width, bundle.health), col.device
            )
            if _perfscope.ENABLED
            else None
        )
        new_states, health_stats = bundle.apply(before, args, kwargs)
        col._install_states(new_states)
        if _perfscope.ENABLED and pending is not None:
            # Priced once per (signature, width, health), from the
            # dispatch that just ran.
            profiled = _perfscope.profile_program(
                pending, before, new_states, batch_args=(args, kwargs)
            )
            if profiled is not None and _metering.ENABLED:
                # The roofline price becomes the metering ledger's per-call
                # device-time charge for this shared program.
                _metering.record_program_price(
                    _metering.program_id((group.signature, group.width)), profiled
                )
        if health_stats is not None:
            # After install, as in fused_update: the service undoes the
            # poisoned install from its pre-dispatch snapshot.
            # tpulint: disable=TPU001 -- health_stats is non-None only when the program was built with health=_health.ENABLED
            _health.inspect(health_stats, source="serve_group", bounds=bundle.bounds)

    # -- seat state -------------------------------------------------------
    def seat_state_dict(self, session: Session) -> Dict[str, Any]:
        self._require_resident(session)
        return session.group.seat_state_dict(session.seat)

    def load_seat(self, session: Session, flat: Mapping[str, Any]) -> None:
        self._require_resident(session)
        session.group.load_seat(session.seat, flat)

    def compute(self, session: Session) -> Dict[str, Any]:
        self._require_resident(session)
        return session.group.seat_compute(session.seat)

    def _require_resident(self, session: Session) -> None:
        if session.group is None:
            raise RuntimeError(
                f"tenant {session.tenant!r} is not resident (state={session.state})"
            )

    # -- introspection ----------------------------------------------------
    def program_cache_info(self):
        return self._programs.cache_info()

    def group_count(self) -> int:
        return sum(len(gs) for gs in self._groups.values())


__all__ = [
    "ACTIVE",
    "CLOSED",
    "DEFAULT_GROUP_WIDTH",
    "QUARANTINED",
    "SPILLED",
    "Session",
    "SessionRegistry",
    "TenantGroup",
    "signature_of",
]
