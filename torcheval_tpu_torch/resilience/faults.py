"""Deterministic fault injection for the chaos tests (the port of
``torcheval_tpu/resilience/faults.py``).

A :class:`FaultPlan` is a set of :class:`FaultRule` entries keyed by
*site* name.  Hook sites live inside the library at the places a real
fault would land; each is the same one-branch guard the telemetry bus and
the data-health monitor use (``if _faults.ENABLED: _faults.fire(...)``),
so with no plan installed (the default) the hot path pays one module
attribute read and one branch and never calls into this module.

The port's sites:

``collective``
    Each attempt of an object collective inside
    :class:`~torcheval_tpu_torch.resilience.retry.ResilientGroup`
    (context: ``op``, ``attempt``).  ``action="raise"`` drops the attempt,
    ``action="delay"`` stalls it.
``sync.dispatch``
    Each attempt of a synced update (``parallel/sync.py``'s
    ``make_synced_update``; context: ``op``), after the rank's local
    kernel and before it enters the collective, so a rank that fails and
    retries joins the same round its peers wait in.
``checkpoint.write``
    Inside ``CheckpointManager.save`` (context: ``generation``,
    ``nbytes``).  ``action="tear"`` leaves a torn data file of ``offset``
    bytes behind, as a crash would, then raises.

The JAX package's other sites (``prefetch.produce``, ``engine.scan``,
``engine.batch``, ``serve.*``, ``merge.level``) come with the modules
that hold them; every action they use is accepted here already.
:func:`corrupt_batch` is what the ``engine.batch`` site applies for
``action="corrupt"``; callers may apply it themselves until then.

Reproducibility: probabilistic rules (``probability < 1``) draw from a
``numpy`` generator seeded by ``FaultPlan(seed=)``; draws are consumed in
site-hit order under a lock, so the same plan over the same workload
fires at the same hit indices every run.  The ranks of a ``LocalWorld``
hit a site in an order the scheduler picks: key a rule for such a world on
``on_attempt`` with ``count`` set to the world size, never on hit order.

Plans activate as context managers (``with FaultPlan([...]):``) or from
the environment: ``TORCHEVAL_TPU_TORCH_FAULT_PLAN='[{"site": "collective",
"on_attempt": 1}]'`` installs a plan at import (one JSON object or a list
of them; keys mirror the :class:`FaultRule` fields).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from torcheval_tpu_torch import _flags
from torcheval_tpu_torch.telemetry import flightrec as _flightrec

# The one-branch guard flag.  True exactly while a plan is installed.
ENABLED: bool = False

_ACTIVE: Optional["FaultPlan"] = None
_lock = threading.Lock()

_ACTIONS = ("raise", "delay", "tear", "corrupt", "drop_rank", "slow_rank")


class InjectedFault(RuntimeError):
    """Raised by an ``action="raise"`` (or ``"tear"``) rule — typed so
    chaos tests can tell injected failures from real ones."""

    def __init__(self, site: str, message: str = "") -> None:
        self.site = site
        super().__init__(message or f"injected fault at site {site!r}")


class DroppedRank(InjectedFault):
    """Raised by an ``action="drop_rank"`` rule at a ``merge.level``
    site: the matched rank "vanishes" — the merge layer catches this at
    its top level and simply stops participating (no sends, no acks),
    which is what a preempted host looks like to its peers."""

    def __init__(self, site: str, rank: int, message: str = "") -> None:
        self.rank = rank
        super().__init__(
            site, message or f"rank {rank} dropped at site {site!r}"
        )


@dataclass
class FaultRule:
    """One injection rule.  A rule matches a :func:`fire` call when the
    site names are equal, every provided context filter (``on_attempt``,
    ``match``) agrees, the hit index at that site is past ``after``, the
    rule has fired fewer than ``count`` times, and the seeded coin
    (``probability``) lands."""

    site: str
    action: str = "raise"       # one of _ACTIONS
    after: int = 0              # skip the first `after` matching hits
    count: Optional[int] = 1    # max firings (None = unlimited)
    on_attempt: Optional[int] = None  # only when ctx["attempt"] == this
    match: Dict[str, Any] = field(default_factory=dict)  # ctx equality
    probability: float = 1.0    # seeded draw per eligible hit
    delay_s: float = 0.01       # action="delay"
    offset: int = 0             # action="tear": torn-write byte offset
    message: str = ""

    def __post_init__(self) -> None:
        if self.action not in _ACTIONS:
            raise ValueError(
                f"action must be one of {_ACTIONS}, got {self.action!r}"
            )
        if not 0.0 <= self.probability <= 1.0:
            raise ValueError(
                f"probability must be in [0, 1], got {self.probability}"
            )


@dataclass
class FiredFault:
    """Journal entry: one rule firing (``FaultPlan.fired``)."""

    site: str
    action: str
    hit: int                    # per-site hit index (0-based)
    context: Dict[str, Any]


class FaultPlan:
    """A seeded set of rules, installable as a context manager.

    Only one plan can be active at a time (nesting would make the
    seeded schedule ambiguous).  The plan journals every firing in
    ``self.fired`` and counts site hits in ``self.hits`` so tests can
    assert exactly what chaos happened.
    """

    def __init__(
        self,
        rules: Sequence[Union[FaultRule, Dict[str, Any]]],
        *,
        seed: int = 0,
    ) -> None:
        self.rules: List[FaultRule] = [
            r if isinstance(r, FaultRule) else FaultRule(**r) for r in rules
        ]
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self.hits: Dict[str, int] = {}
        self.fired: List[FiredFault] = []
        self._fired_counts: Dict[int, int] = {}

    # -- installation ----------------------------------------------------
    def install(self) -> "FaultPlan":
        global ENABLED, _ACTIVE
        with _lock:
            if _ACTIVE is not None:
                raise RuntimeError(
                    "a FaultPlan is already active; plans do not nest"
                )
            _ACTIVE = self
            ENABLED = True
        return self

    def uninstall(self) -> None:
        global ENABLED, _ACTIVE
        with _lock:
            if _ACTIVE is self:
                _ACTIVE = None
                ENABLED = False

    def __enter__(self) -> "FaultPlan":
        return self.install()

    def __exit__(self, *exc_info: Any) -> None:
        self.uninstall()

    # -- matching --------------------------------------------------------
    def _match(
        self, site: str, ctx: Dict[str, Any]
    ) -> Optional[FaultRule]:
        """One site hit: bump the hit counter, return the firing rule
        (first match wins) or None.  Caller holds ``_lock``."""
        hit = self.hits.get(site, 0)
        self.hits[site] = hit + 1
        for idx, rule in enumerate(self.rules):
            if rule.site != site:
                continue
            if rule.on_attempt is not None and (
                ctx.get("attempt") != rule.on_attempt
            ):
                continue
            if any(ctx.get(k) != v for k, v in rule.match.items()):
                continue
            if hit < rule.after:
                continue
            if (
                rule.count is not None
                and self._fired_counts.get(idx, 0) >= rule.count
            ):
                continue
            if rule.probability < 1.0 and (
                self._rng.random() >= rule.probability
            ):
                continue
            self._fired_counts[idx] = self._fired_counts.get(idx, 0) + 1
            self.fired.append(
                FiredFault(
                    site=site, action=rule.action, hit=hit, context=dict(ctx)
                )
            )
            return rule
        return None


def active() -> Optional[FaultPlan]:
    return _ACTIVE


def fire(site: str, **ctx: Any) -> Optional[FaultRule]:
    """The hook-site entry point.  Callers MUST branch on :data:`ENABLED`
    first (the zero-cost contract); this function does not re-check.

    ``action="raise"`` raises :class:`InjectedFault`; ``"drop_rank"``
    raises :class:`DroppedRank` (carrying ``ctx["rank"]``); ``"delay"``
    and ``"slow_rank"`` sleep ``delay_s`` and return None;
    ``"tear"``/``"corrupt"`` return the matched rule so the site applies
    the data transformation itself.
    """
    plan = _ACTIVE
    if plan is None:  # pragma: no cover - uninstall race
        return None
    with _lock:
        rule = plan._match(site, ctx)
    if rule is None:
        return None
    if _flightrec.ENABLED:
        # Snapshot BEFORE the action lands: for "raise"/"drop_rank" the
        # post-fault state is an unwound stack, so the bundle's value is
        # the ring tail leading up to the injection.
        _flightrec.trigger(
            "fault_fired",
            f"site={site} action={rule.action}",
            extra={"fault": {"site": site, "action": rule.action,
                             "context": {k: repr(v) for k, v in ctx.items()}}},
        )
    if rule.action == "raise":
        raise InjectedFault(site, rule.message)
    if rule.action == "drop_rank":
        raise DroppedRank(site, int(ctx.get("rank", -1)), rule.message)
    if rule.action in ("delay", "slow_rank"):
        import time

        time.sleep(rule.delay_s)
        return None
    return rule  # "tear" / "corrupt": the caller transforms its data


def corrupt_batch(args: Sequence[Any]) -> tuple:
    """Apply an ``action="corrupt"`` rule: return ``args`` with a NaN
    written into element 0 of the first floating-point tensor.  The tensor
    is cloned on its own device (a batch on the GPU never visits the
    host); the caller's tensor is left as it was.  A numpy array is
    copied as in the JAX package."""
    out = list(args)
    for i, a in enumerate(out):
        if isinstance(a, torch.Tensor):
            if a.dtype.is_floating_point and a.numel():
                a = a.clone()
                a.view(-1)[0] = float("nan")
                out[i] = a
                break
            continue
        arr = np.asarray(a)
        if np.issubdtype(arr.dtype, np.floating) and arr.size:
            arr = np.array(arr)  # owned copy
            arr.reshape(-1)[0] = np.nan
            out[i] = arr
            break
    return tuple(out)


def install_from_env() -> Optional[FaultPlan]:
    """Install a plan from ``TORCHEVAL_TPU_TORCH_FAULT_PLAN`` (JSON: one rule
    object or a list of them; an object may carry a ``seed`` key when
    wrapped as ``{"seed": n, "rules": [...]}``).  Returns the installed
    plan, or None when the variable is unset/empty."""
    spec = _flags.get_json("FAULT_PLAN")
    if spec is None:
        return None
    seed = 0
    if isinstance(spec, dict) and "rules" in spec:
        seed = int(spec.get("seed", 0))
        spec = spec["rules"]
    if isinstance(spec, dict):
        spec = [spec]
    return FaultPlan(spec, seed=seed).install()


# Env-driven activation at import so `TORCHEVAL_TPU_TORCH_FAULT_PLAN=...
# python eval.py` needs no code change (as TORCHEVAL_TPU_TORCH_TELEMETRY).
install_from_env()
