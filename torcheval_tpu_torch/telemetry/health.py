"""Streaming data-health monitor: NaN/Inf counts, all-constant inputs,
out-of-range labels and zero-weight batches (the port of
``torcheval_tpu/telemetry/health.py``).

A production eval loop can silently absorb a corrupted feed: one host
streaming NaNs poisons every counter it merges into.  When enabled,
``MetricCollection.fused_update`` reduces the batch's positional arguments
on their device, and the host folds the figures into
:class:`~torcheval_tpu_torch.telemetry.events.DataHealthEvent` emissions
(:func:`inspect`), after the update's states are installed.  The JAX
package computes its figures as XLA reductions inside the jitted update,
outside any kernel; here they are plain torch reductions queued beside
the update.  Every counting lifecycle is host-bound, so an update reads
back ONCE: :func:`stats_for_update` screens each tensor with one min/max
pass (a NaN or an Inf shows in a float tensor's min or max, an
out-of-range label in a label tensor's) and packs the screen into one
tensor; only a batch the screen flags is counted exactly
(:func:`batch_stats`, the JAX package's figures) with a second read back.
The findings are the JAX package's either way.

Checks
------
* ``nan`` / ``inf``: non-finite elements in any float argument (masked
  rows excluded, so bucketing pad rows can never count);
* ``constant``: every valid element of a float argument equal (a stuck
  feature feed), counted in batches;
* ``label_range``: negative labels in any integer argument (input-level),
  plus, for every member that declares a class count, the labels
  ``>= num_classes`` (a label legal for a 1000-class member is corrupt for
  a 10-class member sharing the batch);
* ``zero_weight``: a batch whose validity mask has no live rows, or whose
  ``weight=`` argument sums to zero over live rows.

Zero-cost-when-off: every hook site is ``if _health.ENABLED:``; off, the
update runs exactly as it did before this module.  Findings are emitted
into the telemetry ring whatever the bus's own flag says, so
``health.enable()`` alone is a complete monitor.

Policy: ``enable(raise_on_corrupt=True)`` turns findings in
:data:`CORRUPT_CHECKS` into a :class:`DataCorruptionError`, raised after
the batch was applied (the monitor observes, it does not gate), so metric
states stay consistent.

Example::

    from torcheval_tpu_torch.telemetry import health

    health.enable()                      # or TORCHEVAL_TPU_TORCH_DATA_HEALTH=1
    ... run the eval loop ...
    print(telemetry.report()["data_health"])
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from torcheval_tpu_torch import _flags
from torcheval_tpu_torch.telemetry import events as _events
from torcheval_tpu_torch.telemetry import flightrec as _flightrec

# Module-level flags: hook sites read these as plain attributes (the
# one-branch zero-overhead contract, see events.ENABLED).
ENABLED: bool = _flags.get("DATA_HEALTH")
RAISE_ON_CORRUPT: bool = _flags.get("DATA_HEALTH_RAISE")

# Checks that escalate to DataCorruptionError under raise_on_corrupt.
# "constant" and "zero_weight" are suspicious, not corrupt: a stuck feed
# or an empty batch degrades signal but cannot poison a merge.
CORRUPT_CHECKS = frozenset({"nan", "inf", "label_range"})


class DataCorruptionError(RuntimeError):
    """Raised (under ``enable(raise_on_corrupt=True)``) when a batch
    carried data in :data:`CORRUPT_CHECKS`; carries the emitted findings
    on ``.findings``."""

    def __init__(self, source: str, findings: List[Dict[str, Any]]) -> None:
        self.findings = findings
        detail = "; ".join(
            f"{f['check']}"
            + (f"[{f['metric']}]" if f["metric"] else "")
            + f" x{f['count']} in arg {f['arg']}"
            for f in findings
        )
        super().__init__(
            f"data-health monitor found corrupt input at {source}: {detail}"
        )


def enable(*, raise_on_corrupt: Optional[bool] = None) -> None:
    """Turn the monitor on (equivalently ``TORCHEVAL_TPU_TORCH_DATA_HEALTH=1``)."""
    global ENABLED, RAISE_ON_CORRUPT
    if raise_on_corrupt is not None:
        RAISE_ON_CORRUPT = bool(raise_on_corrupt)
    ENABLED = True


def disable() -> None:
    """Turn the monitor off: hook sites go back to one cold branch."""
    global ENABLED
    ENABLED = False


def enabled() -> bool:
    return ENABLED


def label_bounds(metrics: Dict[str, Any]) -> Tuple[Tuple[str, int], ...]:
    """The (member name, num_classes) pairs the label-range check
    attributes against: every member declaring an integer class count."""
    out = []
    for name, m in metrics.items():
        nc = getattr(m, "num_classes", None)
        if isinstance(nc, int) and nc > 0:
            out.append((name, nc))
    return tuple(out)


# ------------------------------------------------------------ device side
def _count(hits: torch.Tensor) -> torch.Tensor:
    """The number of True elements, as int32, the JAX package's dtype.  A
    CUDA sum of bool copies it to the result's dtype first: int32 halves
    that copy's bytes against the default int64."""
    return hits.sum(dtype=torch.int32)


def _is_int(t: torch.Tensor) -> bool:
    return not (t.dtype.is_floating_point or t.dtype.is_complex or t.dtype == torch.bool)


def batch_stats(
    args: Tuple[Any, ...],
    mask: Optional[torch.Tensor],
    bounds: Tuple[Tuple[str, int], ...],
) -> Dict[str, Any]:
    """Scalar reductions over one batch's positional arguments, as 0-d
    tensors on the batch's device (nothing is read back here).

    ``mask`` is the bucketing validity row mask (or ``None``); masked rows
    are excluded from every reduction.  ``bounds`` is :func:`label_bounds`'
    output.  The structure is the JAX package's: ``{"args": (per-arg dict
    or None, ...)}`` plus ``"live_rows"`` with a mask."""

    def row_mask_for(a):
        return mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim())) > 0

    per_arg: List[Optional[Dict[str, Any]]] = []
    for a in args:
        if not isinstance(a, torch.Tensor):
            per_arg.append(None)
            continue
        if a.dtype.is_floating_point:
            if mask is not None:
                live = row_mask_for(a)
                nan_count = _count(torch.isnan(a) & live)
                inf_count = _count(torch.isinf(a) & live)
                valid = _count(live.expand(a.shape))
                lo = a.masked_fill(~live, float("inf")).amin() if a.numel() else None
                hi = a.masked_fill(~live, float("-inf")).amax() if a.numel() else None
            else:
                # Maskless: the scan covers every row; a NaN in a pad row
                # is still a corrupt input buffer.
                nan_count = _count(torch.isnan(a))
                inf_count = _count(torch.isinf(a))
                valid = a.numel()
                lo, hi = torch.aminmax(a) if a.numel() else (None, None)
            if lo is None:
                # An empty batch: nothing to compare.
                constant = torch.zeros((), dtype=torch.int32, device=a.device)
            else:
                # NaN compares unequal, so a NaN-bearing batch is never
                # "constant"; a single-element batch is trivially not.
                constant = ((hi == lo) & (valid > 1)).to(torch.int32)
            per_arg.append(
                {"nan": nan_count, "inf": inf_count, "constant": constant, "valid": valid}
            )
        elif _is_int(a):
            live = None if mask is None else row_mask_for(a)

            def count(hit):
                return _count(hit & live if live is not None else hit)

            neg = count(a < 0)
            # One reduction for each distinct class count, shared by the
            # members that declare it.
            ge_by_nc: Dict[int, torch.Tensor] = {}
            for _name, nc in bounds:
                if nc not in ge_by_nc:
                    ge_by_nc[nc] = count(a >= nc)
            per_arg.append({"neg": neg, "ge": tuple(ge_by_nc[nc] for _n, nc in bounds)})
        else:
            per_arg.append(None)
    out: Dict[str, Any] = {"args": tuple(per_arg)}
    if mask is not None:
        out["live_rows"] = _count(mask > 0)
    return out


@dataclass
class HealthScreen:
    """One update's screen (:func:`stats_for_update`): each tensor
    argument's min and max over its live rows, the live rows and the
    weight total, packed in ONE float64 tensor on the batch's device.
    Finite floats and labels inside every bound mean the batch holds no
    NaN, no Inf and no out-of-range label, so one min/max pass a tensor
    stands in for the counting passes; :func:`inspect` counts exactly
    (:func:`batch_stats`, a second read back) only when the screen finds
    something."""

    args: Tuple[Any, ...]
    mask: Optional[torch.Tensor]
    kinds: Tuple[Optional[str], ...]  # "float" | "int" | None, per argument
    packed: Optional[torch.Tensor]
    has_weight: bool


def _row_mask(mask: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return mask.reshape(mask.shape + (1,) * (a.dim() - mask.dim())) > 0


def _weight_total(weight: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    w = weight.abs()
    if mask is not None:
        w = w * _row_mask(mask, w).to(w.dtype)
    return w.sum()


def stats_for_update(
    args: Tuple[Any, ...],
    kwargs: Dict[str, Any],
    bounds: Tuple[Tuple[str, int], ...],
) -> HealthScreen:
    """The :class:`HealthScreen` of one fused-update call (``mask=`` and
    ``weight=`` read from ``kwargs``): nothing is read back here.  The JAX
    package returns :func:`batch_stats`' figures plus the weight total
    here; the port screens first, and :func:`inspect` takes either."""
    mask = kwargs.get("mask")
    weight = kwargs.get("weight")
    kinds: List[Optional[str]] = []
    parts: List[torch.Tensor] = []
    for a in args:
        kind = None
        if isinstance(a, torch.Tensor) and a.numel():
            kind = "float" if a.dtype.is_floating_point else "int" if _is_int(a) else None
        kinds.append(kind)
        if kind is None:
            continue
        if mask is None:
            parts += torch.aminmax(a)
        elif kind == "float":
            dead = ~_row_mask(mask, a)
            parts += [a.masked_fill(dead, float("inf")).amin(),
                      a.masked_fill(dead, float("-inf")).amax()]
        else:  # a masked label reads as 0, inside every bound
            parts += torch.aminmax(a.masked_fill(~_row_mask(mask, a), 0))
    if mask is not None:
        parts.append(_count(mask > 0))
    if isinstance(weight, torch.Tensor):
        parts.append(_weight_total(weight, mask))
    packed = torch.stack([p.to(torch.float64) for p in parts]) if parts else None
    return HealthScreen(tuple(args), mask, tuple(kinds), packed, isinstance(weight, torch.Tensor))


# ------------------------------------------------------------- host fold
def _to_host(t: torch.Tensor):
    """One read back (every figure :func:`inspect` reads crosses here)."""
    return t.cpu().numpy()


def _leaves(stats: Dict[str, Any]) -> List[Tuple[Tuple[Any, ...], torch.Tensor]]:
    """Every (path, tensor) figure of :func:`batch_stats`' dict, in one order."""
    out = []
    for i, entry in enumerate(stats["args"]):
        if entry is None:
            continue
        if "nan" in entry:
            out += [((i, k), entry[k]) for k in ("nan", "inf", "constant")]
        else:
            out.append(((i, "neg"), entry["neg"]))
            out += [((i, "ge", j), g) for j, g in enumerate(entry["ge"])]
    for key in ("live_rows", "weight_total"):
        if key in stats:
            out.append(((key,), stats[key]))
    return out


def _read_back(stats: Dict[str, Any]) -> Dict[Tuple[Any, ...], Any]:
    """Every figure of ``stats`` on the host, through ONE int64 tensor and
    one copy.  A leaf keeps its leading step axis, if it has one (the
    engine's stacked scan steps); ``weight_total`` travels as its
    nonzero flag, which is all the zero-weight check reads."""
    leaves = _leaves(stats)
    if not leaves:
        return {}
    flat = [
        (t != 0 if path == ("weight_total",) else t).reshape(-1).to(torch.int64)
        for path, t in leaves
    ]
    host = _to_host(torch.cat([f.to(flat[0].device) for f in flat]))
    out, at = {}, 0
    for (path, t), f in zip(leaves, flat):
        n = f.numel()
        out[path] = host[at] if t.dim() == 0 else host[at:at + n]
        at += n
    return out


def _screen_figures(
    screen: HealthScreen, bounds: Tuple[Tuple[str, int], ...]
) -> Dict[Tuple[Any, ...], Any]:
    """The figures :func:`inspect` folds, from one read back of the screen;
    exact counts (a second read back) only where it found something."""
    vals = _to_host(screen.packed) if screen.packed is not None else []
    spans: Dict[int, Tuple[float, float]] = {}
    suspicious = False
    at = 0
    for i, kind in enumerate(screen.kinds):
        if kind is None:
            continue
        lo, hi = float(vals[at]), float(vals[at + 1])
        at += 2
        spans[i] = (lo, hi)
        if kind == "float":
            suspicious |= not (math.isfinite(lo) and math.isfinite(hi))
        else:
            suspicious |= lo < 0 or any(hi >= nc for _name, nc in bounds)
    host: Dict[Tuple[Any, ...], Any] = {}
    if screen.mask is not None:
        host[("live_rows",)] = vals[at]
        at += 1
    if screen.has_weight:
        host[("weight_total",)] = vals[at]
    if suspicious:
        host.update(_read_back(batch_stats(screen.args, screen.mask, bounds)))
        return host
    for i, (lo, hi) in spans.items():
        a = screen.args[i]
        if screen.kinds[i] == "float":
            valid = a.numel()
            if screen.mask is not None:
                valid = int(host[("live_rows",)]) * (a.numel() // screen.mask.numel())
            host[(i, "nan")] = host[(i, "inf")] = 0
            # NaN never reaches here; a single element is trivially not constant.
            host[(i, "constant")] = int(hi == lo and valid > 1)
        else:
            host[(i, "neg")] = 0
            for j in range(len(bounds)):
                host[(i, "ge", j)] = 0
    return host


def _scalar(value: Any, steps: Optional[int], reduce: str) -> float:
    """Collapse one (possibly step-stacked) figure to a float; ``steps``
    limits the reduction to the first N steps (the real batches)."""
    v = np.asarray(value)
    if v.ndim == 0:
        return float(v)
    v = v[:steps] if steps is not None else v
    if v.size == 0:
        return 0.0
    return float(v.sum() if reduce == "sum" else v.min())


def inspect(
    stats: Union[HealthScreen, Dict[str, Any]],
    *,
    source: str,
    bounds: Tuple[Tuple[str, int], ...],
    steps: Optional[int] = None,
) -> List[Dict[str, Any]]:
    """Read one update's figures back, emit a :class:`DataHealthEvent` per
    finding, and apply the raise-on-corrupt policy.  ``stats`` is a
    :class:`HealthScreen` (one read back; a second only when it finds
    something) or :func:`batch_stats`' figures (one read back; ``steps``
    is the number of real steps of step-stacked figures).  Returns the
    findings, in the JAX package's order."""
    if isinstance(stats, HealthScreen):
        host, kinds = _screen_figures(stats, bounds), stats.kinds
    else:
        host = _read_back(stats)
        kinds = tuple(None if e is None else "float" if "nan" in e else "int"
                      for e in stats["args"])
    findings: List[Dict[str, Any]] = []

    def find(check: str, metric: str, arg: int, count: float) -> None:
        count = int(count)
        if count > 0:
            findings.append({"check": check, "metric": metric, "arg": arg, "count": count})

    for i, kind in enumerate(kinds):
        if kind == "float":
            for check in ("nan", "inf", "constant"):
                find(check, "", i, _scalar(host[(i, check)], steps, "sum"))
        elif kind == "int":
            find("label_range", "", i, _scalar(host[(i, "neg")], steps, "sum"))
            for j, (name, _nc) in enumerate(bounds):
                find("label_range", name, i, _scalar(host[(i, "ge", j)], steps, "sum"))
    for key in ("live_rows", "weight_total"):
        # min over real steps: any real batch with zero live rows or weight.
        if (key,) in host and _scalar(host[(key,)], steps, "min") == 0:
            findings.append({"check": "zero_weight", "metric": "", "arg": -1, "count": 1})
    for f in findings:
        _events.record_data_health(f["check"], source, f["metric"], f["arg"], f["count"])
    if RAISE_ON_CORRUPT:
        corrupt = [f for f in findings if f["check"] in CORRUPT_CHECKS]
        if corrupt:
            if _flightrec.ENABLED:
                # Dump before the raise unwinds the caller: the bundle's
                # tail shows which updates fed the corrupt batch.
                _flightrec.trigger(
                    "data_corruption",
                    f"source={source} " + ",".join(sorted({f["check"] for f in corrupt})),
                    extra={"corruption": {"source": source, "findings": corrupt}},
                )
            raise DataCorruptionError(source, corrupt)
    return findings
