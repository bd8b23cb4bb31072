"""Per-tenant metering: the serve plane's cost-attribution ledger (the port
of ``torcheval_tpu/serve/metering.py``).

The serve layer coalesces many tenants onto shared group programs —
which is exactly what makes per-process telemetry blind to the question
operators actually ask: *which tenant* is eating the queue, the spill
churn, and the shared program's device time?  This module keeps an
always-on (one-branch zero-cost-off) per-tenant ledger maintained by
:class:`~torcheval_tpu_torch.serve.service.EvalService` hook sites:

* **Traffic** — submits (admitted / shed / rejected), dispatched
  batches, valid rows, payload bytes, and the per-tenant queue depth
  observed at the last admission decision.
* **Lifecycle** — quarantine, spill, and resume counts (spill + resume
  is the churn signal the placement tier consumes).
* **Latency** — queue-wait and end-to-end (enqueue → dispatch complete)
  quantiles.  Raw samples are appended to a bounded host-side pending
  list on the hot path and folded into
  :class:`~torcheval_tpu_torch.monitor.StreamDigest` ladders lazily at
  snapshot time, so the mergeable digest machinery prices nothing per
  batch.  The digests live on the CPU: the samples are host clocks, and
  the ledger never launches on the card.
* **Device-time attribution** — every dispatch through a shared group
  program charges its tenant's valid rows against that program's row
  and seconds totals.  A program's seconds are its perfscope roofline
  price per call when :func:`record_program_price` saw a profile
  (``max(bytes/HBM-peak, flops/FLOP-peak)`` from the
  ``ProgramProfileEvent`` figures; the port prices bytes only, see
  :mod:`torcheval_tpu_torch.telemetry.perfscope`), measured dispatch wall
  clock otherwise.  Per-tenant device-seconds are the program totals split by
  row share — they conserve each program's total *by construction*, the
  invariant ``tests/test_torch_metering.py`` pins to 1e-6 relative.
  A tenant holding more than ``dominance_share`` of a shared program's
  rows is the **noisy neighbor**; the verdict names the program.

Enablement is the ``TORCHEVAL_TPU_TORCH_TENANT_METERING`` tribool: truthy →
on at import, falsy → off, unset → **auto**: off until the first
:class:`EvalService` is constructed (:func:`activate_for_serve`), so
non-serve processes never pay the branch's true side.  Explicit
:func:`enable` / :func:`disable` outrank the auto resolution.

Surfaces: :func:`ledger_rows` feeds ``telemetry.report()["tenants"]``,
the ``torcheval_tpu_tenant_*`` Prometheus families, and the
``--tenants`` CLI table (via :mod:`torcheval_tpu_torch.telemetry.tenants`);
:func:`publish` emits one ``TenantSampleEvent`` per tenant so dumps and
fleet snapshots carry the ledger; :func:`rebalance_hints` returns the
typed per-tenant signal set (queue depth, shed rate, spill churn,
device-seconds) the future placement tier consumes as a stable API.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

from torcheval_tpu_torch import _flags

# One tenant above this share of a shared program's rows is the
# dominant (noisy-neighbor) tenant of that program.
DEFAULT_DOMINANCE_SHARE = 0.5

# Hot-path latency samples wait here (bounded, newest kept) until a
# snapshot folds them into the StreamDigest ladders in fixed-size masked
# chunks (the JAX package's chunking, so the two ledgers fold the same
# samples alike), zero work per dispatch.
_PENDING_CAP = 4096
_FLUSH_CHUNK = 512

_QUANTILES = (0.5, 0.9, 0.99)

_LOCK = threading.RLock()

# Explicit enable()/disable() override; None defers to the flag/auto.
_forced: Optional[bool] = None


def _resolve_enabled() -> bool:
    # Import-time resolution: only an explicit truthy flag turns the
    # hooks on before any serve use; unset stays cold until
    # activate_for_serve().
    return bool(_flags.get_tristate("TENANT_METERING"))


# Module-level flag: hook sites read this as a plain attribute (the
# one-branch zero-overhead contract, see telemetry.events.ENABLED).
ENABLED: bool = _resolve_enabled()


# ------------------------------------------------------------------- control
def enable() -> None:
    """Force metering on, outranking the flag and the serve auto-on."""
    global ENABLED, _forced
    with _LOCK:
        _forced = True
        ENABLED = True


def disable() -> None:
    """Force metering off — hook sites go back to one cold branch.  The
    accumulated ledger is kept (inspect after a run; :func:`reset`
    drops it)."""
    global ENABLED, _forced
    with _LOCK:
        _forced = False
        ENABLED = False


def enabled() -> bool:
    # tpulint: disable=TPU006 -- single racy bool read, same contract as every hook site's plain attribute read
    return ENABLED


def activate_for_serve() -> None:
    """Cold resolver run at ``EvalService`` construction: the unset
    (auto) tribool turns metering on exactly when the serve plane is in
    use.  An explicit flag value or a prior :func:`enable` /
    :func:`disable` call outranks the auto-on."""
    global ENABLED
    with _LOCK:
        if _forced is not None:
            ENABLED = _forced
            return
        mode = _flags.get_tristate("TENANT_METERING")
        ENABLED = True if mode is None else bool(mode)


def reset() -> None:
    """Drop the whole ledger and the forced override (test isolation)."""
    global _forced, ENABLED
    with _LOCK:
        _tenants.clear()
        _programs.clear()
        _program_ids.clear()
        _forced = None
        ENABLED = _resolve_enabled()


# -------------------------------------------------------------------- ledger
class _TenantLedger:
    """Cumulative counters for one tenant (guarded by ``_LOCK``)."""

    __slots__ = (
        "admitted",
        "shed",
        "rejected",
        "dispatched",
        "quarantined",
        "spills",
        "resumes",
        "rows",
        "payload_bytes",
        "queue_depth",
        "pending_wait",
        "pending_e2e",
        "wait_digest",
        "e2e_digest",
    )

    def __init__(self) -> None:
        self.admitted = 0
        self.shed = 0
        self.rejected = 0
        self.dispatched = 0
        self.quarantined = 0
        self.spills = 0
        self.resumes = 0
        self.rows = 0
        self.payload_bytes = 0
        self.queue_depth = 0
        self.pending_wait: List[float] = []
        self.pending_e2e: List[float] = []
        self.wait_digest: Any = None
        self.e2e_digest: Any = None


_tenants: Dict[str, _TenantLedger] = {}

# Shared-program attribution table: interned program id ->
# {"seconds", "rows", "calls", "priced" (roofline price per call, or
# None), "by_tenant": rows per tenant}.
_programs: Dict[str, Dict[str, Any]] = {}
_program_ids: Dict[Any, str] = {}


def program_id(key: Any) -> str:
    """Intern a shared-program identity (the registry's
    ``(signature, width)``) to a short stable-in-process label."""
    with _LOCK:
        pid = _program_ids.get(key)
        if pid is None:
            pid = f"serve_group#{len(_program_ids)}"
            _program_ids[key] = pid
        return pid


def _program_entry(pid: str) -> Dict[str, Any]:
    entry = _programs.get(pid)
    if entry is None:
        entry = {
            "seconds": 0.0,
            "rows": 0,
            "calls": 0,
            "priced": None,
            "by_tenant": {},
        }
        _programs[pid] = entry
    return entry


def payload_nbytes(args: Tuple[Any, ...], kwargs: Dict[str, Any]) -> int:
    """Total bytes of one submission's tensor / array payload: metadata
    only (``.nbytes``), no device traffic.  Only called from hook sites
    after the ``ENABLED`` branch."""
    total = 0
    for leaf in list(args) + list(kwargs.values()):
        total += int(getattr(leaf, "nbytes", 0) or 0)
    return total


def batch_rows(args: Tuple[Any, ...]) -> int:
    """Leading-dimension row count of one submission (0 when unsized).
    Only called from hook sites after the ``ENABLED`` branch."""
    if not args:
        return 0
    shape = getattr(args[0], "shape", None)
    if shape:
        return int(shape[0])
    try:
        return len(args[0])
    except TypeError:
        return 0


# ------------------------------------------------------------------- hooks
# Only called from serve hook sites after their `if _metering.ENABLED:`
# branch (the zero-overhead contract); the helpers do not re-check.
def record_submit(
    tenant: str,
    outcome: str,
    rows: int = 0,
    nbytes: int = 0,
    queue_depth: int = 0,
) -> None:
    """One admission decision: ``outcome`` is ``admitted`` / ``shed`` /
    ``rejected``.  ``queue_depth`` is the TENANT's queued count after
    the decision (the rebalance-hints gauge)."""
    with _LOCK:
        t = _tenants.get(tenant)
        if t is None:
            t = _tenants[tenant] = _TenantLedger()
        if outcome == "admitted":
            t.admitted += 1
            t.payload_bytes += int(nbytes)
        elif outcome == "shed":
            t.shed += 1
        else:
            t.rejected += 1
        t.queue_depth = int(queue_depth)


def record_dispatch(
    tenant: str,
    program: str,
    rows: int,
    seconds: float,
    wait_s: float,
    e2e_s: float,
    queue_depth: Optional[int] = None,
) -> None:
    """One applied batch: charge ``rows`` valid rows of ``program``
    (an interned :func:`program_id`) to ``tenant`` and bank the latency
    samples.  ``seconds`` is the measured dispatch wall clock — the
    fallback price when the program has no roofline price yet.
    ``queue_depth`` (when given) refreshes the tenant's queued-count
    gauge after the pop."""
    with _LOCK:
        t = _tenants.get(tenant)
        if t is None:
            t = _tenants[tenant] = _TenantLedger()
        t.dispatched += 1
        t.rows += int(rows)
        if queue_depth is not None:
            t.queue_depth = int(queue_depth)
        if len(t.pending_wait) >= _PENDING_CAP:
            del t.pending_wait[: _FLUSH_CHUNK]
            del t.pending_e2e[: _FLUSH_CHUNK]
        t.pending_wait.append(float(wait_s))
        t.pending_e2e.append(float(e2e_s))
        entry = _program_entry(program)
        entry["calls"] += 1
        entry["rows"] += int(rows)
        priced = entry["priced"]
        entry["seconds"] += (
            priced if priced is not None else float(seconds)
        )
        by_tenant = entry["by_tenant"]
        by_tenant[tenant] = by_tenant.get(tenant, 0) + int(rows)


def record_program_price(program: str, profile: Dict[str, Any]) -> None:
    """Adopt a perfscope :func:`~torcheval_tpu_torch.telemetry.perfscope.
    profile_program` result as ``program``'s per-call roofline price:
    the binding-roof seconds ``max(bytes/HBM-peak, flops/FLOP-peak)``.
    Later dispatches are charged the price instead of wall clock."""
    from torcheval_tpu_torch.tools import roofline as _roofline

    peaks = _roofline.device_peaks()
    price = max(
        float(profile.get("bytes_accessed", 0)) / (peaks["hbm_gbps"] * 1e9),
        float(profile.get("flops", 0)) / max(peaks["flops"], 1.0),
    )
    with _LOCK:
        _program_entry(program)["priced"] = price


def record_quarantine(tenant: str) -> None:
    """The tenant was quarantined.  Its pre-quarantine ledger —
    including its attributed device-seconds — is kept intact."""
    with _LOCK:
        t = _tenants.get(tenant)
        if t is None:
            t = _tenants[tenant] = _TenantLedger()
        t.quarantined += 1
        t.queue_depth = 0


def record_session(action: str, tenant: str) -> None:
    """Session lifecycle tick; only ``spill`` / ``resume`` meter (their
    sum is the spill-churn rebalance signal)."""
    with _LOCK:
        t = _tenants.get(tenant)
        if t is None:
            t = _tenants[tenant] = _TenantLedger()
        if action == "spill":
            t.spills += 1
        elif action == "resume":
            t.resumes += 1


# ----------------------------------------------------------------- snapshot
def _flush_digests(t: _TenantLedger) -> None:
    """Fold the pending latency samples into the tenant's StreamDigest
    ladders (cold path; fixed-shape masked chunks, on the CPU)."""
    if not t.pending_wait and not t.pending_e2e:
        return
    import numpy as np

    from torcheval_tpu_torch.monitor import StreamDigest

    for attr, pending in (
        ("wait_digest", t.pending_wait),
        ("e2e_digest", t.pending_e2e),
    ):
        if not pending:
            continue
        digest = getattr(t, attr)
        if digest is None:
            digest = StreamDigest(quantiles=_QUANTILES, device="cpu")
            setattr(t, attr, digest)
        for start in range(0, len(pending), _FLUSH_CHUNK):
            chunk = pending[start : start + _FLUSH_CHUNK]
            values = np.zeros(_FLUSH_CHUNK, dtype=np.float32)
            values[: len(chunk)] = chunk
            mask = np.zeros(_FLUSH_CHUNK, dtype=bool)
            mask[: len(chunk)] = True
            digest.update(values, mask=mask)
        del pending[:]


def _quantiles_of(digest: Any) -> Tuple[float, float, float]:
    if digest is None:
        return (0.0, 0.0, 0.0)
    values = digest.compute()
    if values.numel() == 0:
        return (0.0, 0.0, 0.0)
    p50, p90, p99 = (float(v) for v in values)
    return (p50, p90, p99)


def _device_seconds(tenant: str) -> float:
    # Caller holds _LOCK.  Split every program's banked seconds by the
    # tenant's row share — summing over tenants returns each program's
    # total exactly (the conservation invariant).
    total = 0.0
    for entry in _programs.values():
        rows = entry["by_tenant"].get(tenant, 0)
        if rows and entry["rows"]:
            total += entry["seconds"] * rows / entry["rows"]
    return total


def _dominance(
    tenant: str, share: float
) -> Tuple[str, float]:
    # Caller holds _LOCK.  The program (if any) where this tenant's row
    # share crosses the noisy-neighbor threshold; ties go to the
    # largest share.
    worst_pid, worst_share = "", 0.0
    for pid, entry in _programs.items():
        if entry["rows"] <= 0 or len(entry["by_tenant"]) < 2:
            continue  # an unshared program has no neighbors to disturb
        frac = entry["by_tenant"].get(tenant, 0) / entry["rows"]
        if frac > share and frac > worst_share:
            worst_pid, worst_share = pid, frac
    return worst_pid, worst_share


def has_data() -> bool:
    with _LOCK:
        return bool(_tenants)


def _owner_of(tenant: str) -> str:
    """The tenant's owning host per the cluster placement tier (lazy:
    the ledger stays importable with telemetry stripped)."""
    from torcheval_tpu_torch.telemetry import tenants as _tenants_mod

    return _tenants_mod.owner_of(tenant)


def ledger_rows(
    dominance_share: float = DEFAULT_DOMINANCE_SHARE,
) -> List[Dict[str, Any]]:
    """The cumulative ledger, one plain dict per tenant, sorted by
    attributed device-seconds (descending, then tenant id).  The row
    schema is the single contract every surface renders —
    ``report()["tenants"]``, the Prometheus families, the ``--tenants``
    CLI table, and :func:`rebalance_hints` all agree because they all
    read this."""
    with _LOCK:
        out = []
        for tenant in sorted(_tenants):
            t = _tenants[tenant]
            _flush_digests(t)
            offered = t.admitted + t.shed
            wait_q = _quantiles_of(t.wait_digest)
            e2e_q = _quantiles_of(t.e2e_digest)
            pid, frac = _dominance(tenant, dominance_share)
            out.append(
                {
                    "tenant": tenant,
                    "submits": offered + t.rejected,
                    "admitted": t.admitted,
                    "shed": t.shed,
                    "rejected": t.rejected,
                    "dispatched": t.dispatched,
                    "quarantined": t.quarantined,
                    "spills": t.spills,
                    "resumes": t.resumes,
                    "rows": t.rows,
                    "payload_bytes": t.payload_bytes,
                    "queue_depth": t.queue_depth,
                    "shed_rate": t.shed / offered if offered else 0.0,
                    "wait_p50_s": wait_q[0],
                    "wait_p99_s": wait_q[2],
                    "e2e_p50_s": e2e_q[0],
                    "e2e_p99_s": e2e_q[2],
                    "device_seconds": _device_seconds(tenant),
                    "dominant_program": pid,
                    "dominant_share": frac,
                    # Owning host per the serve cluster's placement
                    # tier; "" when no cluster is running.  Lazy import
                    # keeps the ledger importable without telemetry.
                    "owner": _owner_of(tenant),
                }
            )
    out.sort(key=lambda r: (-r["device_seconds"], r["tenant"]))
    return out


def program_rows() -> List[Dict[str, Any]]:
    """Per shared-program attribution totals (the conservation-test
    denominators): banked seconds, rows, calls, per-tenant row split,
    and whether the per-call price is roofline or wall clock."""
    with _LOCK:
        return [
            {
                "program": pid,
                "seconds": entry["seconds"],
                "rows": entry["rows"],
                "calls": entry["calls"],
                "priced": entry["priced"] is not None,
                "by_tenant": dict(entry["by_tenant"]),
            }
            for pid, entry in sorted(_programs.items())
        ]


def publish(
    dominance_share: float = DEFAULT_DOMINANCE_SHARE,
) -> int:
    """Emit one ``TenantSampleEvent`` per tenant onto the telemetry bus
    (no-op returning 0 with the bus off) so JSONL dumps, flight-recorder
    bundles, and fleet snapshots carry the ledger.  Returns the number
    of samples emitted."""
    from torcheval_tpu_torch.telemetry import events as _events

    if not _events.ENABLED:
        return 0
    rows = ledger_rows(dominance_share)
    for row in rows:
        _events.record_tenant_sample(**row)
    return len(rows)


# ----------------------------------------------------------- rebalance hints
@dataclass(frozen=True)
class TenantSignal:
    """One tenant's rebalance inputs: live queue depth, cumulative shed
    fraction, spill churn (spills + resumes), and attributed
    device-seconds."""

    tenant: str
    queue_depth: int
    shed_rate: float
    spill_churn: int
    device_seconds: float


@dataclass(frozen=True)
class RebalanceHints:
    """The typed signal set the placement tier consumes: per-tenant signals sorted hottest-first by device-seconds, plus
    the process-wide noisy-neighbor verdict."""

    tenants: Tuple[TenantSignal, ...]
    dominant_tenant: str
    dominant_program: str
    dominant_share: float
    device_seconds_total: float


def rebalance_hints(
    dominance_share: float = DEFAULT_DOMINANCE_SHARE,
) -> RebalanceHints:
    """Snapshot the ledger as :class:`RebalanceHints` — the stable API
    for hot/cold placement decisions, so consumers never scrape report
    text.  Empty (no tenants) until metering is on and serve traffic
    flowed."""
    rows = ledger_rows(dominance_share)
    signals = tuple(
        TenantSignal(
            tenant=row["tenant"],
            queue_depth=row["queue_depth"],
            shed_rate=row["shed_rate"],
            spill_churn=row["spills"] + row["resumes"],
            device_seconds=row["device_seconds"],
        )
        for row in rows
    )
    dominant = next(
        (row for row in rows if row["dominant_program"]), None
    )
    return RebalanceHints(
        tenants=signals,
        dominant_tenant=dominant["tenant"] if dominant else "",
        dominant_program=(
            dominant["dominant_program"] if dominant else ""
        ),
        dominant_share=dominant["dominant_share"] if dominant else 0.0,
        device_seconds_total=sum(r["device_seconds"] for r in rows),
    )
