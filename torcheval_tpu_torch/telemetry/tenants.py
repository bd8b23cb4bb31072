"""Tenant-scope telemetry surfaces over the serve metering ledger (the
port of ``torcheval_tpu/telemetry/tenants.py``).

:mod:`torcheval_tpu_torch.serve.metering` owns the per-tenant ledger; this
module is the one place its rows are selected, capped, and rendered, so
every consumer — ``telemetry.report()["tenants"]``, the
``torcheval_tpu_tenant_*`` Prometheus families (the JAX package's
names, kept), the ``--tenants`` CLI
table, and ``fleet.merge_snapshots`` — shows the SAME numbers:

* :func:`collect_rows` — the live ledger when metering is on in this
  process, else the rows rebuilt from folded ``TenantSampleEvent``
  aggregates (the CLI-replay and fleet-snapshot path; samples are
  cumulative, so the latest per tenant IS the ledger).
* :func:`report_section` — the top-K report shape: rows sorted by
  attributed device-seconds with the worst-shed and worst-p99 tenants
  pinned in even when they fall outside the top K.
* :func:`tenant_label` / :func:`capped_rows` — Prometheus label
  hygiene: tenant ids sanitized to printable label values (escaping
  itself is the exporter's ``_label_escape``), and the unbounded tenant
  set folded behind a cardinality cap — everything past the top
  ``cap`` tenants melts into one ``__other__`` series (counters sum,
  depth sums, quantile gauges keep the max) so a million-tenant day
  cannot blow up the scrape.
* :func:`merge_rollups` — the tenant×host fleet rollup: a tenant whose
  traffic spans hosts sums correctly, and the fleet-wide worst-shed /
  worst-p99 readings are pinned to the host that produced them.

Everything here is plain-dict arithmetic, importable from the CLI and
from fleet merge coordinators.  :func:`merge_rollups`' caller is the
fleet report (``telemetry/aggregate.py``), whose ``tenants`` section it
builds; :func:`note_owner` is fed by the serve cluster's placement
changes (``serve/cluster.py``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

# Report rows shown before the pinned extremes.
TOP_K = 16

# Prometheus series cap per tenant family; overflow folds into one
# __other__ label so scrape cardinality is bounded by design.
TENANT_SERIES_CAP = 32
OTHER_LABEL = "__other__"

# The canonical row schema (one dict per tenant) every surface shares —
# the same keys `metering.ledger_rows` produces and
# `TenantSampleEvent` carries.
ROW_FIELDS: Tuple[str, ...] = (
    "tenant",
    "submits",
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
    "shed_rate",
    "wait_p50_s",
    "wait_p99_s",
    "e2e_p50_s",
    "e2e_p99_s",
    "device_seconds",
    "dominant_program",
    "dominant_share",
    "owner",
)

_SUM_FIELDS = (
    "submits",
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
    "device_seconds",
)
_MAX_FIELDS = ("wait_p50_s", "wait_p99_s", "e2e_p50_s", "e2e_p99_s")

# tenant -> owning host label, fed by the serve cluster's placement
# tier (open / migrate-commit / ring-repair).  Cold-path writes only;
# empty when no cluster is running, and every row then carries "".
_OWNERS: Dict[str, str] = {}


def note_owner(tenant: str, owner: str) -> None:
    """Record which host owns ``tenant`` — the serve cluster calls this
    whenever placement changes so tenant rows and the tenant×host
    rollup can carry an ``owner`` column."""
    _OWNERS[tenant] = str(owner)


def owner_of(tenant: str) -> str:
    return _OWNERS.get(tenant, "")


def _attach_owner(rows: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    for row in rows:
        row.setdefault("owner", _OWNERS.get(row.get("tenant", ""), ""))
    return rows


def collect_rows(
    agg: Optional[Dict[str, Any]] = None,
) -> List[Dict[str, Any]]:
    """The current per-tenant rows: the live metering ledger when this
    process meters serve traffic, else the latest folded
    ``TenantSampleEvent`` per tenant from ``agg`` (default: the bus
    aggregates) — the replay/offline path."""
    from torcheval_tpu_torch.serve import metering as _metering

    if _metering.ENABLED and _metering.has_data():
        return _attach_owner(_metering.ledger_rows())
    if agg is None:
        from torcheval_tpu_torch.telemetry import events as _events

        agg = _events.aggregates()
    rows = [dict(entry) for entry in agg.get("tenants", {}).values()]
    rows.sort(key=lambda r: (-r.get("device_seconds", 0.0), r["tenant"]))
    return _attach_owner(rows)


def worst_shed(rows: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The highest-shed-rate tenant that actually shed (None without
    one)."""
    shed = [r for r in rows if r.get("shed", 0)]
    if not shed:
        return None
    return max(shed, key=lambda r: (r.get("shed_rate", 0.0), r["tenant"]))


def worst_p99(rows: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """The worst queue-wait-p99 tenant with a reading (None without
    one)."""
    waited = [r for r in rows if r.get("wait_p99_s", 0.0) > 0.0]
    if not waited:
        return None
    return max(
        waited, key=lambda r: (r.get("wait_p99_s", 0.0), r["tenant"])
    )


def report_section(rows: List[Dict[str, Any]]) -> Dict[str, Any]:
    """The ``report()["tenants"]`` shape: top-K rows by device-seconds
    with the worst-shed and worst-p99 tenants pinned in, plus the
    process totals.  Entries are plain list-of-dicts so fleet snapshots
    (``aggregate._plain``) carry them losslessly."""
    top = list(rows[:TOP_K])
    shown = {r["tenant"] for r in top}
    bad_shed = worst_shed(rows)
    bad_p99 = worst_p99(rows)
    for pinned in (bad_shed, bad_p99):
        if pinned is not None and pinned["tenant"] not in shown:
            top.append(pinned)
            shown.add(pinned["tenant"])
    return {
        "tenants_total": len(rows),
        "device_seconds_total": sum(
            r.get("device_seconds", 0.0) for r in rows
        ),
        "rows": top,
        "worst_shed": bad_shed,
        "worst_p99": bad_p99,
    }


# ------------------------------------------------------- prometheus hygiene
def tenant_label(tenant: str) -> str:
    """A tenant id as a safe Prometheus label value: control characters
    (which even escaping may not round-trip through every scraper)
    become ``_``; backslash/quote/newline escaping itself is applied by
    the exporter's ``_label_escape`` at render time."""
    return "".join(
        ch if ch.isprintable() else "_" for ch in str(tenant)
    ) or "_"


def capped_rows(
    rows: List[Dict[str, Any]], cap: int = TENANT_SERIES_CAP
) -> List[Dict[str, Any]]:
    """Rows bounded for labeled export: the top ``cap`` tenants by
    device-seconds keep their own series; every other tenant folds into
    one ``__other__`` row (counter fields summed, quantile gauges keep
    the max) so the label cardinality is ``cap + 1`` no matter how many
    tenants the day brought."""
    if len(rows) <= cap:
        return list(rows)
    kept = list(rows[:cap])
    other: Dict[str, Any] = {field: 0 for field in _SUM_FIELDS}
    other.update({field: 0.0 for field in _MAX_FIELDS})
    folded = 0
    for row in rows[cap:]:
        folded += 1
        for field in _SUM_FIELDS:
            other[field] += row.get(field, 0)
        for field in _MAX_FIELDS:
            other[field] = max(other[field], row.get(field, 0.0))
    offered = other["admitted"] + other["shed"]
    other["tenant"] = OTHER_LABEL
    other["shed_rate"] = other["shed"] / offered if offered else 0.0
    other["dominant_program"] = ""
    other["dominant_share"] = 0.0
    other["folded_tenants"] = folded
    kept.append(other)
    return kept


# ----------------------------------------------------------------- CLI table
def format_table(rows: List[Dict[str, Any]]) -> str:
    """The ``--tenants`` CLI table: one line per tenant, hottest
    (most device-seconds) first."""
    if not rows:
        return "tenants: no tenant samples (serve metering off or idle)"
    header = (
        f"{'tenant':<20} {'dev_s':>10} {'rows':>8} {'disp':>6} "
        f"{'shed%':>6} {'p99_wait':>9} {'p99_e2e':>9} {'depth':>5} "
        f"{'churn':>5} noisy"
    )
    lines = [f"tenants ({len(rows)}):", header]
    for row in rows:
        noisy = (
            f"{row.get('dominant_program', '')}"
            f"@{row.get('dominant_share', 0.0):.0%}"
            if row.get("dominant_program")
            else "-"
        )
        lines.append(
            f"{row['tenant'][:20]:<20} "
            f"{row.get('device_seconds', 0.0):>10.6f} "
            f"{row.get('rows', 0):>8} "
            f"{row.get('dispatched', 0):>6} "
            f"{100.0 * row.get('shed_rate', 0.0):>5.1f}% "
            f"{row.get('wait_p99_s', 0.0):>9.4f} "
            f"{row.get('e2e_p99_s', 0.0):>9.4f} "
            f"{row.get('queue_depth', 0):>5} "
            f"{row.get('spills', 0) + row.get('resumes', 0):>5} "
            f"{noisy}"
        )
    return "\n".join(lines)


# ---------------------------------------------------------------- fleet merge
def merge_rollups(
    per_host: List[Tuple[Dict[str, Any], List[Dict[str, Any]]]],
) -> Dict[str, Any]:
    """Fold ``(host, tenant_rows)`` pairs into the fleet tenant view:
    one row per tenant summed across the hosts that served it (counters
    and device-seconds add; quantile gauges keep the cross-host max),
    plus the fleet-wide worst-shed and worst-p99 readings pinned to
    their host."""
    by_tenant: Dict[str, Dict[str, Any]] = {}
    pinned_shed: Optional[Dict[str, Any]] = None
    pinned_p99: Optional[Dict[str, Any]] = None
    for host, rows in per_host:
        for row in rows:
            tenant = row["tenant"]
            agg = by_tenant.get(tenant)
            if agg is None:
                agg = by_tenant[tenant] = {
                    "tenant": tenant,
                    "hosts": 0,
                    "owner": "",
                    **{field: 0 for field in _SUM_FIELDS},
                    **{field: 0.0 for field in _MAX_FIELDS},
                }
            agg["hosts"] += 1
            # The owner column: any host that knows the tenant's
            # current placement stamps it; last non-empty wins (the
            # cluster gossips placement, so survivors agree).
            if row.get("owner"):
                agg["owner"] = row["owner"]
            for field in _SUM_FIELDS:
                agg[field] += row.get(field, 0)
            for field in _MAX_FIELDS:
                agg[field] = max(agg[field], row.get(field, 0.0))
            if row.get("shed", 0) and (
                pinned_shed is None
                or row.get("shed_rate", 0.0)
                > pinned_shed.get("shed_rate", 0.0)
            ):
                pinned_shed = {**row, "host": host}
            if row.get("wait_p99_s", 0.0) > 0.0 and (
                pinned_p99 is None
                or row.get("wait_p99_s", 0.0)
                > pinned_p99.get("wait_p99_s", 0.0)
            ):
                pinned_p99 = {**row, "host": host}
    merged = list(by_tenant.values())
    for agg in merged:
        offered = agg["admitted"] + agg["shed"]
        agg["shed_rate"] = agg["shed"] / offered if offered else 0.0
    merged.sort(key=lambda r: (-r["device_seconds"], r["tenant"]))
    return {
        "per_tenant": merged,
        "worst_shed": pinned_shed,
        "worst_p99": pinned_p99,
    }
