"""The port's tenant telemetry surfaces (``telemetry/tenants.py``, the
``torcheval_tpu_tenant_*`` Prometheus families, ``report()["tenants"]``
and the CLI's ``--tenants``) against the JAX package's: the same ledger,
live or replayed from ``TenantSampleEvent`` dumps, renders the same text
in both.  Everything on the CPU."""

import dataclasses

import pytest

import torcheval_tpu.serve.metering as jax_metering
import torcheval_tpu.telemetry as jax_telemetry
from torcheval_tpu.telemetry import events as jax_events
from torcheval_tpu.telemetry import export as jax_export
from torcheval_tpu.telemetry import tenants as jax_tenants

import torcheval_tpu_torch.telemetry as port_telemetry
from torcheval_tpu_torch.serve import metering
from torcheval_tpu_torch.telemetry import __main__ as port_cli
from torcheval_tpu_torch.telemetry import events as port_events
from torcheval_tpu_torch.telemetry import export as port_export
from torcheval_tpu_torch.telemetry import tenants

from tests.test_torch_metering import _record_sequence
from tests.test_torch_telemetry import reset_all


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.delenv("TORCHEVAL_TPU_TORCH_TENANT_METERING", raising=False)
    reset_all()
    yield
    reset_all()


def _rows(n, skew=True):
    """``n`` synthetic ledger rows in the shared schema, hottest first."""
    out = []
    for i in range(n):
        admitted, shed = 10 + i, (i % 4 == 0) * (i + 1)
        out.append({
            "tenant": f"tenant-{i:03d}" if i != 3 else "odd\ttenant\n\"x\"",
            "submits": admitted + shed + i % 2,
            "admitted": admitted,
            "shed": shed,
            "rejected": i % 2,
            "dispatched": admitted,
            "quarantined": int(i == 7),
            "spills": i % 3,
            "resumes": i % 3 // 2,
            "rows": 17 * admitted,
            "payload_bytes": 4096 * admitted,
            "queue_depth": i % 5,
            "shed_rate": shed / (admitted + shed),
            "wait_p50_s": 1e-4 * (i + 1),
            "wait_p99_s": 1e-3 * ((i * 7) % 11),
            "e2e_p50_s": 2e-4 * (i + 1),
            "e2e_p99_s": 2e-3 * ((i * 5) % 13),
            "device_seconds": (1.0 / (i + 1)) if skew else 1.0,
            "dominant_program": "serve_group#0" if i == 0 else "",
            "dominant_share": 0.6 if i == 0 else 0.0,
            "owner": "",
        })
    return out


@pytest.mark.parametrize("n", [0, 3, 40])
def test_row_helpers_match_jax(n):
    rows = _rows(n)
    assert tenants.report_section(rows) == jax_tenants.report_section(rows)
    assert tenants.capped_rows(rows) == jax_tenants.capped_rows(rows)
    assert tenants.capped_rows(rows, cap=2) == jax_tenants.capped_rows(rows, cap=2)
    assert tenants.format_table(rows) == jax_tenants.format_table(rows)
    assert tenants.worst_shed(rows) == jax_tenants.worst_shed(rows)
    assert tenants.worst_p99(rows) == jax_tenants.worst_p99(rows)
    per_host = [({"process_index": h, "hostname": f"h{h}"}, rows[h::2]) for h in range(2)]
    assert tenants.merge_rollups(per_host) == jax_tenants.merge_rollups(per_host)
    if n > tenants.TENANT_SERIES_CAP:
        other = tenants.capped_rows(rows)[-1]
        assert other["tenant"] == tenants.OTHER_LABEL == jax_tenants.OTHER_LABEL
        assert other["folded_tenants"] == n - tenants.TENANT_SERIES_CAP
    for row in rows:
        assert tenants.tenant_label(row["tenant"]) == jax_tenants.tenant_label(row["tenant"])
    assert tenants.tenant_label("") == "_" and tenants.tenant_label("a\tb") == "a_b"
    assert tenants.ROW_FIELDS == jax_tenants.ROW_FIELDS


def test_owner_column():
    tenants.note_owner("b", "host-3")
    try:
        metering.enable()
        for tenant in ("a", "b"):
            metering.record_submit(tenant, "admitted")
        by = {r["tenant"]: r for r in tenants.collect_rows()}
        assert (by["a"]["owner"], by["b"]["owner"]) == ("", "host-3")
        assert tenants.owner_of("b") == "host-3"
    finally:
        tenants._OWNERS.clear()


def _tenant_block(text):
    lines = text.splitlines()
    start = next(i for i, line in enumerate(lines) if line.startswith("  tenants:"))
    end = next((i for i in range(start + 1, len(lines)) if not lines[i].startswith("    ")),
               len(lines))
    return lines[start:end]


def _emit_samples(rows):
    for events in (jax_events, port_events):
        events.enable()
        for row in rows:
            events.record_tenant_sample(**row)


def test_replayed_samples_render_the_jax_text(tmp_path, capsys):
    """Metering off: the surfaces read the folded TenantSampleEvent rows."""
    rows = _rows(40)
    _emit_samples(rows)
    assert tenants.collect_rows() == jax_tenants.collect_rows()
    assert port_telemetry.prometheus_text() == jax_telemetry.prometheus_text()
    assert "torcheval_tpu_tenant_series_folded 8" in port_telemetry.prometheus_text()
    assert port_telemetry.report()["tenants"] == jax_telemetry.report()["tenants"]
    jax_report = jax_telemetry.report()
    assert port_export.format_report(jax_report) == jax_export.format_report(jax_report)
    assert _tenant_block(port_telemetry.report(as_text=True)) == _tenant_block(
        jax_export.format_report(jax_report))
    dump = tmp_path / "jax.jsonl"
    jax_telemetry.export_jsonl(str(dump))
    want = jax_tenants.format_table(jax_tenants.collect_rows())
    reset_all()
    assert port_cli.main([str(dump), "--tenants"]) == 0
    assert capsys.readouterr().out == want + "\n"


def test_live_ledgers_render_the_same_text():
    """Metering on: both surfaces read the live ledger of the same record_*
    sequence."""
    _record_sequence(jax_metering)
    _record_sequence(metering)
    for events in (jax_events, port_events):
        events.enable()
    assert port_telemetry.prometheus_text() == jax_telemetry.prometheus_text()
    section = port_telemetry.report()["tenants"]
    assert section == jax_telemetry.report()["tenants"]
    assert section["tenants_total"] == 4 and section["rows"][0]["tenant"] == "mid"
    text = port_telemetry.report(as_text=True)
    assert "tenants: 4 metered" in text and "worst shed: light" in text
    # publish() carries the ledger onto the bus: a replay of those samples
    # gives the same rows.
    assert metering.publish() == jax_metering.publish() == 4
    samples = [dataclasses.asdict(e) for e in port_events.events("tenant_sample")]
    assert [s["tenant"] for s in samples] == [r["tenant"] for r in metering.ledger_rows()]


def test_no_tenants_no_section():
    port_events.enable()
    assert "tenants" not in port_telemetry.report()
    assert "tenant" not in port_telemetry.prometheus_text()
    assert tenants.format_table([]) == jax_tenants.format_table([])
