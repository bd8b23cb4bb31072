"""The port's tenant metering ledger (``torcheval_tpu_torch.serve.metering``)
against the JAX package's: the same ``record_*`` sequence, with the same
program price, gives equal ``ledger_rows()``, ``program_rows()`` and
``rebalance_hints()``; and driven through both ``EvalService``s, the
ledgers' traffic counters agree and the port's per-tenant device-seconds
conserve its programs' banked totals to 1e-6 relative.

Mirrors ``tests/serve/test_metering.py`` case for case."""

import dataclasses
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.serve.metering as jax_metering
from torcheval_tpu import serve as jax_serve
from torcheval_tpu.metrics import MulticlassAccuracy as JaxAccuracy

from torcheval_tpu_torch import telemetry
from torcheval_tpu_torch.metrics import MulticlassAccuracy
from torcheval_tpu_torch.serve import (
    EvalService,
    Rejected,
    metering,
    rebalance_hints,
)
from torcheval_tpu_torch.telemetry import events as port_events
from torcheval_tpu_torch.telemetry import export, tenants

from tests.test_torch_serve import Twin, _batches, _port_suite, _solo
from tests.test_torch_telemetry import reset_all

C = 5


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    monkeypatch.delenv("TORCHEVAL_TPU_TORCH_TENANT_METERING", raising=False)
    monkeypatch.delenv("TORCHEVAL_TPU_TENANT_METERING", raising=False)
    reset_all()
    yield
    reset_all()


def _small_suite():
    # A different metric set: a different group signature, a second
    # program with its own attribution row.
    return {"acc": MulticlassAccuracy(num_classes=C, average="macro", device="cpu")}


def _conservation_err():
    tenant_total = sum(r["device_seconds"] for r in metering.ledger_rows())
    program_total = sum(p["seconds"] for p in metering.program_rows())
    return abs(tenant_total - program_total) / max(program_total, 1e-12)


# The recorded sequence both ledgers see: a priced and an unpriced program,
# a heavy tenant, sheds, a rejected ghost, a quarantine, spill churn.
_PRICE = {"bytes_accessed": 2_000_000, "flops": 0}


def _record_sequence(mod):
    mod.enable()
    big = mod.program_id(("big-signature", 8))
    small = mod.program_id(("small-signature", 8))
    assert (big, small) == ("serve_group#0", "serve_group#1")
    mod.record_program_price(big, _PRICE)
    rng = np.random.default_rng(5)
    for step in range(40):
        tenant = ("heavy", "heavy", "heavy", "light", "mid")[step % 5]
        program = small if tenant == "mid" and step % 2 else big
        mod.record_submit(tenant, "admitted", nbytes=4096 + step, queue_depth=step % 3)
        mod.record_dispatch(
            tenant, program, rows=17 + step % 4, seconds=1e-4 * (1 + step % 7),
            wait_s=float(rng.lognormal(-7, 1)), e2e_s=float(rng.lognormal(-6, 1)),
            queue_depth=step % 2,
        )
    for _ in range(3):
        mod.record_submit("light", "shed", queue_depth=4)
    mod.record_submit("ghost", "rejected")
    mod.record_quarantine("mid")
    for action in ("spill", "resume", "spill", "open"):
        mod.record_session(action, "light")


def test_ledgers_agree_on_the_same_sequence():
    _record_sequence(jax_metering)
    _record_sequence(metering)
    assert metering.ledger_rows() == jax_metering.ledger_rows()
    assert metering.program_rows() == jax_metering.program_rows()
    got, want = rebalance_hints(), jax_serve.rebalance_hints()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.dominant_tenant == "heavy" and got.dominant_program == "serve_group#0"
    assert _conservation_err() <= 1e-6
    rows = {r["tenant"]: r for r in metering.ledger_rows()}
    assert rows["light"]["spills"] == 2 and rows["light"]["resumes"] == 1
    assert rows["ghost"]["rejected"] == 1 and rows["mid"]["quarantined"] == 1
    # The priced program charges its roofline price a call, not wall clock.
    big = next(p for p in metering.program_rows() if p["program"] == "serve_group#0")
    assert big["priced"] and big["seconds"] == pytest.approx(
        big["calls"] * _PRICE["bytes_accessed"] / 50e9)


def test_publish_emits_one_sample_a_tenant():
    _record_sequence(metering)
    assert metering.publish() == 0  # the bus is off
    port_events.enable()
    assert metering.publish() == 4
    samples = port_events.events("tenant_sample")
    assert [s.tenant for s in samples] == [r["tenant"] for r in metering.ledger_rows()]


# ---------------------------------------------------------------- enablement
def test_auto_on_when_service_constructed():
    assert not metering.enabled()
    EvalService(group_width=2)
    assert metering.enabled()


def test_forced_off_outranks_the_auto_on():
    metering.disable()
    EvalService(group_width=2)
    assert not metering.enabled()


@pytest.mark.parametrize("raw, want", [("0", False), ("1", True), ("maybe", True)])
def test_the_flag_is_tristate(monkeypatch, raw, want):
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_TENANT_METERING", raw)
    metering.reset()
    assert metering.enabled() is (raw == "1")  # only truthy is on at import
    EvalService(group_width=2)
    assert metering.enabled() is want  # unset or junk: auto-on with serve


def test_flag_off_is_bit_identical_with_a_cold_ledger():
    metering.disable()
    svc = EvalService(group_width=4)
    streams = {t: _batches(4, seed=i) for i, t in enumerate("abc")}
    for tenant in streams:
        svc.open(tenant, _port_suite())
    for step in range(4):
        for tenant, batches in streams.items():
            svc.submit(tenant, *batches[step])
    svc.pump()
    for tenant, batches in streams.items():
        got, solo = svc.results(tenant), _solo(batches)
        assert all(got[k].numpy().tobytes() == solo[k].numpy().tobytes() for k in solo)
    assert not metering.has_data()
    assert metering.ledger_rows() == [] and metering.program_rows() == []


# -------------------------------------------------------------- attribution
_COUNTERS = ("submits", "admitted", "shed", "rejected", "dispatched", "quarantined",
             "spills", "resumes", "rows", "payload_bytes", "queue_depth")


def _counters(rows):
    return {r["tenant"]: {k: r[k] for k in _COUNTERS} for r in rows}


def test_conserves_across_mixed_and_overflow_groups():
    # group_width=2 with three same-signature tenants forces an overflow
    # group (two groups share ONE program id), and the small-suite tenants
    # add a second program.
    twin = Twin(group_width=2)
    big = {t: _batches(3, seed=i) for i, t in enumerate("abc")}
    small = {t: _batches(2, seed=10 + i, rows=9) for i, t in enumerate(("x", "y"))}
    for tenant in big:
        twin.open(tenant)
    for tenant in small:
        twin.jax.open(tenant, {"acc": JaxAccuracy(num_classes=C, average="macro")})
        twin.port.open(tenant, _small_suite())
    for step in range(3):
        for tenant, batches in big.items():
            twin.submit(tenant, batches[step])
        for tenant, batches in small.items():
            if step < len(batches):
                twin.submit(tenant, batches[step])
        twin.pump()
    programs = metering.program_rows()
    assert len(programs) == 2 and twin.port.stats()["groups"] == 3
    assert [(p["program"], p["rows"], p["calls"], p["by_tenant"]) for p in programs] == [
        (p["program"], p["rows"], p["calls"], p["by_tenant"])
        for p in jax_metering.program_rows()]
    assert _conservation_err() <= 1e-6
    for entry in programs:
        assert sum(entry["by_tenant"].values()) == entry["rows"]
    rows = metering.ledger_rows()
    # payload bytes: a jax array and a torch tensor of one batch carry the
    # same .nbytes.
    assert _counters(rows) == _counters(jax_metering.ledger_rows())
    by = {r["tenant"]: r for r in rows}
    for tenant, batches in big.items():
        assert by[tenant]["dispatched"] == len(batches)
        assert by[tenant]["rows"] == sum(len(b[1]) for b in batches)


def test_quarantined_tenant_keeps_pre_quarantine_ledger():
    twin = Twin(group_width=4)
    good, bad = _batches(3, seed=21), _batches(2, seed=22)
    twin.open("good")
    twin.open("bad")
    for step in range(2):
        twin.submit("good", good[step])
        twin.submit("bad", bad[step])
    twin.pump()
    scores, _ = _batches(1, seed=23)[0]
    twin.submit("bad", (scores, np.zeros(5, dtype=np.int32)))
    twin.pump()
    twin.submit("good", good[2])
    twin.pump()
    assert isinstance(twin.submit("bad", bad[0]), Rejected)
    rows = {r["tenant"]: r for r in metering.ledger_rows()}
    assert rows["bad"]["dispatched"] == 2 and rows["bad"]["quarantined"] == 1
    assert rows["bad"]["device_seconds"] > 0.0 and rows["good"]["dispatched"] == 3
    assert _conservation_err() <= 1e-6
    assert _counters(metering.ledger_rows()) == _counters(jax_metering.ledger_rows())


def test_shed_and_rejected_are_billed_to_the_right_tenant():
    twin = Twin(group_width=2, admission={"global_capacity": 8, "per_tenant_capacity": 1})
    twin.open("a")
    batch = _batches(1, seed=30)[0]
    twin.submit("a", batch)
    twin.submit("a", batch)  # over per-tenant capacity
    twin.submit("ghost", batch)  # unknown tenant: rejected
    twin.pump()
    rows = {r["tenant"]: r for r in metering.ledger_rows()}
    assert (rows["a"]["shed"], rows["a"]["dispatched"]) == (1, 1)
    assert (rows["ghost"]["rejected"], rows["ghost"]["dispatched"]) == (1, 0)
    assert _counters(metering.ledger_rows()) == _counters(jax_metering.ledger_rows())


def test_priced_program_charges_the_perfscope_price():
    """With perfscope on, serve's shared program is priced once (bytes
    only) and every later dispatch is charged that price."""
    from torcheval_tpu_torch.telemetry import perfscope

    perfscope.enable()
    svc = EvalService(group_width=2)
    svc.open("a", _port_suite())
    svc.open("b", _port_suite())
    for b in _batches(3, seed=31):
        svc.submit("a", *b)
        svc.submit("b", *b)
    svc.pump()
    (program,) = metering.program_rows()
    assert program["priced"] and program["calls"] == 6
    assert _conservation_err() <= 1e-6


# ------------------------------------------------------------------ surfaces
def test_every_surface_renders_the_same_ledger():
    telemetry.enable()
    svc = EvalService(group_width=2)
    streams = {t: _batches(3, seed=i) for i, t in enumerate("ab")}
    for tenant in streams:
        svc.open(tenant, _port_suite())
    for step in range(3):
        for tenant, batches in streams.items():
            svc.submit(tenant, *batches[step])
        svc.pump()
    live = metering.ledger_rows()
    assert len(live) == 2
    report = telemetry.report()
    assert report["tenants"]["rows"] == live
    table = tenants.format_table(tenants.collect_rows(port_events.aggregates()))
    assert all(row["tenant"] in table for row in live)
    text = export.prometheus_text()
    for row in live:
        assert ("torcheval_tpu_tenant_dispatched_total"
                f'{{tenant="{row["tenant"]}"}} {row["dispatched"]}') in text
    hints = rebalance_hints()
    assert {s.tenant for s in hints.tenants} == {r["tenant"] for r in live}
    assert hints.device_seconds_total == pytest.approx(
        sum(r["device_seconds"] for r in live), abs=1e-12)


def test_wait_is_stamped_on_dispatched_and_shed_admissions():
    telemetry.enable()
    svc = EvalService(group_width=2)
    svc.open("a", _port_suite())
    batch = _batches(1, seed=40)[0]
    svc.submit("a", *batch)
    svc.pump()
    svc.submit("a", *batch, deadline_s=0.001)
    time.sleep(0.01)
    svc.pump()  # expires at pop
    outcomes = {e.outcome: e for e in port_events.events("admission")}
    assert outcomes["dispatched"].wait_s >= 0.0
    assert outcomes["shed"].wait_s > 0.0


def test_payload_and_rows_read_metadata_only():
    scores = torch.zeros((6, C))
    assert metering.payload_nbytes((scores, np.zeros(6, np.int32)), {"mask": torch.ones(6)}) == (
        6 * C * 4 + 6 * 4 + 6 * 4)
    assert metering.batch_rows((scores,)) == 6 and metering.batch_rows(()) == 0
    assert metering.batch_rows(([1, 2, 3],)) == 3
    assert jax_metering.payload_nbytes((jnp.zeros((6, C)),), {}) == metering.payload_nbytes(
        (scores,), {})
