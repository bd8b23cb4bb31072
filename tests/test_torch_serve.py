"""The port's single-host serve plane (``torcheval_tpu_torch.serve``)
against the JAX package's: the same tenants, suites and numpy-seeded
batches go through both ``EvalService``s (the port's metrics on the CPU),
and every submit's typed outcome, the service counters and each tenant's
seat states (integer counts) must be equal, each tenant's results
bit-equal to a solo, unsliced port suite over the same batches and within
1e-6 of JAX's (the figures' float epilogue is XLA's fused one there, as in
tests/test_torch_collection.py).  Every scenario runs with the collection
kernel's mode unset and forced on (forced on, ``mega.cu``'s plain version
runs on the CPU).

Mirrors ``tests/serve/test_service.py`` and ``tests/serve/test_overload.py``
case for case at ≤ 8 tenants, and adds the rollback contract: a dispatch
writes no state tensor of its group in place."""

import dataclasses
import os
import shutil
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu import serve as jax_serve
from torcheval_tpu.metrics import MulticlassAccuracy as JaxAccuracy
from torcheval_tpu.metrics import MulticlassF1Score as JaxF1
from torcheval_tpu.resilience import FaultPlan as JaxFaultPlan
from torcheval_tpu.telemetry import events as jax_events
from torcheval_tpu.telemetry import flightrec as jax_flightrec
from torcheval_tpu.telemetry import health as jax_health

from torcheval_tpu_torch import _stats, serve
from torcheval_tpu_torch.metrics import MulticlassAccuracy, MulticlassF1Score
from torcheval_tpu_torch.ops import _build
from torcheval_tpu_torch.resilience import FaultPlan, InjectedFault
from torcheval_tpu_torch.serve import (
    Admitted,
    AdmissionController,
    EvalService,
    Rejected,
    Shed,
    signature_of,
)
from torcheval_tpu_torch.telemetry import events as port_events
from torcheval_tpu_torch.telemetry import flightrec as port_flightrec
from torcheval_tpu_torch.telemetry import health as port_health

from tests.test_torch_telemetry import reset_all

C = 5
RTOL = 1e-6


@pytest.fixture(autouse=True, params=["unset", "forced"])
def megakernel(request, monkeypatch):
    if request.param == "forced":
        monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "1")
    else:
        monkeypatch.delenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", raising=False)
    reset_all()
    yield request.param
    reset_all()


def _port_suite():
    return {
        "acc": MulticlassAccuracy(num_classes=C, average="macro", device="cpu"),
        "f1": MulticlassF1Score(num_classes=C, average="macro", device="cpu"),
    }


def _jax_suite():
    return {
        "acc": JaxAccuracy(num_classes=C, average="macro"),
        "f1": JaxF1(num_classes=C, average="macro"),
    }


def _batches(n, seed, rows=17):
    rng = np.random.default_rng(seed)
    return [
        (rng.random((rows, C), dtype=np.float32), rng.integers(0, C, rows).astype(np.int32))
        for _ in range(n)
    ]


def _nan_batch(rows=17):
    scores = np.full((rows, C), 0.5, dtype=np.float32)
    scores[3, 1] = np.nan
    return scores, np.zeros(rows, dtype=np.int32)


def _solo(batches):
    """The reference: a plain unsliced port suite over the same stream."""
    metrics = _port_suite()
    for scores, target in batches:
        for m in metrics.values():
            m.update(torch.from_numpy(scores), torch.from_numpy(target))
    return {name: m.compute() for name, m in metrics.items()}


def _outcome(o):
    return type(o).__name__, dataclasses.asdict(o)


class Twin:
    """One JAX and one port ``EvalService`` driven by the same calls; every
    submit's typed outcome and every pump's count must agree."""

    def __init__(self, admission=None, **kw):
        self.jax = jax_serve.EvalService(
            admission=None if admission is None else jax_serve.AdmissionController(**admission),
            **{k: (v + "/jax" if k == "spill_dir" else v) for k, v in kw.items()},
        )
        self.port = EvalService(
            admission=None if admission is None else AdmissionController(**admission),
            **{k: (v + "/port" if k == "spill_dir" else v) for k, v in kw.items()},
        )
        self.applied = {}

    def open(self, tenant, **kw):
        self.jax.open(tenant, _jax_suite(), **kw)
        self.port.open(tenant, _port_suite(), **kw)
        self.applied.setdefault(tenant, [])

    def submit(self, tenant, batch, **kw):
        got_jax = self.jax.submit(tenant, *(jnp.asarray(x) for x in batch), **kw)
        got = self.port.submit(tenant, *(torch.from_numpy(x) for x in batch), **kw)
        assert _outcome(got) == _outcome(got_jax)
        if isinstance(got, Admitted):
            self.applied.setdefault(tenant, []).append(batch)
        return got

    def pump(self):
        n = self.jax.pump()
        assert self.port.pump() == n
        return n

    def both(self, name, *args):
        want = getattr(self.jax, name)(*args)
        got = getattr(self.port, name)(*args)
        return got, want

    def check_counts(self):
        assert self.port.stats()["counts"] == self.jax.stats()["counts"]

    def check(self, tenant, batches=None):
        """Results bit-equal to the solo suite and within RTOL of JAX's;
        the seat's integer counts bit-equal to JAX's."""
        batches = self.applied[tenant] if batches is None else batches
        got, want = self.port.results(tenant), self.jax.results(tenant)
        solo = _solo(batches)
        assert set(got) == set(want) == set(solo)
        for name in solo:
            assert got[name].numpy().tobytes() == solo[name].numpy().tobytes(), name
            np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=RTOL)
        mine = self.port._registry.seat_state_dict(self.port.session(tenant))
        theirs = self.jax._registry.seat_state_dict(self.jax.session(tenant))
        assert set(mine) == set(theirs)
        for key in theirs:
            t = np.asarray(theirs[key])
            assert mine[key].numpy().dtype == t.dtype and np.array_equal(mine[key].numpy(), t), key


@pytest.fixture
def spill_root(tmp_path):
    yield str(tmp_path)
    shutil.rmtree(tmp_path, ignore_errors=True)


# ----------------------------------------------------------------- basics
def test_results_bit_identical_to_solo(megakernel):
    twin = Twin(group_width=4)
    streams = {t: _batches(4, seed=i) for i, t in enumerate("abc")}
    for tenant in streams:
        twin.open(tenant)
    _build.reset_counts()
    for step in range(4):
        for tenant, batches in streams.items():
            assert isinstance(twin.submit(tenant, batches[step]), Admitted)
    assert twin.pump() == 12
    for tenant, batches in streams.items():
        twin.check(tenant, batches)
    twin.check_counts()
    assert twin.port.stats()["programs"] == twin.jax.stats()["programs"]
    # Forced on, every dispatch is one call of the collection kernel's
    # plain version; unset, the CPU members take their own paths.
    want = {"mega_counts": 12} if megakernel == "forced" else {}
    assert dict(_build.PLAIN_CALLS) == want and not _build.LAUNCHES


def test_slice_ids_is_service_owned():
    svc = EvalService()
    svc.open("a", _port_suite())
    scores, target = _batches(1, seed=0)[0]
    with pytest.raises(TypeError, match="slice_ids"):
        svc.submit("a", scores, target, slice_ids=np.zeros(17))


def test_unknown_closed_and_duplicate_tenants():
    twin = Twin()
    assert twin.submit("ghost", _batches(1, seed=0)[0]).reason == "unknown-tenant"
    with pytest.raises(KeyError):
        twin.port.results("ghost")
    twin.open("a")
    with pytest.raises(ValueError, match="already has an open session"):
        twin.port.open("a", _port_suite())
    twin.both("close", "a")
    assert twin.submit("a", _batches(1, seed=0)[0]).reason == "unknown-tenant"
    with pytest.raises(RuntimeError, match="closed"):
        twin.port.results("a")
    twin.check_counts()


def test_open_adopts_existing_state():
    batches = _batches(3, seed=7)
    mine, theirs = _port_suite(), _jax_suite()
    for m in mine.values():
        m.update(*(torch.from_numpy(x) for x in batches[0]))
    for m in theirs.values():
        m.update(*(jnp.asarray(x) for x in batches[0]))
    twin = Twin()
    twin.jax.open("a", theirs)
    twin.port.open("a", mine)
    twin.applied["a"] = [batches[0]]
    for b in batches[1:]:
        twin.submit("a", b)
    twin.pump()
    twin.check("a", batches)


def test_stats_shape():
    twin = Twin()
    twin.open("a")
    twin.submit("a", _batches(1, seed=0)[0])
    twin.pump()
    got, want = twin.port.stats(), twin.jax.stats()
    assert set(got) == set(want)
    for key in ("queue_depth", "tenants", "groups", "programs", "counts"):
        assert got[key] == want[key], key
    assert got["tenants"] == {"active": 1} and got["groups"] == 1


# ------------------------------------------------------------- coalescing
def test_same_signature_shares_group_and_program():
    twin = Twin(group_width=4)
    for i, tenant in enumerate("abc"):
        twin.open(tenant)
        twin.submit(tenant, _batches(1, seed=i)[0])
    traces = _stats.trace_count("serve_group")
    twin.pump()
    assert twin.port.stats()["groups"] == twin.jax.stats()["groups"] == 1
    assert twin.port.stats()["programs"]["misses"] == 1
    assert _stats.trace_count("serve_group") - traces == 1


def test_overflow_groups_share_one_program():
    """5 tenants at width 2 need 3 groups, and ONE bundle, keyed by
    (signature, width, health, route token), serves them all."""
    twin = Twin(group_width=2)
    streams = {f"t{i}": _batches(2, seed=i) for i in range(5)}
    for tenant, batches in streams.items():
        twin.open(tenant)
        for b in batches:
            twin.submit(tenant, b)
    twin.pump()
    stats = twin.port.stats()
    assert stats["groups"] == 3 and stats["programs"] == twin.jax.stats()["programs"]
    assert stats["programs"]["misses"] == 1 and stats["programs"]["currsize"] == 1
    for tenant, batches in streams.items():
        twin.check(tenant, batches)


def test_signature_splits_on_config_name_device_and_override():
    twin = Twin(group_width=4)
    twin.jax.open("five", {"acc": JaxAccuracy(num_classes=5)})
    twin.jax.open("seven", {"acc": JaxAccuracy(num_classes=7)})
    twin.port.open("five", {"acc": MulticlassAccuracy(num_classes=5, device="cpu")})
    twin.port.open("seven", {"acc": MulticlassAccuracy(num_classes=7, device="cpu")})
    assert twin.port.stats()["groups"] == twin.jax.stats()["groups"] == 2
    macro = signature_of({"f1": MulticlassF1Score(num_classes=5, average="macro", device="cpu")})
    micro = signature_of({"f1": MulticlassF1Score(num_classes=5, average="micro", device="cpu")})
    assert macro != micro
    assert signature_of({"a": MulticlassAccuracy(num_classes=5, device="cpu")}) != signature_of(
        {"b": MulticlassAccuracy(num_classes=5, device="cpu")})
    on_meta = MulticlassAccuracy(num_classes=5, device="cpu")
    on_meta._device = torch.device("meta")
    assert signature_of({"a": on_meta}) != signature_of(
        {"a": MulticlassAccuracy(num_classes=5, device="cpu")})
    twin.open("a")
    twin.jax.open("b", _jax_suite(), signature=("isolated",))
    twin.port.open("b", _port_suite(), signature=("isolated",))
    assert twin.port.stats()["groups"] == twin.jax.stats()["groups"] == 4


# ------------------------------------------------------------ spill/resume
def test_spill_resume_bit_identity_on_a_different_seat(spill_root):
    twin = Twin(group_width=2, spill_dir=spill_root)
    streams = {"a": _batches(3, seed=1), "b": _batches(3, seed=2)}
    for tenant, batches in streams.items():
        twin.open(tenant)
        for b in batches[:2]:
            twin.submit(tenant, b)
    twin.pump()
    # "b" (seat 1) resumes first and lands on seat 0: seat state is keyed
    # without the index.
    twin.both("spill", "a")
    twin.both("spill", "b")
    assert twin.port.stats()["tenants"] == {"spilled": 2}
    for tenant in ("b", "a"):
        twin.submit(tenant, streams[tenant][2])
    twin.pump()
    assert twin.port.session("b").seat == 0
    for tenant, batches in streams.items():
        twin.check(tenant, batches)
    twin.check_counts()
    counts = twin.port.stats()["counts"]
    assert counts["spills"] == counts["resumes"] == 2


def test_max_resident_spills_lru_transparently(spill_root):
    twin = Twin(group_width=1, spill_dir=spill_root, max_resident=1)
    streams = {"a": _batches(3, seed=1), "b": _batches(3, seed=2)}
    for tenant in streams:
        twin.open(tenant)
    for step in range(3):  # alternating tenants force churn
        for tenant, batches in streams.items():
            twin.submit(tenant, batches[step])
            twin.pump()
    assert twin.port.stats()["counts"]["spills"] > 0
    twin.check_counts()
    for tenant, batches in streams.items():
        twin.check(tenant, batches)


def test_close_deletes_spill_state_but_spares_siblings(spill_root):
    twin = Twin(group_width=1, spill_dir=spill_root)
    streams = {"a": _batches(2, seed=1), "b": _batches(2, seed=2)}
    for tenant, batches in streams.items():
        twin.open(tenant)
        for b in batches:
            twin.submit(tenant, b)
    twin.pump()
    for tenant in ("a", "b"):
        twin.both("spill", tenant)
    twin.both("close", "a")
    assert not os.path.isdir(os.path.join(spill_root + "/port", "a"))
    assert os.path.isdir(os.path.join(spill_root + "/port", "b"))
    twin.check("b", streams["b"])


def test_spill_without_dir_raises():
    svc = EvalService()
    svc.open("a", _port_suite())
    with pytest.raises(RuntimeError, match="TORCHEVAL_TPU_TORCH_SERVE_SPILL_DIR"):
        svc.spill("a")


def test_spill_dir_flag_is_the_default(spill_root, monkeypatch):
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_SERVE_SPILL_DIR", spill_root)
    svc = EvalService()
    svc.open("a", _port_suite())
    svc.spill("a")
    assert os.listdir(os.path.join(spill_root, "a"))


def test_adopt_spilled_and_resume(spill_root):
    twin = Twin(group_width=2, spill_dir=spill_root)
    batches = _batches(3, seed=5)
    twin.open("a")
    for b in batches[:2]:
        twin.submit("a", b)
    twin.pump()
    twin.both("spill", "a")
    twin.both("evict", "a")
    for svc, suite in ((twin.jax, _jax_suite()), (twin.port, _port_suite())):
        svc.adopt_spilled("a", suite)
        assert svc.session("a").state == "spilled"
        assert svc.resume("a").resident
    twin.submit("a", batches[2])
    twin.pump()
    twin.check("a", batches)


# --------------------------------------------------------- worker, drain
def test_background_worker_processes_submissions():
    twin = Twin(group_width=2)
    batches = _batches(4, seed=3)
    twin.open("a")
    for b in batches:  # the outcomes before the workers race the queue
        assert isinstance(twin.submit("a", b), Admitted)
    for svc in (twin.jax, twin.port):
        svc.start()
    try:
        deadline = time.monotonic() + 60.0
        while time.monotonic() < deadline:
            if all(s.stats()["counts"]["dispatched"] == len(batches)
                   for s in (twin.jax, twin.port)):
                break
            time.sleep(0.01)
    finally:
        twin.port.stop()
        twin.jax.stop()
    assert not any(t.name == "torcheval-tpu-torch-serve" and t.is_alive()
                   for t in threading.enumerate())
    twin.check("a", batches)
    twin.check_counts()


def test_drain_flushes_and_closes(spill_root):
    twin = Twin(group_width=2, spill_dir=spill_root)
    batches = _batches(3, seed=4)
    twin.open("a")
    for b in batches:
        twin.submit("a", b)  # queued, never pumped
    got, want = twin.both("drain", 60.0)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got["processed"] == len(batches) and got["flushed"]
    assert got.pending == 0 and twin.port.stats()["tenants"] == {"spilled": 1}
    assert twin.submit("a", batches[0]).reason == "closed"
    with pytest.raises(RuntimeError, match="draining/closed"):
        twin.port.open("b", _port_suite())
    twin.check_counts()


def test_stop_without_start_is_noop():
    EvalService().stop()


def test_drain_deadline_expiry_spills_partial(spill_root):
    svc = EvalService(group_width=2, spill_dir=spill_root)
    batches = _batches(32, seed=7)
    svc.open("a", _port_suite())
    for b in batches:
        svc.submit("a", *b)
    result = svc.drain(deadline_s=0.0)
    assert isinstance(result, serve.DrainResult)
    assert result.expired and not result.flushed
    assert result.spilled == 1 and result.unspilled == () and result.pending > 0
    assert result.pending + result.processed <= len(batches)
    assert svc.stats()["tenants"] == {"spilled": 1}


def test_drain_deadline_without_spill_path_names_unspilled():
    svc = EvalService(group_width=2)
    svc.open("a", _port_suite())
    for b in _batches(3, seed=8):
        svc.submit("a", *b)
    result = svc.drain(deadline_s=0.0)
    assert result.expired and result.spilled == 0 and result.unspilled == ("a",)


def test_drain_result_keeps_dict_compat(spill_root):
    svc = EvalService(group_width=2, spill_dir=spill_root)
    svc.open("a", _port_suite())
    svc.submit("a", *_batches(1, seed=9)[0])
    result = svc.drain(deadline_s=60.0)
    for key in ("processed", "flushed", "pending", "expired"):
        assert result[key] == getattr(result, key)
    assert result["processed"] == 1 and not result["expired"]


# ---------------------------------------------------------------- overload
def test_burst_10x_sheds_typed_and_survives():
    twin = Twin(group_width=2, admission={"global_capacity": 8, "per_tenant_capacity": 8})
    twin.open("a")
    batch = _batches(1, seed=0)[0]
    outcomes = [twin.submit("a", batch) for _ in range(80)]
    assert sum(isinstance(o, Admitted) for o in outcomes) == 8
    shed = [o for o in outcomes if isinstance(o, Shed)]
    assert len(shed) == 72
    assert {o.reason for o in shed} <= {"global-queue-full", "tenant-queue-full"}
    assert twin.pump() == 8
    twin.check("a", [batch] * 8)
    twin.check_counts()


def test_fair_policy_sheds_only_the_flooder():
    twin = Twin(group_width=2, admission={
        "global_capacity": 8, "per_tenant_capacity": 100, "policy": "fair"})
    twin.open("flood")
    twin.open("quiet")
    batch = _batches(1, seed=1)[0]
    quiet = [twin.submit("quiet", batch)]
    flood = [twin.submit("flood", batch) for _ in range(20)]
    quiet += [twin.submit("quiet", batch) for _ in range(2)]
    flood_shed = [o for o in flood if isinstance(o, Shed)]
    assert len(flood_shed) == 16 and {o.reason for o in flood_shed} == {"fair-quota"}
    assert all(isinstance(o, Admitted) for o in quiet)
    twin.check_counts()


def test_drop_oldest_evicts_the_stalest_item():
    twin = Twin(group_width=2, admission={
        "global_capacity": 2, "per_tenant_capacity": 100, "policy": "drop-oldest"})
    twin.open("a")
    batch = _batches(1, seed=2)[0]
    for _ in range(5):
        assert isinstance(twin.submit("a", batch), Admitted)  # newest always in
    assert twin.port.stats()["queue_depth"] == 2
    assert twin.port.stats()["counts"]["shed"] == 3
    twin.check_counts()


def test_deadline_sheds_stale_items_at_pop():
    twin = Twin(group_width=2)
    twin.open("a")
    twin.submit("a", _batches(1, seed=3)[0], deadline_s=0.01)
    time.sleep(0.05)
    assert twin.pump() == 0  # expired, never executed
    counts = twin.port.stats()["counts"]
    assert counts["shed"] == 1 and counts["dispatched"] == 0
    twin.check_counts()


# -------------------------------------------------------------- quarantine
def test_nan_poison_quarantines_only_that_tenant():
    jax_health.enable(raise_on_corrupt=True)
    port_health.enable(raise_on_corrupt=True)
    twin = Twin(group_width=4)
    streams = {t: _batches(3, seed=i) for i, t in enumerate("abc")}
    for tenant in streams:
        twin.open(tenant)
    twin.open("poison")
    for step in range(2):
        for tenant, batches in streams.items():
            twin.submit(tenant, batches[step])
    twin.submit("poison", _nan_batch())
    twin.pump()  # the poison batch detonates inside the pump
    for tenant, batches in streams.items():
        twin.submit(tenant, batches[2])
    twin.pump()
    assert twin.submit("poison", _batches(1, seed=9)[0]).reason == "quarantined"
    with pytest.raises(RuntimeError, match="quarantined"):
        twin.port.results("poison")
    assert twin.port.stats()["counts"]["quarantined"] == 1
    twin.check_counts()
    for tenant, batches in streams.items():
        twin.check(tenant, batches)


def test_raising_metric_quarantines_with_rollback():
    """A batch of mismatched row counts raises at dispatch; the group rolls
    back to the pre-dispatch snapshot and the neighbour is untouched."""
    twin = Twin(group_width=4)
    good, bad = _batches(3, seed=11), _batches(2, seed=12)
    twin.open("good")
    twin.open("bad")
    for step in range(2):
        twin.submit("good", good[step])
        twin.submit("bad", bad[step])
    twin.pump()
    scores, _ = _batches(1, seed=13)[0]
    twin.submit("bad", (scores, np.zeros(5, dtype=np.int32)))  # 17 vs 5 rows
    twin.pump()  # must not raise
    twin.submit("good", good[2])
    twin.pump()
    assert isinstance(twin.submit("bad", bad[0]), Rejected)
    twin.check("good", good)
    twin.check_counts()


def test_quarantine_purges_the_backlog_and_emits_events(tmp_path):
    for events, health, flightrec, side in (
        (jax_events, jax_health, jax_flightrec, "jax"),
        (port_events, port_health, port_flightrec, "port"),
    ):
        events.enable()
        health.enable(raise_on_corrupt=True)
        flightrec.enable(dir=str(tmp_path / side), cooldown_s=0.0)
    twin = Twin(group_width=2)
    twin.open("poison")
    twin.submit("poison", _nan_batch())
    tail = _batches(3, seed=5)
    for b in tail:
        twin.submit("poison", b)  # queued behind the poison
    twin.pump()
    stats = twin.port.stats()
    assert stats["counts"]["dispatched"] == 1 and stats["queue_depth"] == 0
    twin.check_counts()
    mine = [e for e in port_events.events() if e.kind == "quarantine"]
    theirs = [e for e in jax_events.events() if e.kind == "quarantine"]
    assert len(mine) == len(theirs) == 1
    assert (mine[0].tenant, mine[0].reason, mine[0].batches_dropped) == (
        theirs[0].tenant, theirs[0].reason, theirs[0].batches_dropped) == (
        "poison", "data-corruption", len(tail))
    assert port_flightrec.bundles()
    from torcheval_tpu_torch import telemetry

    assert telemetry.report()["serve"]["quarantined"] == 1


def test_injected_admission_faults():
    svc = EvalService(group_width=2)
    svc.open("a", _port_suite())
    batch = _batches(1, seed=6)[0]
    with FaultPlan([{"site": "serve.admit", "action": "raise", "count": 1}]):
        with pytest.raises(InjectedFault):
            svc.submit("a", *batch)
        assert isinstance(svc.submit("a", *batch), Admitted)  # one-shot
    with FaultPlan([{"site": "serve.admit", "action": "delay", "delay_s": 0.05,
                     "count": 1}]):
        t0 = time.monotonic()
        assert isinstance(svc.submit("a", *batch), Admitted)
        assert time.monotonic() - t0 >= 0.05
    svc.pump()
    got, solo = svc.results("a"), _solo([batch, batch])
    assert all(got[k].numpy().tobytes() == solo[k].numpy().tobytes() for k in solo)
    # The JAX package's rule format drives both planes alike.
    jax_svc = jax_serve.EvalService(group_width=2)
    jax_svc.open("a", _jax_suite())
    with JaxFaultPlan([{"site": "serve.admit", "action": "raise", "count": 1}]):
        with pytest.raises(Exception, match="injected"):
            jax_svc.submit("a", *(jnp.asarray(x) for x in batch))


# ----------------------------------------------------------- rollback point
def test_dispatch_writes_no_state_in_place(megakernel):
    """The quarantine path rolls back from the pre-dispatch snapshot, so a
    dispatch must rebind every state it changes, never write one."""
    svc = EvalService(group_width=4)
    svc.open("a", _port_suite())
    svc.open("b", _port_suite())
    svc.submit("a", *_batches(1, seed=1)[0])
    svc.pump()
    col = svc.session("a").group.collection
    snapshot = col._read_states()
    values = {n: {s: v.clone() for s, v in per.items()} for n, per in snapshot.items()}
    for b in _batches(3, seed=2):
        svc.submit("a", *b)
        svc.submit("b", *b)
    svc.pump()
    after = col._read_states()
    changed = 0
    for name, per in snapshot.items():
        for s, v in per.items():
            assert torch.equal(v, values[name][s]), (name, s)  # untouched
            changed += after[name][s].data_ptr() != v.data_ptr()
    assert changed  # the dispatches did land, in new tensors


# ---------------------------------------------------------------- the drill
def test_overload_drill_with_poison_spill_and_burst(spill_root):
    """test_overload.py's acceptance drill at 8 tenants on width-4 groups:
    a burst over queue capacity, one poison tenant mid-stream, residency
    pressure forcing spill and resume, the background worker: every other
    tenant bit-identical to its solo suite, one bundle in all."""
    port_health.enable(raise_on_corrupt=True)
    port_events.enable()
    svc = EvalService(
        group_width=4,
        admission=AdmissionController(global_capacity=8, per_tenant_capacity=2,
                                      deadline_s=30.0),
        spill_dir=spill_root,
        max_resident=6,
    ).start()
    try:
        tenants = [f"tenant-{i}" for i in range(8)]
        streams = {t: _batches(3, seed=40 + i) for i, t in enumerate(tenants)}
        for t in tenants:
            svc.open(t, _port_suite())
        poison = tenants[5]
        applied = {t: [] for t in tenants}

        def submit_with_backoff(tenant, batch):
            deadline = time.monotonic() + 60.0
            while time.monotonic() < deadline:
                outcome = svc.submit(tenant, *batch)
                if isinstance(outcome, Admitted):
                    return
                assert isinstance(outcome, Shed)
                time.sleep(0.002)
            raise AssertionError(f"{tenant} never admitted")

        for step in range(3):
            for t in tenants:
                if t == poison and step >= 1:
                    if step == 1:
                        submit_with_backoff(t, _nan_batch())
                    continue
                if step == 2 and t == tenants[0]:
                    for _ in range(10):  # a rude client: no backoff
                        if isinstance(svc.submit(t, *streams[t][2]), Admitted):
                            applied[t].append(streams[t][2])
                    continue
                submit_with_backoff(t, streams[t][step])
                applied[t].append(streams[t][step])
        deadline = time.monotonic() + 60.0
        while svc.stats()["queue_depth"] and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        svc.stop()
    stats = svc.stats()
    assert stats["queue_depth"] == 0 and stats["programs"]["misses"] == 1
    assert stats["counts"]["spills"] > 0 and stats["counts"]["resumes"] > 0
    assert stats["counts"]["quarantined"] == 1 and stats["counts"]["shed"] > 0
    assert isinstance(svc.submit(poison, *streams[poison][0]), Rejected)
    for t in tenants:
        if t == poison:
            continue
        got, solo = svc.results(t), _solo(applied[t])
        assert all(got[k].numpy().tobytes() == solo[k].numpy().tobytes() for k in solo), t
