"""The port's resilience layer against the JAX package's: fault-plan
journals and backoff delays for the same rules and seeds, retried and
degraded collectives over ``LocalWorld`` ranks, the deadline that keeps a
missing rank from hanging its peers, ``make_synced_update(retry=)``, the
membership view, and checkpoints written by one package and resumed by
the other.  Everything on the CPU, at small sizes; every test that could
block has its own timeout."""

import json
import os
import pickle
import random
import threading
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as jm
from torcheval_tpu.resilience import CheckpointManager as JaxCheckpointManager
from torcheval_tpu.resilience import FaultPlan as JaxFaultPlan
from torcheval_tpu.resilience import MembershipView as JaxMembershipView
from torcheval_tpu.resilience import RetryPolicy as JaxRetryPolicy
from torcheval_tpu.resilience import faults as jax_faults

import torcheval_tpu_torch.metrics as tm
import torcheval_tpu_torch.parallel as tpar
from torcheval_tpu_torch.convert import state_from_jax
from torcheval_tpu_torch.distributed import LocalWorld, SingleProcessGroup
from torcheval_tpu_torch.metrics.functional.classification.confusion_matrix import (
    _confusion_matrix_update,
)
from torcheval_tpu_torch.resilience import (
    CheckpointManager,
    CollectiveTimeoutError,
    FaultPlan,
    FaultRule,
    InjectedFault,
    MembershipView,
    ResilientGroup,
    RetryPolicy,
    faults,
)
from torcheval_tpu_torch.resilience.membership import resolve_membership
from torcheval_tpu_torch.resilience.retry import retry_call, run_with_retry
from torcheval_tpu_torch.telemetry import events as port_events

from tests.test_torch_telemetry import reset_all

FAST = RetryPolicy(max_attempts=3, base_delay=0.001, max_delay=0.002, jitter=0.0)
C = 7


@pytest.fixture(autouse=True)
def _isolated():
    reset_all()
    yield
    reset_all()


# ------------------------------------------------------------ fault plans
_RULES = [
    {"site": "collective", "on_attempt": 1, "count": 3},
    {"site": "sync.dispatch", "after": 2, "count": 2, "match": {"op": "a"}},
    {"site": "checkpoint.write", "action": "tear", "offset": 5, "probability": 0.5,
     "count": None},
    {"site": "collective", "action": "delay", "delay_s": 0.0, "probability": 0.3,
     "count": None},
]
_HITS = (
    [("collective", {"op": "g", "attempt": a}) for a in (1, 2, 1, 1, 2, 1, 3)]
    + [("sync.dispatch", {"op": o}) for o in "abaaaba"]
    + [("checkpoint.write", {"generation": g, "nbytes": 10}) for g in range(12)]
)


def _replay(faults_mod, plan_cls, seed):
    plan = plan_cls(_RULES, seed=seed)
    outcomes = []
    with plan:
        for site, ctx in _HITS:
            try:
                rule = faults_mod.fire(site, **ctx)
                outcomes.append(None if rule is None else rule.action)
            except faults_mod.InjectedFault as exc:
                outcomes.append(f"raised:{exc.site}")
    journal = [(f.site, f.action, f.hit, f.context) for f in plan.fired]
    return outcomes, journal, dict(plan.hits)


@pytest.mark.parametrize("seed", [0, 7])
def test_fault_plan_journal_matches_jax(seed):
    assert _replay(faults, FaultPlan, seed) == _replay(jax_faults, JaxFaultPlan, seed)
    outcomes, journal, hits = _replay(faults, FaultPlan, seed)
    assert hits == {"collective": 7, "sync.dispatch": 7, "checkpoint.write": 12}
    assert outcomes.count("raised:collective") == 3 and outcomes.count("raised:sync.dispatch") == 2
    assert not faults.ENABLED and faults.active() is None


def test_fault_plan_rules_validate_and_do_not_nest():
    with pytest.raises(ValueError, match="action must be one of"):
        FaultRule(site="x", action="explode")
    with pytest.raises(ValueError, match="probability"):
        FaultRule(site="x", probability=1.5)
    with FaultPlan([{"site": "x"}]):
        assert faults.ENABLED
        with pytest.raises(RuntimeError, match="do not nest"):
            FaultPlan([]).install()
    with FaultPlan([{"site": "merge.level", "action": "drop_rank", "match": {"rank": 2}}]):
        with pytest.raises(faults.DroppedRank) as exc:
            faults.fire("merge.level", rank=2, level=1)
    assert exc.value.rank == 2 and isinstance(exc.value, InjectedFault)


def test_corrupt_batch_clones_on_the_batchs_own_device():
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    y = torch.tensor([1, 2])
    out = faults.corrupt_batch((y, x, x))
    assert out[0] is y and out[2] is x and torch.isnan(out[1][0, 0])
    assert out[1].device == x.device and not torch.isnan(x).any()
    assert torch.equal(out[1].view(-1)[1:], x.view(-1)[1:])
    # numpy arrays take the JAX package's path, element for element.
    a = np.arange(4, dtype=np.float64)
    ours, theirs = faults.corrupt_batch((a,))[0], jax_faults.corrupt_batch((a,))[0]
    np.testing.assert_array_equal(ours, theirs)
    assert not np.isnan(a).any()
    assert faults.corrupt_batch((y,))[0] is y


# ------------------------------------------------------------------ retry
@pytest.mark.parametrize("seed", [0, 3, 11])
def test_backoff_delays_match_jax(seed):
    kw = dict(max_attempts=6, base_delay=0.01, max_delay=0.05, jitter=0.25, seed=seed)
    ours, theirs = random.Random(seed), random.Random(seed)
    assert [RetryPolicy(**kw).backoff(a, ours) for a in range(1, 6)] == [
        JaxRetryPolicy(**kw).backoff(a, theirs) for a in range(1, 6)]
    with pytest.raises(ValueError):
        RetryPolicy(max_attempts=0)
    with pytest.raises(ValueError):
        RetryPolicy(deadline=0)


def test_retry_call_recovers_and_exhausts():
    port_events.enable()
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "done"

    assert retry_call("op", flaky, FAST) == "done" and len(calls) == 3
    retries = port_events.events("retry")
    assert [(e.op, e.attempt) for e in retries] == [("op", 1), ("op", 2)]
    assert "transient" in retries[0].error

    class Down(RuntimeError):
        peer = 4

    def down():
        raise Down("gone")

    with pytest.raises(CollectiveTimeoutError, match="slowest peer: rank 4") as exc:
        retry_call("op", down, FAST)
    assert (exc.value.attempts, exc.value.peer) == (3, 4)
    assert isinstance(exc.value.__cause__, Down)


def _run_world(size, fn, timeout=30.0):
    """``LocalWorld(size).run(fn)`` on a helper thread, failing the test
    (not hanging it) past ``timeout`` seconds."""
    world = LocalWorld(size)
    box = {}

    def target():
        try:
            box["out"] = world.run(fn)
        except BaseException as e:  # noqa: BLE001 - relayed to the test
            box["err"] = e

    t = threading.Thread(target=target, daemon=True)
    t.start()
    t.join(timeout)
    if t.is_alive():
        world._barrier.abort()
        pytest.fail(f"LocalWorld({size}) did not finish within {timeout}s")
    if "err" in box:
        raise box["err"]
    return box["out"]


@pytest.mark.parametrize("size", [2, 3])
def test_resilient_group_recovers_over_a_local_world(size):
    port_events.enable()

    def body(g, r):
        group = ResilientGroup(g, FAST)
        gathered = group.all_gather_object(r)
        total = group.all_reduce(torch.tensor([r, 1]))
        return gathered, group.broadcast_object(r * 10, src=size - 1), total

    rules = [{"site": "collective", "on_attempt": 1, "count": size},
             {"site": "collective", "on_attempt": 2, "count": size}]
    with FaultPlan(rules) as plan:
        out = _run_world(size, body)
    want_total = torch.tensor([sum(range(size)), size])
    for gathered, bcast, total in out:
        assert gathered == list(range(size)) and bcast == (size - 1) * 10
        assert torch.equal(total, want_total)
    assert len(plan.fired) == 2 * size
    assert port_events.aggregates()["resilience"]["retries"]["all_gather_object"]["attempts"] \
        == 2 * size


def test_resilient_group_exhaustion_names_the_silent_peer():
    def body(g, r):
        group = ResilientGroup(g, FAST)
        assert group.supports_p2p
        if r == 0:
            with pytest.raises(CollectiveTimeoutError) as exc:
                group.recv_object(1, "never-sent", timeout=0.01)
            assert (exc.value.op, exc.value.peer, exc.value.attempts) == ("recv_object", 1, 3)
            group.send_object("hi", 1, "t")
            return "done"
        return group.recv_object(0, "t", timeout=10)

    assert _run_world(2, body) == ["done", "hi"]


def test_degrade_local_serves_the_local_view():
    port_events.enable()

    def body(g, r):
        view = MembershipView(2, r)
        group = ResilientGroup(g, FAST, degrade="local", membership=view)
        gathered = group.all_gather_object(r)
        gathered_dst = group.gather_object(r, dst=0)
        bcast = group.broadcast_object(f"mine{r}", src=0)
        return gathered, gathered_dst, bcast

    # The warnings filters are process-wide: record them here, not in the
    # rank threads.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with FaultPlan([{"site": "collective", "count": None}]):
            out = _run_world(2, body)
    assert out == [([0], [0], "mine0"), ([1], None, "mine1")]
    assert sum(issubclass(w.category, RuntimeWarning) for w in caught) == 6
    degraded = port_events.events("degraded")
    assert len(degraded) == 6 and {e.survivors for e in degraded} == {"0,1"}
    with pytest.raises(ValueError, match="degrade must be one of"):
        ResilientGroup(SingleProcessGroup(), degrade="nonsense")


def test_deadline_cuts_a_rank_that_never_joins():
    world = LocalWorld(2)
    group = ResilientGroup(world.group(0), RetryPolicy(max_attempts=3, base_delay=0.001,
                                                       deadline=0.4))
    t0 = time.monotonic()
    try:
        with pytest.raises(CollectiveTimeoutError, match="deadline 0.4s"):
            group.all_gather_object("alone")  # rank 1 never calls
    finally:
        world._barrier.abort()  # frees the abandoned attempt's thread
    assert time.monotonic() - t0 < 0.4 + 2.0


def test_passthrough_on_a_single_process_group():
    group = ResilientGroup(SingleProcessGroup(), FAST)
    assert (group.rank, group.world_size, group.supports_p2p) == (0, 1, False)
    assert group.all_gather_object(5) == [5]
    assert group.broadcast_object("x", src=0) == "x"
    assert group.gather_object("x") == ["x"]
    assert torch.equal(group.all_reduce(torch.ones(2), "max"), torch.ones(2))
    with pytest.raises(CollectiveTimeoutError):
        group.send_object(1, 0, "t")  # no channel: every attempt raises


def test_run_with_retry_fires_the_site_inside_the_try():
    seen = []
    with FaultPlan([{"site": "site.x", "on_attempt": 1}]) as plan:
        assert run_with_retry("op", lambda: seen.append(1) or "ok", FAST,
                              fault_site="site.x") == "ok"
    assert len(seen) == 1 and [f.context for f in plan.fired] == [{"op": "op", "attempt": 1}]


# ---------------------------------------------------- make_synced_update
def _cm_step(size, retry, p, t):
    def fn(g, r):
        mesh = tpar.make_mesh(group=g)
        step = tpar.make_synced_update(
            lambda a, b: _confusion_matrix_update(a, b, C), mesh, retry=retry)
        return [step(*tpar.shard_batch(mesh, p, t)) for _ in range(2)]

    return _run_world(size, fn)


@pytest.mark.parametrize("size", [2, 3])
def test_synced_update_with_retry_matches_the_fault_free_bits(size):
    rng = np.random.default_rng(size)
    p = torch.from_numpy(rng.integers(0, C, 60).astype(np.int32))
    t = torch.from_numpy(rng.integers(0, C, 60).astype(np.int32))
    clean = _cm_step(size, None, p, t)
    port_events.enable()
    with FaultPlan([{"site": "sync.dispatch", "count": 1}]) as plan:
        retried = _cm_step(size, FAST, p, t)
    assert len(plan.fired) == 1 and plan.hits["sync.dispatch"] == 2 * size + 1
    want = np.zeros((C, C), np.int64)
    np.add.at(want, (t.numpy(), p.numpy()), 1)
    for rank_clean, rank_retried in zip(clean, retried):
        for a, b in zip(rank_clean, rank_retried):
            assert torch.equal(a, b) and np.array_equal(b.numpy(), want)
    assert len(port_events.events("retry")) == 1
    syncs = [e for e in port_events.events("sync") if e.op.startswith("synced_update")]
    cm = retried[0][0]
    assert len(syncs) == 2 * size and {e.payload_bytes for e in syncs} == {
        cm.numel() * cm.element_size()}
    with FaultPlan([{"site": "sync.dispatch", "count": None}]):
        with pytest.raises(CollectiveTimeoutError, match="synced_update"):
            tpar.make_synced_update(lambda v: v, tpar.make_mesh(), retry=FAST)(torch.ones(1))


def test_a_fault_after_the_collective_desynchronises_the_ranks():
    # The order sync.dispatch avoids: a rank that fails AFTER its
    # collective retries into a round its peers have left.  Only the
    # deadline gets it out.
    policy = RetryPolicy(max_attempts=2, base_delay=0.001, deadline=0.5)
    world = LocalWorld(2)
    failed = []

    def attempt(g, r):
        out = g.all_gather_object(r)
        if r == 0 and not failed:
            failed.append(1)
            raise RuntimeError("after the collective")
        return out

    errors = {}

    def rank(r):
        try:
            retry_call("late", lambda: attempt(world.group(r), r), policy)
        except CollectiveTimeoutError as e:
            errors[r] = e

    threads = [threading.Thread(target=rank, args=(r,), daemon=True) for r in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(10)
    world._barrier.abort()
    assert not any(th.is_alive() for th in threads)
    assert list(errors) == [0]


# ------------------------------------------------------------- membership
def test_membership_view_matches_jax():
    port_events.enable()
    views = (MembershipView(5, 1), JaxMembershipView(5, 1))
    for v in views:
        v.observe(2, level=1)
        assert v.excise(3, "silent") and not v.excise(3) and not v.excise(1)
        v.merge_gossip([4, 3])
    snaps = [v.snapshot() for v in views]
    for s in snaps:
        s["last_seen"] = {r: x["level"] for r, x in s["last_seen"].items()}
    assert snaps[0] == snaps[1]
    assert views[0].survivors_label() == "0,1,2" and views[0].world_effective == 3
    assert [(e.op, e.fallback, e.survivors) for e in port_events.events("degraded")] == [
        ("membership", "excised", "0,1,2,4"), ("membership", "excised", "0,1,2")]
    assert resolve_membership(None, 3, 0).world_size == 3
    with pytest.raises(ValueError, match="membership view is for rank"):
        resolve_membership(views[0], 4, 1)


# ------------------------------------------------------------- checkpoint
def _stream_batches(seed=0, sizes=(33, 70, 150, 97)):
    rng = np.random.default_rng(seed)
    return [(rng.random((b, C), dtype=np.float32), rng.integers(0, C, b).astype(np.int32))
            for b in sizes]


def _jax_collection():
    return jm.MetricCollection(
        {"acc": jm.MulticlassAccuracy(num_classes=C, average="macro"),
         "f1": jm.MulticlassF1Score(num_classes=C, average="macro"),
         "cm": jm.MulticlassConfusionMatrix(num_classes=C)},
        bucket=True, donate=False)


def _port_collection():
    return tm.MetricCollection(
        {"acc": tm.MulticlassAccuracy(num_classes=C, average="macro", device="cpu"),
         "f1": tm.MulticlassF1Score(num_classes=C, average="macro", device="cpu"),
         "cm": tm.MulticlassConfusionMatrix(num_classes=C, device="cpu")},
        bucket=True)


def _close(port_out, jax_out):
    for k in jax_out:
        want = np.asarray(jax_out[k])
        got = port_out[k].numpy()
        if want.dtype.kind in "iu":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCHEVAL_TPU_MEGAKERNEL", "1")
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "1")
    batches = _stream_batches()
    whole = _jax_collection()
    for x, y in batches:
        whole.fused_update(jnp.asarray(x), jnp.asarray(y))
    first = _jax_collection()
    for x, y in batches[:2]:
        first.fused_update(jnp.asarray(x), jnp.asarray(y))
    JaxCheckpointManager(str(tmp_path)).save(first.state_dict(), {"batches_seen": 2})
    ckpt = CheckpointManager(str(tmp_path)).load_latest()
    assert ckpt.cursor == {"batches_seen": 2} and ckpt.generation == 0
    resumed = _port_collection()
    resumed.load_state_dict(state_from_jax(ckpt.state))
    for x, y in batches[ckpt.cursor["batches_seen"]:]:
        resumed.fused_update(torch.from_numpy(x), torch.from_numpy(y))
    _close(resumed.compute(), whole.compute())


def test_a_port_checkpoint_resumes_in_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("TORCHEVAL_TPU_MEGAKERNEL", "1")
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "1")
    port_events.enable()
    batches = _stream_batches(seed=1)
    whole = _port_collection()
    for x, y in batches:
        whole.fused_update(torch.from_numpy(x), torch.from_numpy(y))
    first = _port_collection()
    for x, y in batches[:3]:
        first.fused_update(torch.from_numpy(x), torch.from_numpy(y))
    path = CheckpointManager(str(tmp_path)).save(first.state_dict(), {"batches_seen": 3})
    # The payload holds numpy arrays, ints and strs only: no torch object.
    with open(path, "rb") as fh:
        record = pickle.loads(fh.read())
    assert all(type(v) is np.ndarray for v in record["state"].values())
    assert "torch" not in pickle.dumps(record).decode("latin-1")
    ckpt = JaxCheckpointManager(str(tmp_path)).load_latest()
    resumed = _jax_collection()
    resumed.load_state_dict({k: jnp.asarray(v) for k, v in ckpt.state.items()})
    for x, y in batches[3:]:
        resumed.fused_update(jnp.asarray(x), jnp.asarray(y))
    _close(whole.compute(), resumed.compute())
    saves = port_events.events("checkpoint")
    assert [(e.action, e.generation, e.nbytes) for e in saves] == [
        ("save", 0, os.path.getsize(path))]


def _state(i):
    return {"a/n": torch.arange(4, dtype=torch.int64) + i, "a/s": torch.tensor(float(i))}


def test_quarantine_and_pruning_match_jax(tmp_path):
    port_events.enable()
    results = {}
    for name, mgr_cls, plan_cls, inj in (
        ("port", CheckpointManager, FaultPlan, InjectedFault),
        ("jax", JaxCheckpointManager, JaxFaultPlan, jax_faults.InjectedFault),
    ):
        d = tmp_path / name
        mgr = mgr_cls(str(d), keep=2)
        for i in range(3):
            mgr.save({k: np.asarray(v) for k, v in _state(i).items()}, {"i": i})
        assert mgr.generations() == [1, 2]
        with plan_cls([{"site": "checkpoint.write", "action": "tear", "offset": 7}]):
            with pytest.raises(inj, match="torn checkpoint write at byte 7"):
                mgr.save({k: np.asarray(v) for k, v in _state(3).items()}, {"i": 3})
        torn = mgr.load_latest()
        # Flip one byte of the newest valid generation: its hash no longer
        # matches, so the previous one loads.
        data = d / "ckpt-00000002.bin"
        raw = bytearray(data.read_bytes())
        raw[-3] ^= 0xFF
        data.write_bytes(bytes(raw))
        flipped = mgr.load_latest()
        results[name] = (
            torn.generation, torn.cursor, flipped.generation, flipped.cursor,
            sorted(os.listdir(d)),
            {k: np.asarray(v).tolist() for k, v in flipped.state.items()},
        )
    assert results["port"] == results["jax"]
    assert results["port"][:4] == (2, {"i": 2}, 1, {"i": 1})
    assert "ckpt-00000003.bin.corrupt" in results["port"][4]
    quarantined = [e for e in port_events.events("checkpoint") if e.action == "quarantine"]
    assert [e.generation for e in quarantined] == [3, 2]
    assert CheckpointManager(str(tmp_path / "empty")).load_latest() is None
    with pytest.raises(ValueError, match="keep must be >= 1"):
        CheckpointManager(str(tmp_path), keep=0)


def test_blob_export_import_and_namespaces(tmp_path):
    src = CheckpointManager(str(tmp_path / "src"))
    src.save(_state(5), {"i": 5})
    blob = src.export_latest()
    dst = CheckpointManager(str(tmp_path / "dst")).namespace("tenant/a b")
    assert dst.directory.endswith("tenant_a_b")
    assert dst.import_blob(blob) and dst.import_blob(blob)
    loaded = dst.load_latest()
    assert loaded.cursor == {"i": 5} and np.array_equal(loaded.state["a/n"], np.arange(4) + 5)
    bad = type(blob)(blob.generation, dict(blob.manifest), blob.payload[:-1])
    assert not CheckpointManager(str(tmp_path / "bad")).import_blob(bad)
    manifest = json.loads((tmp_path / "src" / "ckpt-00000000.manifest.json").read_text())
    assert set(manifest) == {"version", "generation", "sha256", "nbytes", "cursor"}
    dst.delete_all()
    assert not os.path.exists(dst.directory)


# --------------------------------------- the kernels' call sites, on the CPU
def test_retried_sharded_calls_reach_the_kernels_plain_versions():
    """The CPU twin of the card's retried calls: the slab's plain version
    once a rank and once more for the failed rank's retry, and the rank-sum
    plain version once a rank when every rank's first attempt fails."""
    from torcheval_tpu_torch.ops import _build

    rng = np.random.default_rng(42)
    p = torch.from_numpy(rng.integers(0, 100, 4000).astype(np.int32))
    t = torch.from_numpy(rng.integers(0, 100, 4000).astype(np.int32))

    def cm_world(g, r):
        mesh = tpar.make_mesh(group=g)
        step = tpar.make_synced_update(
            lambda a, b: _confusion_matrix_update(a, b, 100), mesh, retry=FAST)
        return step(*tpar.shard_batch(mesh, p, t))

    clean = _run_world(4, cm_world)
    _build.reset_counts()
    with FaultPlan([{"site": "sync.dispatch", "count": 1}]):
        retried = _run_world(4, cm_world)
    assert dict(_build.PLAIN_CALLS) == {"confusion_slab": 5}
    assert all(torch.equal(a, b) for a, b in zip(clean, retried))

    s = torch.from_numpy(rng.random((2**15, 64), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 64, 2**15).astype(np.int32))

    def ustat_world(wrap):
        return lambda g, r: tpar.sharded_multiclass_auroc_ustat(
            *tpar.shard_batch(tpar.make_mesh(group=g), s, y),
            tpar.make_mesh(group=ResilientGroup(g, FAST) if wrap else g),
            num_classes=64, average=None)

    clean = _run_world(4, ustat_world(False))
    _build.reset_counts()
    with FaultPlan([{"site": "collective", "on_attempt": 1, "count": 4}]) as plan:
        retried = _run_world(4, ustat_world(True))
    assert len(plan.fired) == 4 and dict(_build.PLAIN_CALLS) == {"rank_sum_counts": 4}
    assert all(torch.equal(a, b) for a, b in zip(clean, retried))
