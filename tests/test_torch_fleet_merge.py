"""The port's elastic fleet merge (``parallel/fleet_merge.py``) against the
JAX package's, case by case after ``tests/resilience/test_fleet_merge.py``
and ``test_rank_fleet.py``: the same numpy data on every rank of each
package's ``LocalWorld``, the same ``MergePolicy`` and the same
``FaultPlan`` rules.  The outcome (value, ``partial``, ``world_effective``,
``lost_ranks``, ``delivered``, ``levels``) must be equal, the value bit for
bit; on clean runs the telemetry event streams must be equal too, less
their volatile fields.  Every test ends with no thread of its own alive.
Everything on the CPU, at small sizes."""

import importlib
import threading
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as jm
from torcheval_tpu.distributed import LocalWorld as JaxLocalWorld
from torcheval_tpu.metrics.toolkit import sync_and_compute as jax_sync_and_compute
from torcheval_tpu.resilience import FaultPlan as JaxFaultPlan
from torcheval_tpu.resilience import MembershipView as JaxMembershipView
from torcheval_tpu.telemetry import events as jax_events

import torcheval_tpu_torch.metrics as tm
from torcheval_tpu_torch.distributed import CollectiveGroup, LocalWorld, PeerTimeoutError
from torcheval_tpu_torch.engine import Evaluator
from torcheval_tpu_torch.metrics.toolkit import sync_and_compute
from torcheval_tpu_torch.parallel import MergeOutcome, MergePolicy, PendingMerge, fleet_merge
from torcheval_tpu_torch.resilience import FaultPlan, MembershipView
from torcheval_tpu_torch.telemetry import events as port_events

from tests.test_torch_rank_sketch import TOL as RANK_TOL
from tests.test_torch_telemetry import reset_all, stream, update_bytes_dropped

# The module (the package's ``fleet_merge`` attribute is the function).
jax_fm = importlib.import_module("torcheval_tpu.parallel.fleet_merge")

# A fault-free round returns as soon as every message is in, whatever the
# deadline, so the fault-free cases take a generous one: under the
# parallel load of a whole test run a short deadline can excise a live
# but descheduled rank.  The cases with fault rules keep a small unit
# deadline, which keeps the drop scenarios (whose detection times grow
# exponentially with subtree height) fast: the JAX chaos tests' 0.25 s.
_CLEAN = dict(level_deadline=10.0, poll_slice=0.01)
_DROP = dict(level_deadline=0.25, poll_slice=0.01)

_PKG = {
    "jax": dict(world=JaxLocalWorld, merge=jax_fm.fleet_merge, policy=jax_fm.MergePolicy,
                plan=JaxFaultPlan),
    "port": dict(world=LocalWorld, merge=fleet_merge, policy=MergePolicy, plan=FaultPlan),
}


@pytest.fixture(autouse=True)
def _isolated():
    reset_all()
    before = set(threading.enumerate())
    yield
    reset_all()
    # An attempt a ResilientGroup abandoned at its deadline ends within
    # its own receive timeout; nothing else of a merge may outlive it.
    deadline = time.monotonic() + 15.0
    for t in set(threading.enumerate()) - before:
        t.join(max(0.0, deadline - time.monotonic()))
    left = [t.name for t in set(threading.enumerate()) - before if t.is_alive()]
    assert not left, left


def _data(rank, n=200, seed=100):
    rng = np.random.default_rng(seed + rank)
    scores = rng.random(n).astype(np.float32)
    targets = (rng.random(n) < scores).astype(np.float32)
    return scores, targets


def _metric(pkg, rank, cls="BinaryAUROC", n=200, seed=100, **kw):
    scores, targets = _data(rank, n, seed)
    if pkg == "jax":
        m = getattr(jm, cls)(**kw)
        return m.update(jnp.asarray(scores), jnp.asarray(targets))
    m = getattr(tm, cls)(device="cpu", **kw)
    return m.update(torch.from_numpy(scores), torch.from_numpy(targets))


def _flat_value(ranks, cls="BinaryAUROC"):
    """The flat path's merge order in the port: rank 0's state, the rest
    folded in rank order."""
    metrics = [_metric("port", r, cls) for r in ranks]
    for m in metrics:
        m._prepare_for_merge_state()
    metrics[0].merge_state(metrics[1:])
    return float(metrics[0].compute())


def _run(pkg, world, topology="tree", policy=None, rules=(), dst=0, recipient=None,
         sketch=None, sketch_options=None, make=None):
    """One merge round of ``pkg`` over its LocalWorld, one thread per rank
    (``policy`` defaults to ``_DROP`` with fault rules, else ``_CLEAN``).
    Returns (outcomes, events, seconds); asserts no rank hangs or raises."""
    if policy is None:
        policy = _DROP if rules else _CLEAN
    p = _PKG[pkg]
    w = p["world"](world)
    outs, errors = [None] * world, []
    make = make or (lambda r: _metric(pkg, r))

    def worker(rank):
        try:
            outs[rank] = p["merge"](
                make(rank), w.group(rank), topology=topology, dst=dst, recipient=recipient,
                sketch=sketch, sketch_options=sketch_options, policy=p["policy"](**policy))
        except BaseException as exc:  # noqa: BLE001 - asserted below
            errors.append((rank, exc))

    events = (jax_events if pkg == "jax" else port_events)
    events.enable()
    events.clear()
    plan = p["plan"](rules=[dict(r) for r in rules], seed=0) if rules else None
    threads = [threading.Thread(target=worker, args=(r,)) for r in range(world)]
    started = time.monotonic()
    if plan is not None:
        plan.install()
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=90.0)
        assert not any(t.is_alive() for t in threads), "merge hung"
    finally:
        if plan is not None:
            plan.uninstall()
    seconds = time.monotonic() - started
    got = events.events()
    events.disable()
    assert not errors, errors
    return outs, got, seconds


def _value(v):
    return np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)


_FIELDS = ("partial", "world_size", "world_effective", "lost_ranks", "delivered", "dropped",
           "topology", "levels", "rank", "sketch")


def _both(world, **kw):
    """Run the JAX merge, then the port's, and hold every rank's outcome
    against JAX's; returns the port's outcomes and both event lists."""
    jax_outs, jax_evs, _ = _run("jax", world, **kw)
    port_outs, port_evs, seconds = _run("port", world, **kw)
    for j, p in zip(jax_outs, port_outs):
        assert isinstance(p, MergeOutcome)
        assert {f: getattr(p, f) for f in _FIELDS} == {f: getattr(j, f) for f in _FIELDS}
        if j.value is None:
            assert p.value is None
        else:
            np.testing.assert_array_equal(_value(p.value), np.asarray(j.value))
    return port_outs, (jax_evs, port_evs), seconds


def _same_events(evs):
    jax_evs, port_evs = evs
    key = lambda e: repr(e)  # noqa: E731 - the threads interleave: compare as multisets
    assert sorted(stream(port_evs), key=key) == sorted(
        update_bytes_dropped(stream(jax_evs)), key=key)


def _drop(rank, role="recv"):
    return ({"site": "merge.level", "action": "drop_rank", "match": {"rank": rank, "role": role}},)


# ------------------------------------------------------ clean-run identity
@pytest.mark.parametrize("world", [2, 3, 5, 8, 16])
@pytest.mark.parametrize("topology", ["tree", "ring"])
def test_tree_and_ring_match_flat_and_jax(world, topology):
    outs, evs, _ = _both(world, topology=topology)
    root = outs[0]
    assert float(root.value) == _flat_value(range(world))
    assert not root.partial and root.world_effective == world and root.lost_ranks == ()
    assert root.payload_bytes_at_root == 200 * 2 * 4 * world
    _same_events(evs)
    hops = [e for e in evs[1] if e.kind == "sync"]
    assert {e.op for e in hops} == {"fleet_merge"} and all(e.level >= 1 for e in hops)
    assert {e.fanout for e in hops} == {2 if topology == "tree" else 1}


def test_auprc_tree_matches_flat():
    jax_outs, jax_evs, _ = _run("jax", 4, make=lambda r: _metric("jax", r, "BinaryAUPRC"))
    outs, port_evs, _ = _run("port", 4, make=lambda r: _metric("port", r, "BinaryAUPRC"))
    assert float(outs[0].value) == _flat_value(range(4), "BinaryAUPRC")
    # AUPRC is a float sum, held against JAX at the port's AUPRC tolerance
    # (tests/test_torch_auprc.py).
    np.testing.assert_allclose(float(outs[0].value), float(jax_outs[0].value), rtol=0, atol=1e-6)
    _same_events((jax_evs, port_evs))


def test_nonzero_dst_root():
    outs, evs, _ = _both(5, dst=3)
    assert outs[0].value is None and float(outs[3].value) == _flat_value(range(5))
    _same_events(evs)


def test_recipient_all_delivers_value_everywhere():
    outs, evs, _ = _both(4, recipient="all")
    for out in outs:
        assert float(_value(out.value)) == _flat_value(range(4)) and not out.partial
    _same_events(evs)


def test_world_one_short_circuits():
    out = fleet_merge(_metric("port", 0), LocalWorld(1).group(0), topology="tree")
    jax_out = jax_fm.fleet_merge(_metric("jax", 0), JaxLocalWorld(1).group(0), topology="tree")
    assert out.delivered and out.world_effective == 1 and out.levels == jax_out.levels == 0
    assert float(out.value) == float(jax_out.value) == float(_metric("port", 0).compute())


def test_repeated_rounds_use_fresh_tags():
    w = LocalWorld(2)
    for _ in range(3):
        outs = [None, None]

        def worker(rank):
            outs[rank] = fleet_merge(_metric("port", rank), w.group(rank), topology="tree",
                                     policy=MergePolicy(**_CLEAN))

        threads = [threading.Thread(target=worker, args=(r,)) for r in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert float(outs[0].value) == _flat_value(range(2))
    assert not w._mail  # every message of every round was claimed


# --------------------------------------------------------- drop scenarios
def test_leaf_drop_goes_partial_not_fatal():
    outs, _, _ = _both(8, policy=_DROP, rules=_drop(7, "start"))
    root = outs[0]
    assert root.lost_ranks == (7,) and root.world_effective == 7 and root.partial
    assert outs[7].dropped
    assert float(root.value) == _flat_value(range(7))


def test_inner_node_drop_reparents_subtree():
    # Rank 1 roots the subtree {1, 3, 4, 7}: only rank 1 is lost.
    outs, _, _ = _both(8, policy=_DROP, rules=_drop(1))
    root = outs[0]
    assert root.lost_ranks == (1,) and root.world_effective == 7 and root.partial
    assert float(root.value) == _flat_value([0, 2, 3, 4, 5, 6, 7])


def test_root_drop_never_hangs_and_delivers_nothing():
    outs, _, _ = _both(8, policy=_DROP, rules=_drop(0))
    assert outs[0].dropped
    assert all(outs[r].value is None for r in range(1, 8))
    assert not outs[1].delivered and not outs[2].delivered


def test_ring_middle_drop_skips_past_dead_rank():
    outs, _, _ = _both(8, topology="ring", policy=_DROP, rules=_drop(3))
    root = outs[0]
    assert 3 in root.lost_ranks and root.partial
    assert float(root.value) == _flat_value([r for r in range(8) if r not in root.lost_ranks])


def test_drop_completes_within_deadline_budget():
    policy = MergePolicy(**_DROP)
    unit = policy.ack() + policy.grace()
    budget = policy.poll_window(3) + policy.ack_wait(4) + 16 * unit
    _, _, seconds = _run("port", 8, policy=_DROP, rules=_drop(1))
    assert seconds < budget


def test_no_exception_escapes_any_rank():
    rules = tuple({"site": "merge.level", "action": "drop_rank", "match": {"rank": r}}
                  for r in (5, 6))
    outs, _, _ = _both(8, policy=_DROP, rules=rules)
    assert all(isinstance(o, MergeOutcome) for o in outs)
    root = outs[0]
    assert root.partial and root.world_effective == 8 - len(root.lost_ranks)
    assert set(root.lost_ranks) <= {5, 6}


def test_height3_drop_at_world16_keeps_live_subtree():
    # Rank 3 roots {3, 7, 8, 15}: its live parent's recovery keeps the
    # chain open with keepalives, so only rank 3 is lost.
    outs, _, _ = _both(16, policy=_DROP, rules=_drop(3))
    root = outs[0]
    assert root.lost_ranks == (3,) and root.world_effective == 15 and root.partial
    assert float(root.value) == _flat_value([r for r in range(16) if r != 3])


_SLOW_1 = ({"site": "merge.level", "action": "slow_rank",
            "match": {"rank": 1, "role": "send"}, "delay_s": 0.8},)


def test_slow_child_past_recv_deadline_is_absorbed_not_lost():
    outs, _, _ = _both(4, rules=_SLOW_1)
    root = outs[0]
    assert not root.partial and root.lost_ranks == () and root.world_effective == 4
    assert float(root.value) == _flat_value(range(4)) and outs[1].delivered


def test_recipient_all_reaches_wrongly_excised_rank():
    outs, _, _ = _both(4, rules=_SLOW_1, recipient="all")
    for out in outs:
        assert float(_value(out.value)) == _flat_value(range(4))
        assert not out.partial and out.world_effective == 4


def test_recipient_all_root_loss_blames_only_the_root():
    outs, _, _ = _both(8, policy=_DROP, rules=_drop(0, "start"), recipient="all")
    assert outs[0].dropped
    for out in outs[1:]:
        assert out.partial and out.lost_ranks == (0,) and out.world_effective == 7
        # Each survivor computes its own state: the JAX value of that rank.
        assert out.value is not None


def test_slow_rank_straggler_still_completes_clean():
    rules = ({"site": "merge.level", "action": "slow_rank",
              "match": {"rank": 3, "role": "send"}, "delay_s": 0.05},)
    outs, _, _ = _both(4, rules=rules)
    assert not outs[0].partial and float(outs[0].value) == _flat_value(range(4))


# ------------------------------------------------------------ sketch merge
def _flat_sketch(kind, world, cls="BinaryAUROC", **options):
    values = []
    for pkg in ("port", "jax"):
        sketches = []
        for rank in range(world):
            opts = dict(options)
            if kind == "reservoir":
                opts["salt"] = rank
            sketches.append(_metric(pkg, rank, cls).sketch_state(kind, **opts))
        base = sketches[0]
        for other in sketches[1:]:
            base.merge(other)
        values.append(float(_value(base.compute())))
    return values


@pytest.mark.parametrize("kind,options", [
    ("reservoir", {"capacity": 256}),
    ("histogram", {"bins": 2048}),
    ("count", {"width": 8192, "depth": 5}),
])
def test_tree_sketch_equals_flat_sketch_merge_and_jax(kind, options):
    outs, evs, _ = _both(8, sketch=kind, sketch_options=options)
    port_flat, jax_flat = _flat_sketch(kind, 8, **options)
    assert float(outs[0].value) == port_flat == jax_flat
    assert outs[0].payload_bytes_at_root > 0
    # Within the documented bounds of the exact value.
    assert abs(float(outs[0].value) - _flat_value(range(8))) < {"reservoir": 0.08,
                                                               "histogram": 0.02,
                                                               "count": 0.05}[kind]
    _same_events(evs)


def test_sketch_bytes_beat_exact_state_bytes():
    from torcheval_tpu_torch.metrics._sketch import state_nbytes

    m = _metric("port", 0, n=50_000)
    m._prepare_for_merge_state()
    assert state_nbytes(m) / m.sketch_state("histogram", bins=1024).nbytes() > 10.0


# ------------------------------------------------------- rank-sketch fleet
def _sketch_metric(pkg, rank, n=8192):
    return _metric(pkg, rank, n=n, seed=300, sketch=True)


@pytest.mark.parametrize("world", [2, 3, 5, 8, 16])
def test_rank_tree_matches_flat_at_every_world(world):
    outs, evs, _ = _both_rank(world)
    metrics = [_sketch_metric("port", r) for r in range(world)]
    metrics[0].merge_state(metrics[1:])
    assert not outs[0].partial and outs[0].sketch == "rank"
    assert float(outs[0].value) == float(metrics[0].compute())
    _same_events(evs)


def _both_rank(world, topology="tree", sketch="rank"):
    jax_outs, jax_evs, _ = _run("jax", world, topology=topology, sketch=sketch,
                                make=lambda r: _sketch_metric("jax", r))
    port_outs, port_evs, _ = _run("port", world, topology=topology, sketch=sketch,
                                  make=lambda r: _sketch_metric("port", r))
    for j, p in zip(jax_outs, port_outs):
        assert {f: getattr(p, f) for f in _FIELDS} == {f: getattr(j, f) for f in _FIELDS}
        assert p.payload_bytes_at_root == j.payload_bytes_at_root
    # The compactor counts are integers, bit-equal between the packages;
    # the AUROC read from them is a float, held at the rank sketch's
    # tolerance (tests/test_torch_rank_sketch.py).
    np.testing.assert_allclose(float(port_outs[0].value), float(jax_outs[0].value),
                               rtol=0, atol=RANK_TOL)
    return port_outs, (jax_evs, port_evs), None


def test_rank_ring_matches_tree():
    tree, _, _ = _both_rank(5)
    ring, _, _ = _both_rank(5, topology="ring")
    assert float(tree[0].value) == float(ring[0].value)


def test_exact_gather_of_sketch_states_matches_rank():
    exact, _, _ = _both_rank(3, sketch=None)
    rank, _, _ = _both_rank(3)
    assert float(exact[0].value) == float(rank[0].value)


def test_rank_payload_10x_under_buffer_gather_at_world_8():
    buffered, _, _ = _run("port", 8, make=lambda r: _metric("port", r, n=8192, seed=300))
    ranked, _, _ = _both_rank(8)
    assert buffered[0].payload_bytes_at_root / ranked[0].payload_bytes_at_root >= 10.0


def test_rank_payload_independent_of_stream_length():
    short, _, _ = _run("port", 2, sketch="rank", make=lambda r: _sketch_metric("port", r, n=256))
    long, _, _ = _run("port", 2, sketch="rank", make=lambda r: _sketch_metric("port", r))
    assert short[0].payload_bytes_at_root == long[0].payload_bytes_at_root


# ------------------------------------------------------------- front door
def test_sync_and_compute_tree_returns_outcome():
    def body(mod, world_cls, pkg, **kw):
        w, outs = world_cls(2), [None, None]

        def worker(rank):
            outs[rank] = mod(_metric(pkg, rank), w.group(rank), topology="tree", **kw)

        threads = [threading.Thread(target=worker, args=(r,)) for r in (0, 1)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        return outs

    outs = body(sync_and_compute, LocalWorld, "port", merge_policy=MergePolicy(**_CLEAN))
    jax_outs = body(jax_sync_and_compute, JaxLocalWorld, "jax",
                    merge_policy=jax_fm.MergePolicy(**_CLEAN))
    assert isinstance(outs[0], MergeOutcome)
    assert float(outs[0].value) == float(jax_outs[0].value) == _flat_value(range(2))
    assert outs[1].value is None


def test_sync_and_compute_membership_is_carried_across_rounds():
    w, views = LocalWorld(2), [MembershipView(2, 0), MembershipView(2, 1)]
    outs = [None, None]

    def worker(rank):
        outs[rank] = sync_and_compute(_metric("port", rank), w.group(rank), topology="ring",
                                      merge_policy=MergePolicy(**_CLEAN), membership=views[rank])

    threads = [threading.Thread(target=worker, args=(r,)) for r in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert float(outs[0].value) == _flat_value(range(2))
    assert views[0].is_alive(1) and views[1].is_alive(0)
    with pytest.raises(ValueError, match="membership view is for rank"):
        sync_and_compute(_metric("port", 0), w.group(0), topology="tree",
                         membership=MembershipView(3, 0))


def test_no_p2p_group_falls_back_to_flat_with_warning():
    class NoP2P(CollectiveGroup):
        rank = property(lambda self: 0)
        world_size = property(lambda self: 2)

        def all_gather_object(self, obj):
            other = _metric("port", 1)
            other._prepare_for_merge_state()
            return [obj, other]

        def broadcast_object(self, obj, src):
            return obj

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        value = sync_and_compute(_metric("port", 0), NoP2P(), topology="tree")
    assert any("point-to-point" in str(w.message) for w in caught)
    assert float(value) == _flat_value(range(2))


def test_bad_topology_rejected():
    with pytest.raises(ValueError, match="topology must be"):
        sync_and_compute(_metric("port", 0), LocalWorld(1).group(0), topology="mesh")
    with pytest.raises(ValueError, match="topology must be 'tree' or 'ring'"):
        fleet_merge(_metric("port", 0), LocalWorld(2).group(0), topology="flat")
    with pytest.raises(ValueError, match="level_deadline must be positive"):
        MergePolicy(level_deadline=0)


# ------------------------------------------------------ membership and p2p
def test_observe_excise_and_gossip_match_jax():
    for view in (MembershipView(8, rank=0), JaxMembershipView(8, rank=0)):
        assert view.world_effective == 8
        assert view.excise(3, reason="test") and not view.excise(3, reason="again")
        assert not view.is_alive(3) and view.world_effective == 7
        view.merge_gossip([5, 6])
        assert sorted(view.dead) == [3, 5, 6] and view.survivors_label() == "0,1,2,4,7"
        view.observe(3)
        assert not view.is_alive(3)


def test_local_world_send_recv_and_timeout():
    w = LocalWorld(2)
    g0, g1 = w.group(0), w.group(1)
    assert g0.supports_p2p
    g0.send_object({"x": torch.ones(2)}, dst=1, tag="t/0")
    assert torch.equal(g1.recv_object(0, "t/0", timeout=1.0)["x"], torch.ones(2))
    started = time.monotonic()
    with pytest.raises(PeerTimeoutError) as exc:
        g0.recv_object(1, "never", timeout=0.05)
    assert time.monotonic() - started < 1.0 and exc.value.peer == 1


# ------------------------------------------------------------ engine overlap
def _batch(pkg, rank):
    rng = np.random.default_rng(200 + rank)
    preds, targets = rng.integers(0, 3, 64), rng.integers(0, 3, 64)
    if pkg == "jax":
        return jnp.asarray(preds), jnp.asarray(targets)
    return torch.from_numpy(preds), torch.from_numpy(targets)


def test_start_fleet_merge_overlaps_and_joins():
    w = LocalWorld(2)
    col = tm.MetricCollection({"acc": tm.MulticlassAccuracy(num_classes=3, device="cpu")})
    engine = Evaluator(col, prefetch=False)
    engine.step(*_batch("port", 0))

    def peer():
        other = tm.MetricCollection({"acc": tm.MulticlassAccuracy(num_classes=3, device="cpu")})
        other.update(*_batch("port", 1))
        fleet_merge(other, w.group(1), topology="tree", policy=MergePolicy(**_CLEAN))

    peer_thread = threading.Thread(target=peer)
    peer_thread.start()
    pending = engine.start_fleet_merge(w.group(0), topology="tree", policy=MergePolicy(**_CLEAN))
    assert isinstance(pending, PendingMerge)
    # The engine keeps stepping; the snapshot it merged does not move.
    engine.step(*_batch("port", 0))
    outcome = pending.result(timeout=30)
    peer_thread.join(timeout=30)
    assert pending.done() and outcome.delivered and not outcome.partial

    expected = jm.MetricCollection({"acc": jm.MulticlassAccuracy(num_classes=3)})
    expected.update(*_batch("jax", 0))
    expected.update(*_batch("jax", 1))
    assert float(outcome.value["acc"]) == float(expected.compute()["acc"])
    # The engine's own states after both steps: the per-batch loop's.
    loop = tm.MulticlassAccuracy(num_classes=3, device="cpu")
    for _ in range(2):
        loop.update(*_batch("port", 0))
    engine.flush()
    assert float(col["acc"].compute()) == float(loop.compute())


def test_pending_merge_relays_a_programming_error():
    def boom():
        raise KeyError("bad")

    pending = PendingMerge(boom, (), {})
    with pytest.raises(KeyError, match="bad"):
        pending.result(timeout=5)
