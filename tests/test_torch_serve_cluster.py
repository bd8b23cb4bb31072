"""The port's multi-host serve plane (``torcheval_tpu_torch.serve.cluster``,
``serve.placement`` and the serve frames of ``distributed.py``) against the
JAX package's.

* Frames and tags: ``pack_frames`` is byte for byte JAX's, each package
  unpacks the other's payload, unpacking is zero-copy, and the one kept
  divergence (a ``torch.bfloat16`` tensor has no numpy dtype) raises.
* Placement: the ring's owners, ``spread``, ``epoch`` and ``fingerprint()``
  equal JAX's for the same members, vnodes, excisions and overrides.
* The cluster: each scenario of ``tests/serve/test_cluster.py`` runs as one
  script through both packages' ``ServeCluster``s (the port's metrics on
  the CPU, the collection kernel forced on, so ``mega.cu``'s plain version
  dispatches every owner's batch).  Each package's tenants are bit-equal
  (``tobytes()``) to a solo, unsliced suite of the same package; the
  sequence of outcome actions, the ``lost`` sets and every tenant's seat
  states (integer counts) equal JAX's; the figures agree with JAX's within
  the serve plane's 1e-6 (their float epilogue is XLA's fused one there,
  as in tests/test_torch_serve.py).

The harness is JAX's: one test thread steps every cluster round-robin over
a ``LocalWorld``, with a shared spill directory; host kills land at exact
protocol points through ``FaultPlan`` rules on ``serve.route`` and
``serve.migrate``.  No assertion rests on wall-clock time.
"""

import threading
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.distributed as jax_dist
from torcheval_tpu import serve as jax_serve
from torcheval_tpu.metrics import BinaryAUROC as JaxBinaryAUROC
from torcheval_tpu.metrics import MulticlassAccuracy as JaxAccuracy
from torcheval_tpu.metrics import MulticlassF1Score as JaxF1
from torcheval_tpu.resilience import FaultPlan as JaxFaultPlan
from torcheval_tpu.serve import metering as jax_metering
from torcheval_tpu.serve import placement as jax_placement

import torcheval_tpu_torch.distributed as port_dist
from torcheval_tpu_torch import _flags, serve
from torcheval_tpu_torch.metrics import BinaryAUROC, MulticlassAccuracy, MulticlassF1Score
from torcheval_tpu_torch.ops import _build
from torcheval_tpu_torch.parallel import MergePolicy, fleet_merge
from torcheval_tpu_torch.resilience import FaultPlan
from torcheval_tpu_torch.serve import metering as port_metering
from torcheval_tpu_torch.serve import placement as port_placement
from torcheval_tpu_torch.serve.cluster import _placed

from tests.test_torch_telemetry import reset_all

C = 5
ROWS = 17
GROUP_WIDTH = 4
RTOL = 1e-6


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    # Forced on, the port's owners dispatch through mega.cu's plain version
    # here, the card's route.
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "1")
    reset_all()
    yield
    reset_all()


# ------------------------------------------------------------------ frames
def _frame_cases():
    rng = np.random.default_rng(0)
    base = rng.random((6, 4))
    return {
        "f32": rng.random((7, 3), dtype=np.float32),
        "f64": rng.random(5),
        "i32": rng.integers(-9, 9, 11).astype(np.int32),
        "i64": rng.integers(-9, 9, (2, 3)).astype(np.int64),
        "bool": rng.random(9) > 0.5,
        "0d": np.float32(2.5),
        "empty": np.zeros((0, 5), dtype=np.float32),
        "strided": base[::2, 1:],
    }


@pytest.mark.parametrize("case", sorted(_frame_cases()))
def test_pack_frames_bytes_equal_jax(case):
    value = _frame_cases()[case]
    args, kwargs = (value, value[..., ::-1] if np.ndim(value) else value), {"w": value}
    want = jax_dist.pack_frames(args, kwargs)
    assert port_dist.pack_frames(args, kwargs) == want
    # A CPU tensor frames as its numpy array.
    as_t = lambda v: torch.from_numpy(np.ascontiguousarray(v))  # noqa: E731
    assert port_dist.pack_frames(tuple(map(as_t, args)), {"w": as_t(value)}) == want


def test_non_contiguous_tensors_frame_as_their_values():
    base = np.random.default_rng(1).random((6, 4)).astype(np.float32)
    t = torch.from_numpy(base)
    views = (t[::2, 1:], t.t(), t[:, 2])
    assert not any(v.is_contiguous() for v in views)
    want = jax_dist.pack_frames((base[::2, 1:], base.T, base[:, 2]), {})
    assert port_dist.pack_frames(views, {}) == want


def test_each_package_unpacks_the_others_payload():
    cases = _frame_cases()
    args = tuple(cases[k] for k in sorted(cases))
    kwargs = {"mask": cases["bool"], "weight": cases["f64"]}
    for pack, unpack in ((jax_dist.pack_frames, port_dist.unpack_frames),
                         (port_dist.pack_frames, jax_dist.unpack_frames)):
        got_args, got_kwargs = unpack(pack(args, kwargs))
        assert len(got_args) == len(args) and set(got_kwargs) == set(kwargs)
        for got, want in list(zip(got_args, args)) + [
                (got_kwargs[k], v) for k, v in kwargs.items()]:
            want = np.ascontiguousarray(want)
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes()


def test_unpack_is_zero_copy_and_bad_magic_raises():
    payload = port_dist.pack_frames((np.arange(8, dtype=np.float64),), {})
    (arr,), _ = port_dist.unpack_frames(payload)
    assert arr.base is not None and not arr.flags.writeable
    assert np.shares_memory(arr, np.frombuffer(payload, dtype=np.uint8))
    for unpack in (port_dist.unpack_frames, jax_dist.unpack_frames):
        with pytest.raises(ValueError, match="bad magic"):
            unpack(b"NOPE" + b"\x00" * 16)


def test_bfloat16_frame_raises_typed():
    # The kept divergence: JAX would frame ml_dtypes' <V2, which does not
    # round-trip; the port refuses and names the dtype.
    with pytest.raises(TypeError, match="bfloat16"):
        port_dist.pack_frames((torch.zeros(3, dtype=torch.bfloat16),))
    assert port_dist.pack_frames((torch.zeros(3, dtype=torch.bfloat16).float(),)) == (
        jax_dist.pack_frames((np.zeros(3, dtype=np.float32),)))


def test_placed_frames_copy_once_without_a_warning():
    scores = np.arange(6, dtype=np.float32).reshape(2, 3)
    payload = port_dist.pack_frames((scores,), {"mask": np.ones(2, bool)})
    args, kwargs = port_dist.unpack_frames(payload)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        (t,), kw = _placed(args, kwargs, torch.device("cpu"))
    assert t.dtype == torch.float32 and torch.equal(t, torch.from_numpy(scores))
    assert kw["mask"].dtype == torch.bool
    # A copy: the tensor owns its memory, not the read-only wire buffer.
    assert not np.shares_memory(t.numpy(), args[0])
    t.add_(1)
    assert args[0][0, 0] == 0


def test_serve_tag_matches_jax_and_is_idempotent():
    assert port_dist.SERVE_TAG_NAMESPACE == jax_dist.SERVE_TAG_NAMESPACE == "serve/"
    for tag in ("m/0/1/0", "serve/x", "", "fm3/up"):
        assert port_dist.serve_tag(tag) == jax_dist.serve_tag(tag)
        assert port_dist.serve_tag(port_dist.serve_tag(tag)) == port_dist.serve_tag(tag)


# --------------------------------------------------------------- placement
_TENANTS = [f"tenant-{i}" for i in range(1000)]


@pytest.mark.parametrize("vnodes", [1, 64])
@pytest.mark.parametrize("world", range(1, 9))
def test_ring_owners_equal_jax(world, vnodes):
    mine = port_placement.HashRing(range(world), vnodes=vnodes)
    theirs = jax_placement.HashRing(range(world), vnodes=vnodes)
    assert [mine.owner_of(t) for t in _TENANTS] == [theirs.owner_of(t) for t in _TENANTS]
    assert mine.spread(_TENANTS) == theirs.spread(_TENANTS)


def test_epoch_and_fingerprint_equal_jax_after_excision_and_overrides():
    states = []
    for mod in (port_placement, jax_placement):
        p = mod.Placement(5, vnodes=16)
        assert p.exclude(3) and not p.exclude(3)
        assert p.note_migration("tenant-7", 1, 2)
        assert not p.note_migration("tenant-7", 4, 1)  # max version wins
        assert p.merge([3], {"tenant-9": (0, 1), "tenant-7": (2, 5)})
        assert not p.merge([3], {"tenant-7": (4, 5)})
        states.append((p.epoch, p.fingerprint(), p.alive, p.dead, p.snapshot(),
                       [p.owner_of(t) for t in _TENANTS[:200]],
                       [p.ring_owner_of(t) for t in _TENANTS[:200]]))
    assert states[0] == states[1]
    assert states[0][0] == 1 + 5 + 1
    for mod in (port_placement, jax_placement):
        assert [f.name for f in mod.PlacementOutcome.__dataclass_fields__.values()] == [
            "tenant", "action", "owner", "epoch", "detail", "value"]


def test_serve_flags_are_read_at_construction(monkeypatch, tmp_path):
    group = port_dist.LocalWorld(2).group(0)
    cluster = serve.ServeCluster(group, spill_dir=str(tmp_path))
    assert (cluster._vnodes, cluster._route_window, cluster._heartbeat_s) == (64, 64, 1.0)
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_SERVE_VNODES", "8")
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_SERVE_ROUTE_WINDOW", "3")
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_SERVE_HEARTBEAT_MS", "250")
    cluster = serve.ServeCluster(group, spill_dir=str(tmp_path))
    assert (cluster._vnodes, cluster._route_window, cluster._heartbeat_s) == (8, 3, 0.25)
    assert cluster._death_timeout_s == 5 * 0.25
    snap = _flags.snapshot_non_default()
    assert snap["TORCHEVAL_TPU_TORCH_SERVE_VNODES"] == 8
    assert snap["TORCHEVAL_TPU_TORCH_SERVE_HEARTBEAT_MS"] == 250
    for bad in ("0", "-2", "x"):
        monkeypatch.setenv("TORCHEVAL_TPU_TORCH_SERVE_ROUTE_WINDOW", bad)
        with pytest.raises(ValueError, match="SERVE_ROUTE_WINDOW"):
            serve.ServeCluster(group, spill_dir=str(tmp_path))


# ----------------------------------------------------------------- harness
class Side:
    """One package's half of a side-by-side script."""

    def __init__(self, pkg):
        self.pkg = pkg
        jax_side = pkg == "jax"
        self.World = jax_dist.LocalWorld if jax_side else port_dist.LocalWorld
        self.Cluster = jax_serve.ServeCluster if jax_side else serve.ServeCluster
        self.Service = jax_serve.EvalService if jax_side else serve.EvalService
        self.Plan = JaxFaultPlan if jax_side else FaultPlan
        self.metering = jax_metering if jax_side else port_metering
        self.Placement = jax_placement.Placement if jax_side else port_placement.Placement
        self.actions = []

    def suite(self):
        if self.pkg == "jax":
            return {"acc": JaxAccuracy(num_classes=C, average="macro"),
                    "f1": JaxF1(num_classes=C, average="macro")}
        return {"acc": MulticlassAccuracy(num_classes=C, average="macro", device="cpu"),
                "f1": MulticlassF1Score(num_classes=C, average="macro", device="cpu")}

    def batches(self, n, seed):
        rng = np.random.default_rng(seed)
        out = []
        for _ in range(n):
            scores = rng.random((ROWS, C), dtype=np.float32)
            target = rng.integers(0, C, ROWS).astype(np.int32)
            if self.pkg == "jax":
                out.append((jnp.asarray(scores), jnp.asarray(target)))
            else:
                out.append((torch.from_numpy(scores), torch.from_numpy(target)))
        return out

    def solo(self, batches):
        metrics = self.suite()
        for scores, target in batches:
            for m in metrics.values():
                m.update(scores, target)
        return {name: m.compute() for name, m in metrics.items()}

    @staticmethod
    def host(value):
        if isinstance(value, torch.Tensor):
            return value.detach().cpu().numpy()
        return np.asarray(value)

    def note(self, out):
        """Record one outcome's action (the cross-package sequence)."""
        self.actions.append(out.action)
        return out

    def assert_solo(self, got, batches):
        want = self.solo(batches)
        assert set(got) == set(want)
        for name in want:
            assert self.host(got[name]).tobytes() == self.host(want[name]).tobytes(), (
                f"{self.pkg}: {name} differs bitwise from the solo suite")
        return {name: float(self.host(v)) for name, v in got.items()}

    def seat_states(self, cluster, tenant):
        svc = cluster.service
        flat = svc._registry.seat_state_dict(svc.session(tenant))
        return {k: self.host(v).copy() for k, v in flat.items()}

    def make(self, world, spill_dir, **kw):
        kw.setdefault("heartbeat_s", 0.02)
        kw.setdefault("death_timeout_s", 10.0)
        kw.setdefault("group_width", GROUP_WIDTH)
        spill_dir.mkdir(parents=True, exist_ok=True)
        w = self.World(world)
        return w, [self.Cluster(w.group(r), spill_dir=str(spill_dir), **kw)
                   for r in range(world)]


_warmed = set()


def _warm(side):
    """Compile JAX's dispatch and compute programs once, so chaos timers
    (heartbeats against death timeouts) never race a cold compile."""
    if side.pkg in _warmed:
        return
    svc = side.Service(group_width=GROUP_WIDTH)
    svc.open("warm", side.suite())
    for b in side.batches(2, seed=999):
        svc.submit("warm", *b)
    svc.pump()
    svc.results("warm")
    _warmed.add(side.pkg)


def _step_all(clusters, rounds=1):
    for _ in range(rounds):
        for c in clusters:
            if not c.is_dead:
                c.step()


def _until(predicate, clusters, timeout=60.0, msg=""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        _step_all(clusters)
        if predicate():
            return
        time.sleep(0.001)
    raise AssertionError(f"condition not reached in {timeout}s: {msg}")


def _drive_call(call, clusters, timeout=60.0):
    """Run a blocking cluster call (migrate / results drive their own
    host's step loop) while round-robin stepping every other host."""
    box = {}
    thread = threading.Thread(target=lambda: box.setdefault("out", call()), daemon=True)
    thread.start()
    deadline = time.monotonic() + timeout
    while thread.is_alive() and time.monotonic() < deadline:
        _step_all(clusters)
        time.sleep(0.001)
    thread.join(timeout=1.0)
    assert "out" in box, "blocking cluster call hung"
    return box["out"]


def _tenants_per_rank(cluster, per_rank):
    owned = {r: [] for r in cluster.placement.alive}
    i = 0
    while any(len(v) < per_rank for v in owned.values()):
        name = f"t{i}"
        i += 1
        owner = cluster.placement.owner_of(name)
        if len(owned[owner]) < per_rank:
            owned[owner].append(name)
    return owned


def _open_everywhere(side, clusters, tenants):
    for t in tenants:
        for c in clusters:
            out = side.note(c.open(t, side.suite))
            assert out.action in ("local", "routed"), out
            assert out.owner == clusters[0].placement.owner_of(t)


def _wait_applied(clusters, tenant, nbatches, timeout=60.0):
    def ok():
        for c in clusters:
            if c.is_dead:
                continue
            if c.placement.owner_of(tenant) == c.rank:
                s = c.service.session(tenant)
                return s is not None and s.batches >= nbatches
        return False

    _until(ok, clusters, timeout, f"{tenant} applied through {nbatches}")


def _wait_dead(clusters, victim):
    survivors = [c for c in clusters if c.rank != victim and not c.is_dead]
    _until(lambda: all(victim in c.stats()["dead"] for c in survivors), clusters,
           msg=f"rank {victim} excised everywhere")


def _wait_converged(clusters):
    def ok():
        stats = [c.stats() for c in clusters if not c.is_dead]
        return len({s["fingerprint"] for s in stats}) == 1 and len({s["epoch"] for s in stats}) == 1

    _until(ok, clusters, msg="epoch/fingerprint convergence")
    return [c.stats() for c in clusters if not c.is_dead]


def _owner_cluster(clusters, tenant):
    for c in clusters:
        if not c.is_dead and c.placement.owner_of(tenant) == c.rank:
            return c
    raise AssertionError(f"no live owner for {tenant}")


def _final(side, clusters, tenant, batches, rec):
    """The tenant's owner-local results, bit-equal to the package's solo
    suite; its figures and seat states go into the record."""
    owner = _owner_cluster(clusters, tenant)
    result = side.note(owner.results(tenant))
    assert result.action == "local", result
    rec["values"][tenant] = side.assert_solo(result.value, batches)
    rec["states"][tenant] = side.seat_states(owner, tenant)


def _record():
    return {"values": {}, "states": {}}


# ----------------------------------------------------------------- scripts
def _script_routed(side, tmp, world):
    rec = _record()
    _, clusters = side.make(world, tmp)
    owned = _tenants_per_rank(clusters[0], 1)
    tenants = [ts[0] for ts in owned.values()]
    _open_everywhere(side, clusters, tenants)
    streams = {t: side.batches(3, seed=10 + i) for i, t in enumerate(tenants)}
    for t in tenants:
        for b in streams[t]:
            out = side.note(clusters[0].submit(t, *b))
            assert out.action in ("local", "routed"), out
    for t in tenants:
        _wait_applied(clusters, t, 3)
    for t in tenants:
        _final(side, clusters, t, streams[t], rec)
    remote = next(t for t in tenants if clusters[0].placement.owner_of(t) != 0)
    result = side.note(_drive_call(lambda: clusters[0].results(remote, timeout_s=30.0),
                                   clusters))
    assert result.action == "local", result
    side.assert_solo(result.value, streams[remote])
    if side.pkg == "port":
        # A remote reply crossed the wire pickled: CPU tensors.
        assert all(v.device.type == "cpu" for v in result.value.values())
    stats = _wait_converged(clusters)
    assert all(not s["dead"] and not s["lost"] for s in stats)
    counts = clusters[0].stats()["counts"]
    assert counts["routed"] == (len(tenants) - 1) * 3 and counts["local"] == 3
    rec["counts"] = counts
    rec["fingerprint"] = stats[0]["fingerprint"]
    return rec


def _script_route_window(side, tmp):
    rec = _record()
    _, clusters = side.make(2, tmp, route_window=2)
    tenant = _tenants_per_rank(clusters[0], 1)[1][0]
    _open_everywhere(side, clusters, [tenant])
    batches = side.batches(3, seed=21)
    assert side.note(clusters[0].submit(tenant, *batches[0])).action == "routed"
    assert side.note(clusters[0].submit(tenant, *batches[1])).action == "routed"
    shed = side.note(clusters[0].submit(tenant, *batches[2]))
    assert shed.action == "shed" and shed.detail == "route-window"
    _until(lambda: clusters[0]._streams[tenant].applied >= 1, clusters,
           msg="applied cursor acked back")
    assert side.note(clusters[0].submit(tenant, *batches[2])).action == "routed"
    _wait_applied(clusters, tenant, 3)
    _final(side, clusters, tenant, batches, rec)
    rec["counts"] = clusters[0].stats()["counts"]
    return rec


def _script_remote_shed(side, tmp):
    rec = _record()
    _, clusters = side.make(2, tmp)
    tenant = _tenants_per_rank(clusters[0], 1)[1][0]
    _open_everywhere(side, clusters, [tenant])
    batches = side.batches(2, seed=22)
    plan = side.Plan([{"site": "serve.admit", "action": "raise",
                       "match": {"tenant": tenant}, "count": None}])
    with plan:
        assert side.note(clusters[0].submit(tenant, *batches[0])).action == "routed"
        _until(lambda: clusters[0]._streams[tenant].remote_shedding, clusters,
               msg="owner shed signal reached the sender")
        shed = side.note(clusters[0].submit(tenant, *batches[1]))
        assert shed.action == "shed" and shed.detail == "remote-shed"
    _wait_applied(clusters, tenant, 1)
    _until(lambda: not clusters[0]._streams[tenant].remote_shedding, clusters,
           msg="owner shed signal cleared at the sender")
    assert side.note(clusters[0].submit(tenant, *batches[1])).action == "routed"
    _wait_applied(clusters, tenant, 2)
    _final(side, clusters, tenant, batches, rec)
    rec["counts"] = clusters[0].stats()["counts"]
    return rec


def _script_migration(side, tmp):
    rec = _record()
    _, clusters = side.make(4, tmp)
    owned = _tenants_per_rank(clusters[0], 1)
    _open_everywhere(side, clusters, [ts[0] for ts in owned.values()])
    source = next(r for r in owned if r != 0)
    tenant = owned[source][0]
    target = next(r for r in range(4) if r not in (0, source))
    batches = side.batches(3, seed=30)
    for b in batches[:2]:
        assert side.note(clusters[0].submit(tenant, *b)).action == "routed"
    _wait_applied(clusters, tenant, 2)
    epoch_before = clusters[0].stats()["epoch"]
    out = side.note(_drive_call(lambda: clusters[source].migrate(tenant, target, timeout_s=30.0),
                                clusters))
    assert out.action == "migrated" and out.owner == target, out
    stats = _wait_converged(clusters)
    assert all(s["epoch"] == epoch_before + 1 for s in stats)
    assert all(c.placement.owner_of(tenant) == target for c in clusters)
    assert clusters[source].service.session(tenant) is None
    assert clusters[source].stats()["migration_count"] == 1
    assert side.note(clusters[0].submit(tenant, *batches[2])).action == "routed"
    _wait_applied(clusters, tenant, 3)
    _final(side, clusters, tenant, batches, rec)
    rec["fingerprint"] = stats[0]["fingerprint"]
    return rec


def _script_rebalance(side, tmp):
    rec = _record()
    side.metering.enable()
    try:
        _, clusters = side.make(2, tmp)
        owned = _tenants_per_rank(clusters[0], 3)
        _open_everywhere(side, clusters, owned[0] + owned[1][:1])
        for i, t in enumerate(owned[0]):
            for b in side.batches(2, seed=40 + i):
                assert side.note(clusters[0].submit(t, *b)).action == "local"
        _until(lambda: all(clusters[0].service.session(t).batches >= 2 for t in owned[0]),
               clusters, msg="local tenants pumped")
        outs = _drive_call(lambda: clusters[0].rebalance_once(min_gap=2), clusters)
        assert len(outs) == 1 and side.note(outs[0]).action == "migrated", outs
        moved = outs[0].tenant
        assert moved in owned[0] and outs[0].owner == 1
        stats = _wait_converged(clusters)
        assert all(c.placement.owner_of(moved) == 1 for c in clusters)
        assert all(moved not in s["lost"] for s in stats)
        assert clusters[0].rebalance_once(min_gap=2) == []
        _final(side, clusters, moved, side.batches(2, seed=40 + owned[0].index(moved)), rec)
        # Which tenant is hottest rests on measured device-seconds: the
        # packages may pick different ones, so the record keeps the census.
        rec["census"] = sorted(len(s["owned"]) for s in stats)
        rec["values"], rec["states"] = {}, {}
    finally:
        side.metering.reset()
    return rec


def _seed_cluster(side, world, tmp, per_rank=1, death_timeout_s=1.5):
    _warm(side)
    _, clusters = side.make(world, tmp, death_timeout_s=death_timeout_s)
    owned = _tenants_per_rank(clusters[0], per_rank)
    tenants = [t for ts in owned.values() for t in ts]
    _open_everywhere(side, clusters, tenants)
    streams = {t: side.batches(3, seed=50 + i) for i, t in enumerate(tenants)}
    for t in tenants:
        for b in streams[t][:2]:
            out = side.note(clusters[0].submit(t, *b))
            assert out.action in ("local", "routed"), out
    for t in tenants:
        _wait_applied(clusters, t, 2)
    return clusters, owned, streams


def _survivors_intact(side, clusters, owned, streams, victim, expect_lost, rec,
                      submit_final=()):
    survivors = [c for c in clusters if not c.is_dead]
    assert all(c.rank != victim for c in survivors)
    stats = _wait_converged(clusters)
    assert all(victim in s["dead"] for s in stats)
    for rank, tenants in owned.items():
        if rank == victim:
            continue
        for t in tenants:
            assert all(c.placement.owner_of(t) == rank for c in survivors), t
    for t in submit_final:
        out = side.note(clusters[0].submit(t, *streams[t][2]))
        assert out.action in ("local", "routed"), (t, out)
    for tenants in owned.values():
        for t in tenants:
            if t in expect_lost:
                continue
            _wait_applied(clusters, t, 3)
            _final(side, clusters, t, streams[t], rec)
    for t in expect_lost:
        oc = _owner_cluster(clusters, t)
        _until(lambda t=t, oc=oc: t in oc.stats()["lost"], clusters,
               msg=f"{t} reported lost on its repair owner")
        assert side.note(oc.results(t)).action == "lost"
    rec["lost"] = sorted(set().union(*(set(c.stats()["lost"]) for c in clusters
                                       if not c.is_dead)))
    assert rec["lost"] == sorted(expect_lost)
    rec["dead"] = sorted(clusters[0].stats()["dead"]) if not clusters[0].is_dead else None
    rec["fingerprint"] = _wait_converged(clusters)[0]["fingerprint"]


def _script_death_mid_dispatch(side, tmp, world):
    rec = _record()
    clusters, owned, streams = _seed_cluster(side, world, tmp, per_rank=2)
    victim = next(r for r in owned if r != 0)
    t_spill, t_fresh = owned[victim]
    clusters[victim].service.pump()
    clusters[victim].service.spill(t_spill)
    plan = side.Plan([{"site": "serve.route", "action": "drop_rank",
                       "match": {"rank": victim, "role": "apply"}}])
    with plan:
        for tenants in owned.values():
            for t in tenants:
                out = side.note(clusters[0].submit(t, *streams[t][2]))
                assert out.action in ("local", "routed"), out
        _until(lambda: clusters[victim].is_dead, clusters, msg="victim killed mid-dispatch")
        assert plan.fired and plan.fired[0].context["role"] == "apply"
    _wait_dead(clusters, victim)
    _survivors_intact(side, clusters, owned, streams, victim, [t_fresh], rec)
    _until(lambda: t_fresh in clusters[0].stats()["lost"], clusters,
           msg="loss propagated to the sender")
    assert side.note(clusters[0].submit(t_fresh, *streams[t_fresh][0])).action == "lost"
    assert side.note(clusters[0].results(t_fresh)).action == "lost"
    return rec


def _script_source_death(side, tmp, world, phase):
    rec = _record()
    clusters, owned, streams = _seed_cluster(side, world, tmp, per_rank=2)
    source = next(r for r in owned if r != 0)
    tenant, t_fresh = owned[source]
    target = next(r for r in range(world) if r not in (0, source)) if world > 2 else 0
    if phase == "spill":
        clusters[source].service.pump()
        clusters[source].service.spill(tenant)
    plan = side.Plan([{"site": "serve.migrate", "action": "drop_rank",
                       "match": {"phase": phase, "rank": source}}])
    with plan:
        out = side.note(clusters[source].migrate(tenant, target, timeout_s=30.0))
    assert out.action == "dead", out
    assert clusters[source].is_dead
    _wait_dead(clusters, source)
    finals = [t for r, ts in owned.items() if r != source for t in ts] + [tenant]
    _survivors_intact(side, clusters, owned, streams, source, [t_fresh], rec,
                      submit_final=finals)
    assert _owner_cluster(clusters, tenant).stats()["counts"]["recovered"] >= 1
    return rec


def _script_target_death(side, tmp, world):
    rec = _record()
    clusters, owned, streams = _seed_cluster(side, world, tmp)
    source, tenant = 0, owned[0][0]
    target = next(r for r in owned if r != source)
    plan = side.Plan([{"site": "serve.migrate", "action": "drop_rank",
                       "match": {"phase": "resume", "rank": target}}])
    with plan:
        out = side.note(_drive_call(
            lambda: clusters[source].migrate(tenant, target, timeout_s=30.0), clusters))
    assert out.action == "aborted", out
    assert clusters[target].is_dead
    _wait_dead(clusters, target)
    finals = [t for r, ts in owned.items() if r != target for t in ts]
    _survivors_intact(side, clusters, owned, streams, target, owned[target], rec,
                      submit_final=finals)
    assert clusters[source].placement.owner_of(tenant) == source
    assert clusters[source].service.session(tenant) is not None
    assert clusters[source].stats()["counts"]["migrations_aborted"] >= 1
    return rec


def _script_killed_host(side, tmp):
    rec = _record()
    clusters, owned, streams = _seed_cluster(side, 2, tmp)
    clusters[1].kill()
    _wait_dead(clusters, 1)
    tenant = owned[1][0]
    assert side.note(clusters[1].submit(tenant, *streams[tenant][2])).action == "dead"
    assert side.note(clusters[1].results(tenant)).action == "dead"
    assert side.note(clusters[1].migrate(tenant, 0)).action == "dead"
    assert side.note(clusters[1].open("t-new", side.suite)).action == "dead"
    rec["dead"] = clusters[0].stats()["dead"]
    return rec


def _both(script, tmp_path, *args):
    """Run ``script`` through JAX and the port; hold the port's record
    against JAX's and return it."""
    jax_side = Side("jax")
    want = script(jax_side, tmp_path / "jax", *args)
    want["actions"] = jax_side.actions
    port_side = Side("port")
    before = _build.PLAIN_CALLS.get("mega_counts", 0)
    got = script(port_side, tmp_path / "port", *args)
    got["actions"] = port_side.actions
    # Every owner dispatch went through the collection kernel's plain
    # version (the CPU's stand-in for mega.cu).
    if got["values"]:
        assert _build.PLAIN_CALLS.get("mega_counts", 0) > before
    assert got["actions"] == want["actions"]
    assert set(got["values"]) == set(want["values"])
    for tenant, values in want["values"].items():
        for name, v in values.items():
            np.testing.assert_allclose(got["values"][tenant][name], v, rtol=RTOL, atol=0)
        mine, theirs = got["states"][tenant], want["states"][tenant]
        assert set(mine) == set(theirs)
        for k in theirs:
            assert mine[k].dtype == theirs[k].dtype and np.array_equal(mine[k], theirs[k]), k
    for key in ("lost", "dead", "counts", "fingerprint", "census"):
        assert got.get(key) == want.get(key), key
    return got


# ------------------------------------------------------- cluster vs JAX's
@pytest.mark.parametrize("world", [2, 4, 8])
def test_routed_submits_bit_identical_and_equal_jax(world, tmp_path):
    _both(_script_routed, tmp_path, world)


def test_route_window_sheds_typed(tmp_path):
    rec = _both(_script_route_window, tmp_path)
    assert rec["counts"]["shed_window"] == 1


def test_remote_shed_signal_reaches_the_sender(tmp_path):
    rec = _both(_script_remote_shed, tmp_path)
    assert rec["counts"]["shed_remote"] == 1


def test_live_migration_hands_off_bit_exact(tmp_path):
    _both(_script_migration, tmp_path)


def test_rebalancer_moves_hot_tenant_to_cold_host(tmp_path):
    rec = _both(_script_rebalance, tmp_path)
    assert rec["census"] == [2, 2]


@pytest.mark.parametrize("world", [2, 4])
def test_host_death_mid_dispatch(world, tmp_path):
    rec = _both(_script_death_mid_dispatch, tmp_path, world)
    assert len(rec["lost"]) == 1


@pytest.mark.parametrize("world,phase", [(2, "spill"), (4, "stream")])
def test_source_death_mid_migration(world, phase, tmp_path):
    _both(_script_source_death, tmp_path, world, phase)


@pytest.mark.parametrize("world", [2, 4])
def test_target_death_mid_resume(world, tmp_path):
    _both(_script_target_death, tmp_path, world)


def test_killed_host_goes_typed_dead(tmp_path):
    rec = _both(_script_killed_host, tmp_path)
    assert rec["dead"] == [1]


# ----------------------------------------------------------- tag namespace
def test_serve_wire_traffic_confined_to_namespace(tmp_path):
    side = Side("port")
    w, clusters = side.make(2, tmp_path)
    tenant = _tenants_per_rank(clusters[0], 1)[1][0]
    _open_everywhere(side, clusters, [tenant])
    clusters[0].submit(tenant, *side.batches(1, seed=5)[0])
    assert [k for k in w._mail if k[2].startswith("serve/")]
    assert all(k[2].startswith(port_dist.SERVE_TAG_NAMESPACE) for k in w._mail), list(w._mail)


def test_concurrent_fleet_merge_and_routing_no_cross_delivery(tmp_path):
    side = Side("port")
    w, clusters = side.make(2, tmp_path)
    tenant = _tenants_per_rank(clusters[0], 1)[1][0]
    _open_everywhere(side, clusters, [tenant])
    batches = side.batches(3, seed=7)

    def merge_data(rank):
        rng = np.random.default_rng(100 + rank)
        scores = rng.random(200)
        return scores, (rng.random(200) < scores).astype(np.float64)

    def merge_metric(rank):
        return BinaryAUROC(device="cpu").update(*map(torch.from_numpy, merge_data(rank)))

    reference = [merge_metric(r) for r in range(2)]
    for m in reference:
        m._prepare_for_merge_state()
    reference[0].merge_state(reference[1:])
    jax_reference = [JaxBinaryAUROC().update(*map(jnp.asarray, merge_data(r))) for r in range(2)]
    for m in jax_reference:
        m._prepare_for_merge_state()
    jax_reference[0].merge_state(jax_reference[1:])

    outs = [None, None]

    def worker(rank):
        outs[rank] = fleet_merge(merge_metric(rank), w.group(rank), topology="tree",
                                 policy=MergePolicy(level_deadline=10.0, poll_slice=0.01))

    threads = [threading.Thread(target=worker, args=(r,), daemon=True) for r in range(2)]
    for t in threads:
        t.start()
    for b in batches:
        assert clusters[0].submit(tenant, *b).action == "routed"
        _step_all(clusters, rounds=2)
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads), "merge hung"
    assert float(outs[0].value) == float(reference[0].compute())
    np.testing.assert_allclose(float(outs[0].value), float(jax_reference[0].compute()),
                               rtol=RTOL)
    assert not outs[0].partial
    _wait_applied(clusters, tenant, len(batches))
    result = clusters[1].results(tenant)
    assert result.action == "local"
    side.assert_solo(result.value, batches)


# ---------------------------------------------------------- review fences
def _script_local_submit_during_migration(side, tmp):
    rec = _record()
    _, clusters = side.make(2, tmp)
    tenant = _tenants_per_rank(clusters[0], 1)[0][0]
    _open_everywhere(side, clusters, [tenant])
    batches = side.batches(3, seed=60)
    for b in batches[:2]:
        assert side.note(clusters[0].submit(tenant, *b)).action == "local"
    _wait_applied(clusters, tenant, 2)
    assert side.note(clusters[0].migrate(tenant, 1, wait=False)).action == "routed"
    assert tenant in clusters[0]._migrating
    shed = side.note(clusters[0].submit(tenant, *batches[2]))
    assert shed.action == "shed" and shed.detail == "migrating"
    _until(lambda: tenant not in clusters[0]._migrating
           and all(c.placement.owner_of(tenant) == 1 for c in clusters),
           clusters, msg="handoff committed")
    retried = side.note(clusters[0].submit(tenant, *batches[2]))
    assert retried.action == "routed" and retried.owner == 1
    _wait_applied(clusters, tenant, 3)
    _final(side, clusters, tenant, batches, rec)
    rec["counts"] = clusters[0].stats()["counts"]
    return rec


def _script_retention(side, tmp):
    rec = _record()
    _, clusters = side.make(2, tmp, route_window=4)
    tenant = _tenants_per_rank(clusters[0], 1)[1][0]
    _open_everywhere(side, clusters, [tenant])
    batches = side.batches(6, seed=61)
    for i, b in enumerate(batches):
        assert side.note(clusters[0].submit(tenant, *b)).action == "routed"
        _wait_applied(clusters, tenant, i + 1)
    stream = clusters[0]._streams[tenant]
    _until(lambda: stream.durable >= 3, clusters,
           msg="owner checkpoint advanced the durable cursor")
    assert len(stream.frames) <= 2, sorted(stream.frames)
    assert clusters[1].service.stats()["counts"]["spills"] >= 1
    got = side.note(_drive_call(lambda: clusters[0].results(tenant), clusters))
    side.assert_solo(got.value, batches)
    _final(side, clusters, tenant, batches, rec)
    return rec


def _script_stale_migack(side, tmp):
    rec = _record()
    _, clusters = side.make(3, tmp)
    source, target, other = 0, 1, 2
    tenant = _tenants_per_rank(clusters[0], 1)[source][0]
    _open_everywhere(side, clusters, [tenant])
    batches = side.batches(2, seed=62)
    for b in batches:
        assert side.note(clusters[source].submit(tenant, *b)).action == "local"
    _wait_applied(clusters, tenant, 2)
    assert side.note(clusters[source].migrate(tenant, target, wait=False)).action == "routed"
    version = clusters[source]._migrating[tenant]["version"]
    clusters[source]._handle_migrate_ack(
        {"type": "migack", "t": tenant, "v": version, "ok": False}, src=other)
    clusters[source]._handle_migrate_ack(
        {"type": "migack", "t": tenant, "v": version - 1, "ok": False}, src=target)
    assert tenant in clusters[source]._migrating
    assert clusters[source].stats()["counts"]["migrations_aborted"] == 0
    # The commit lands on the source first; the third host learns it by
    # gossip, so wait for every host to agree rather than race that.
    _until(lambda: tenant not in clusters[source]._migrating
           and all(c.placement.owner_of(tenant) == target for c in clusters),
           clusters, msg="genuine migack committed everywhere")
    assert clusters[source].stats()["counts"]["migrations"] == 1
    _wait_applied(clusters, tenant, 2)
    _final(side, clusters, tenant, batches, rec)
    return rec


def _script_results_reclaimed(side, tmp):
    rec = _record()
    _, clusters = side.make(2, tmp)
    tenant = _tenants_per_rank(clusters[0], 1)[1][0]
    _open_everywhere(side, clusters, [tenant])
    b = side.batches(1, seed=63)[0]
    assert side.note(clusters[0].submit(tenant, *b)).action == "routed"
    _wait_applied(clusters, tenant, 1)
    out = side.note(clusters[0].results(tenant, timeout_s=0.05))
    assert out.action == "timeout", out
    assert clusters[0]._results_waiting == set() and clusters[0]._results_replies == {}
    _step_all(clusters, rounds=3)
    assert clusters[0]._results_replies == {}
    got = side.note(_drive_call(lambda: clusters[0].results(tenant), clusters))
    assert got.action == "local", got
    side.assert_solo(got.value, [b])
    _final(side, clusters, tenant, [b], rec)
    return rec


def _script_all_dead(side, tmp):
    rec = _record()
    p = side.Placement(2)
    assert p.exclude(0) and p.exclude(1)
    assert p.owner_of("t") == -1 and p.ring_owner_of("t") == -1 and p.alive == ()
    _, clusters = side.make(2, tmp)
    tenant = _tenants_per_rank(clusters[0], 1)[1][0]
    _open_everywhere(side, clusters, [tenant])
    clusters[0].placement.merge([0, 1])
    b = side.batches(1, seed=64)[0]
    assert side.note(clusters[0].submit(tenant, *b)).action == "dead"
    assert side.note(clusters[0].results(tenant)).action == "dead"
    assert side.note(clusters[0].open("t-new", side.suite)).action == "dead"
    assert side.note(clusters[0].close(tenant)).action == "dead"
    return rec


@pytest.mark.parametrize("script", [
    _script_local_submit_during_migration,
    _script_retention,
    _script_stale_migack,
    _script_results_reclaimed,
    _script_all_dead,
], ids=lambda s: s.__name__[len("_script_"):])
def test_review_regressions_match_jax(script, tmp_path):
    _both(script, tmp_path)
