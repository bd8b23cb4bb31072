"""The port's flat sync toolkit over a ``LocalWorld(4)`` against the JAX
toolkit on the same shards: ``sync_and_compute`` (recipient 0 and
``"all"``), ``get_synced_metric``, ``get_synced_state_dict``,
``clone_metric(s)``, ``reset_metrics`` and ``to_device``, for a counter
metric, a buffer metric (``MulticlassAUROC``) and a collection.  Counts
and buffers are bit-equal; computed values agree within 1e-6 relative.
A tree and a ring merge give the flat bits, and one
``MetricClassTester`` run covers a ported class end to end."""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
from torcheval_tpu.distributed import LocalWorld as JaxLocalWorld
from torcheval_tpu.metrics import toolkit as jax_toolkit
from torcheval_tpu_torch import distributed
from torcheval_tpu_torch import metrics as P
from torcheval_tpu_torch.metrics import toolkit
from torcheval_tpu_torch.utils.test_utils import (
    DummySumDequeStateMetric,
    DummySumDictStateMetric,
    DummySumListStateMetric,
    DummySumMetric,
    MetricClassTester,
)

C = 5
WORLD = 4
RTOL = 1e-6


def counter(lib, **dev):
    return lib.MulticlassConfusionMatrix(num_classes=C, **dev)


def buffer(lib, **dev):
    return lib.MulticlassAUROC(num_classes=C, **dev)


def collection(lib, **dev):
    return lib.MetricCollection({
        "acc": lib.MulticlassAccuracy(num_classes=C, average="macro", **dev),
        "f1": lib.MulticlassF1Score(num_classes=C, average="macro", **dev),
        "cm": lib.MulticlassConfusionMatrix(num_classes=C, **dev),
    })


def shards(seed):
    r = np.random.default_rng(seed)
    out = []
    for _ in range(WORLD):
        n = int(r.integers(20, 90))
        out.append((r.random((n, C)).astype(np.float32), r.integers(0, C, n).astype(np.int32)))
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return np.asarray(x)


def assert_close(got, want, exact=False):
    got, want = _np(got), _np(want)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            assert_close(got[k], want[k], exact)
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_close(g, w, exact)
    elif exact:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=0, equal_nan=True)


def run_both(make, data, fn_port, fn_jax):
    def port_rank(group, rank):
        m = make(P, device="cpu")
        m.update(torch.from_numpy(data[rank][0]), torch.from_numpy(data[rank][1]))
        return fn_port(m, group)

    def jax_rank(group, rank):
        m = make(J)
        m.update(jnp.asarray(data[rank][0]), jnp.asarray(data[rank][1]))
        return fn_jax(m, group)

    return distributed.LocalWorld(WORLD).run(port_rank), JaxLocalWorld(WORLD).run(jax_rank)


@pytest.mark.parametrize("make", [counter, buffer, collection])
@pytest.mark.parametrize("recipient", [0, "all", 2])
def test_sync_and_compute_matches_jax(make, recipient):
    got, want = run_both(
        make, shards(1),
        lambda m, g: toolkit.sync_and_compute(m, g, recipient),
        lambda m, g: jax_toolkit.sync_and_compute(m, g, recipient),
    )
    for r in range(WORLD):
        if recipient == "all" or r == recipient:
            assert_close(got[r], want[r])
        else:
            assert got[r] is None and want[r] is None


@pytest.mark.parametrize("make", [counter, buffer, collection])
def test_synced_metric_and_state_dict_match_jax(make):
    def port(m, g):
        synced = toolkit.get_synced_metric(m, g, "all")
        return synced.state_dict(), toolkit.get_synced_state_dict(m, g, 1)

    def jax(m, g):
        synced = jax_toolkit.get_synced_metric(m, g, "all")
        return synced.state_dict(), jax_toolkit.get_synced_state_dict(m, g, 1)

    got, want = run_both(make, shards(2), port, jax)
    for r in range(WORLD):
        assert_close(got[r][0], want[r][0], exact=True)
        if r == 1:
            assert_close(got[r][1], want[r][1], exact=True)
        else:
            assert got[r][1] == {} and want[r][1] == {}


def test_sync_leaves_the_callers_metric_alone_and_ships_cpu_states():
    data = shards(3)

    def rank_fn(group, rank):
        m = counter(P, device="cpu").update(torch.from_numpy(data[rank][0]),
                                            torch.from_numpy(data[rank][1]))
        before = m.confusion_matrix.clone()
        synced = toolkit.get_synced_metric(m, group, "all")
        assert torch.equal(m.confusion_matrix, before)
        return int(synced.confusion_matrix.sum()), int(before.sum())

    out = distributed.LocalWorld(WORLD).run(rank_fn)
    total = sum(len(y) for _, y in data)
    assert all(s == total for s, _ in out) and sum(b for _, b in out) == total


def test_flat_only():
    m = counter(P, device="cpu")
    group = distributed.SingleProcessGroup()
    # The fleet merge is ported: over a LocalWorld a tree or a ring of the
    # collection gives the flat sync's bits at the recipient, as JAX's does.
    data = shards(31)

    def merge_rank(g, rank):
        col = collection(P, device="cpu").update(*(torch.from_numpy(a) for a in data[rank]))
        return [toolkit.sync_and_compute(col, g, recipient_rank=1, topology=t)
                for t in ("flat", "tree", "ring")]

    out = distributed.LocalWorld(WORLD).run(merge_rank)
    flat, tree, ring = out[1]
    for outcome in (tree, ring):
        assert not outcome.partial and outcome.world_effective == WORLD
        for name in flat:
            assert torch.equal(outcome.value[name], flat[name])
    assert all(o.value is None for r in (0, 2, 3) for o in out[r][1:])

    def jax_rank(g, rank):
        col = collection(J).update(*(jnp.asarray(a) for a in data[rank]))
        return jax_toolkit.sync_and_compute(col, g, recipient_rank=1, topology="tree")

    jax_tree = JaxLocalWorld(WORLD).run(jax_rank)[1]
    for name in flat:
        np.testing.assert_allclose(tree.value[name].numpy(), np.asarray(jax_tree.value[name]),
                                   rtol=RTOL)
    assert toolkit.sync_and_compute(m, group, topology="ring").world_effective == 1
    # The flat sketch sync is ported: each rank's histogram sketch of a
    # BinaryAUROC rides the flat gather and rank 0 returns the merged value.
    def sketch_rank(g, rank):
        rng = np.random.default_rng(40 + rank)
        s = rng.random(300).astype(np.float32)
        auroc = P.BinaryAUROC(device="cpu").update(s, (rng.random(300) < s).astype(np.int32))
        return toolkit.sync_and_compute(auroc, g, sketch="histogram",
                                        sketch_options={"bins": 4096}), auroc
    out = distributed.LocalWorld(WORLD).run(sketch_rank)
    whole = out[0][1].merge_state([a for _, a in out[1:]])
    assert all(v is None for v, _ in out[1:])
    assert abs(float(out[0][0]) - float(whole.compute())) < 0.02
    with pytest.raises(ValueError, match="only kind='exact'"):
        toolkit.sync_and_compute(m, group, sketch="histogram")
    with pytest.raises(ValueError, match="topology"):
        toolkit.sync_and_compute(m, group, topology="star")
    with pytest.raises(ValueError, match="recipient_rank"):
        toolkit.get_synced_metric(m, group, "some")


def test_world_of_one_and_null_group():
    m = counter(P, device="cpu")
    assert toolkit.get_synced_metric(m) is m  # the default group is the world of one
    assert toolkit.sync_and_compute(m, distributed.NullGroup()) is None
    assert toolkit.get_synced_state_dict(m, distributed.NullGroup()) == {}
    with pytest.raises(RuntimeError, match="not part of this group"):
        distributed.NullGroup().all_gather_object(1)
    with pytest.raises(ValueError, match="must be a rank"):
        distributed.LocalWorld(2).run(lambda g, r: toolkit.get_synced_metric(m, g, 5))


def test_clone_reset_and_to_device():
    data = shards(4)
    metrics = [counter(P, device="cpu"), buffer(P, device="cpu")]
    for m in metrics:
        m.update(torch.from_numpy(data[0][0]), torch.from_numpy(data[0][1]))
    clones = toolkit.clone_metrics(metrics)
    assert all(c is not m for c, m in zip(clones, metrics))
    assert_close(clones[0].state_dict(), metrics[0].state_dict(), exact=True)
    assert clones[0].confusion_matrix.data_ptr() != metrics[0].confusion_matrix.data_ptr()
    assert toolkit.reset_metrics(clones) is clones
    assert int(clones[0].confusion_matrix.sum()) == 0 and clones[1].inputs == []
    assert int(metrics[0].confusion_matrix.sum()) == len(data[0][1])
    assert toolkit.to_device(metrics, "cpu") is metrics
    assert all(m.device == torch.device("cpu") for m in metrics)
    col = collection(P, device="cpu")
    assert toolkit.clone_metric(col) is not col


def test_local_world_protocol():
    world = distributed.LocalWorld(3)

    def rank_fn(group, rank):
        t = torch.full((2,), rank)
        gathered = group.all_gather_object(t)
        bcast = group.broadcast_object(f"from {rank}", src=1)
        only = group.gather_object(rank * 10, dst=2)
        group.send_object({"r": rank}, (rank + 1) % 3, "ring")
        got = group.recv_object((rank - 1) % 3, "ring", timeout=5)
        return [int(x[0]) for x in gathered], bcast, only, got

    out = world.run(rank_fn)
    for rank, (gathered, bcast, only, got) in enumerate(out):
        assert gathered == [0, 1, 2] and bcast == "from 1"
        assert only == ([0, 10, 20] if rank == 2 else None)
        assert got == {"r": (rank - 1) % 3}
    with pytest.raises(distributed.PeerTimeoutError) as err:
        distributed.LocalWorld(1).group(0).recv_object(0, "never", timeout=0.01)
    assert err.value.peer == 0
    with pytest.raises(ZeroDivisionError):
        distributed.LocalWorld(2).run(lambda g, r: 1 / 0 if r else g.all_gather_object(r))
    with pytest.raises(ValueError):
        distributed.LocalWorld(0)
    assert pickle.loads(distributed._dumps(torch.ones(2))).device == torch.device("cpu")


class TestDummyMetrics(MetricClassTester):
    def test_sum(self):
        xs = [float(i) for i in range(8)]
        self.run_class_implementation_tests(
            DummySumMetric(device="cpu"), {"sum"}, {"x": xs}, torch.tensor(28.0))

    def test_list_deque_dict(self):
        xs = [torch.tensor([float(i), 1.0]) for i in range(8)]
        self.run_class_implementation_tests(
            DummySumListStateMetric(device="cpu"), {"x"}, {"x": xs}, torch.tensor(36.0))
        self.run_class_implementation_tests(
            DummySumDequeStateMetric(device="cpu"), {"x"}, {"x": xs}, torch.tensor(36.0))
        m = DummySumDictStateMetric(device="cpu")
        m.update("a", 1.0).update("b", 2.0).update("a", 3.0)
        assert float(m.compute()["a"]) == 4.0 and float(m.compute()["b"]) == 2.0


class TestMulticlassF1ScoreClass(MetricClassTester):
    def test_f1_macro(self):
        r = np.random.default_rng(5)
        x = r.random((8, 16, C)).astype(np.float32)
        y = r.integers(0, C, (8, 16)).astype(np.int32)
        want = J.MulticlassF1Score(num_classes=C, average="macro")
        for i in range(8):
            want.update(jnp.asarray(x[i]), jnp.asarray(y[i]))
        self.run_class_implementation_tests(
            P.MulticlassF1Score(num_classes=C, average="macro", device="cpu"),
            {"num_tp", "num_label", "num_prediction"},
            {"input": [torch.from_numpy(v) for v in x], "target": [torch.from_numpy(v) for v in y]},
            torch.tensor(np.asarray(want.compute())),
            rtol=RTOL,
        )
