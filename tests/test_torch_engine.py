"""The port's streaming engine (``torcheval_tpu_torch.engine``) against the
JAX package's ``Evaluator``: the same numpy streams, made from a seed, go
through both, and every state must be bit-equal, and bit-equal to the
port's per-batch ``fused_update`` loop.  On the CPU the port's blocks run
its eager step loop (the graph path needs the card: tests/test_torch_cuda.py).

Mirrors ``tests/engine/test_evaluator.py`` case for case, the engine cases
of ``tests/engine/test_health.py`` and
``tests/resilience/test_checkpoint.py::TestEvaluatorResume``, with repeats
merged into parametrised cases."""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as jm
from torcheval_tpu.engine import Evaluator as JaxEvaluator
from torcheval_tpu.telemetry import events as jax_events
from torcheval_tpu.telemetry import health as jax_health

import torcheval_tpu_torch.metrics as tm
from torcheval_tpu_torch import _stats, aot, telemetry
from torcheval_tpu_torch.engine import Evaluator, Prefetcher, ScanRunner
from torcheval_tpu_torch.engine.scan import read_state_arrays, resolve_donate, states_nbytes
from torcheval_tpu_torch.resilience import FaultPlan, InjectedFault
from torcheval_tpu_torch.telemetry import events as port_events
from torcheval_tpu_torch.telemetry import health

from tests.test_torch_telemetry import reset_all

C = 7
RTOL = 1e-6  # figures against JAX's, as in tests/test_torch_collection.py
RAGGED = (33, 70, 150, 97, 40, 256, 12, 130, 64, 99, 201, 5)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    # The port's collection kernel on the CPU is its plain version: the
    # counts the card's blocks replay.
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "1")
    reset_all()
    yield
    reset_all()


def _jax_col(bucket=True, slices=None):
    return jm.MetricCollection(
        {
            "acc": jm.MulticlassAccuracy(num_classes=C, average="macro"),
            "f1": jm.MulticlassF1Score(num_classes=C, average="macro"),
            "cm": jm.MulticlassConfusionMatrix(num_classes=C),
        },
        bucket=bucket, donate=False, slices=slices,
    )


def _col(bucket=True, donate=None, slices=None):
    return tm.MetricCollection(
        {
            "acc": tm.MulticlassAccuracy(num_classes=C, average="macro", device="cpu"),
            "f1": tm.MulticlassF1Score(num_classes=C, average="macro", device="cpu"),
            "cm": tm.MulticlassConfusionMatrix(num_classes=C, device="cpu"),
        },
        bucket=bucket, donate=donate, slices=slices,
    )


def _stream(sizes, seed=0, slices=None):
    rng = np.random.default_rng(seed)
    out = []
    for b in sizes:
        batch = (rng.random((b, C), dtype=np.float32), rng.integers(0, C, b).astype(np.int32))
        if slices:
            batch += (rng.integers(0, slices, b).astype(np.int32),)
        out.append(batch)
    return out


def _jax_stream(batches):
    return [tuple(jnp.asarray(a) for a in b) for b in batches]


def _reference(batches, bucket=True, slices=None):
    """The port's per-batch fused loop the engine must match bit for bit."""
    col = _col(bucket=bucket, slices=slices)
    for b in batches:
        args = tuple(torch.from_numpy(a) for a in b)
        if slices:
            col.fused_update(*args[:-1], slice_ids=args[-1])
        else:
            col.fused_update(*args)
    return col


def _bits(state):
    return {k: (str(np.asarray(v).dtype), np.asarray(v).tobytes()) for k, v in state.items()}


def _assert_bitwise(port_col, other):
    """``other``: a port collection, or a JAX collection or state_dict."""
    a = _bits({k: v.numpy() for k, v in port_col.state_dict().items()})
    if isinstance(other, tm.MetricCollection):
        b = _bits({k: v.numpy() for k, v in other.state_dict().items()})
    else:
        b = _bits(other.state_dict() if hasattr(other, "state_dict") else other)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k] == b[k], f"{k} not bit-identical"


# ------------------------------------------------------------ scan parity
_PARITY = {
    # name: (sizes, seed, evaluator kwargs, collection kwargs, blocks)
    "bucketed-prefetch": (RAGGED, 0, {"block_size": 4, "prefetch": True}, {}, 3),
    "bucketed-no-prefetch": (RAGGED, 1, {"block_size": 4, "prefetch": False}, {}, 3),
    "partial-tail": (RAGGED[:5], 2, {"block_size": 4}, {}, 2),
    "unbucketed-perbatch-tail": ((64,) * 8 + (32, 17), 3,
                                 {"block_size": 4, "bucket": False}, {"bucket": False}, 2),
    "donated": (RAGGED, 6, {"block_size": 4}, {"donate": True}, 3),
    "sliced": (RAGGED, 18, {"block_size": 4}, {"slices": 3}, 3),
    "block-8": (RAGGED, 4, {"block_size": 8}, {}, 2),
}


@pytest.mark.parametrize("megakernel", ["1", "0"])
@pytest.mark.parametrize("case", sorted(_PARITY))
def test_stream_bit_equal_to_jax_and_the_per_batch_loop(case, megakernel, monkeypatch):
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", megakernel)
    sizes, seed, ev_kw, col_kw, blocks = _PARITY[case]
    slices = col_kw.get("slices")
    bucket = col_kw.get("bucket", True)
    batches = _stream(sizes, seed, slices)
    jcol = _jax_col(bucket=bucket, slices=slices)
    JaxEvaluator(jcol, donate=False, **{k: v for k, v in ev_kw.items()}).run(
        _jax_stream(batches))
    col = _col(**col_kw)
    ev = Evaluator(col, **ev_kw).run(batches)
    assert ev.blocks_dispatched == blocks and ev.batches_seen == len(batches)
    _assert_bitwise(col, jcol)
    _assert_bitwise(col, _reference(batches, bucket=bucket, slices=slices))
    if slices:
        # Figures: bit-equal to the port's loop, within RTOL of JAX's (the
        # collection tests' tolerance: the states are bit-equal, the
        # float means may differ in the last place).
        jax_out, port_out = jcol.compute_slices(), col.compute_slices()
        ref_out = _reference(batches, bucket=bucket, slices=slices).compute_slices()
        for label in jax_out:
            for name in jax_out[label]:
                got = port_out[label][name]
                assert torch.equal(got, ref_out[label][name])
                np.testing.assert_allclose(got.numpy(), np.asarray(jax_out[label][name]),
                                           rtol=RTOL, atol=0)


def test_compute_matches_reference_values():
    batches = _stream(RAGGED, seed=4)
    out = Evaluator(_col(), block_size=8).run(batches).result()
    ref = _reference(batches).compute()
    jax_out = JaxEvaluator(_jax_col(), block_size=8, donate=False).run(
        _jax_stream(batches)).result()
    for name in ref:
        assert torch.equal(out[name], ref[name]), name
        np.testing.assert_allclose(out[name].numpy(), np.asarray(jax_out[name]),
                                   rtol=RTOL, atol=0, err_msg=name)


def test_interleaving_direct_fused_updates_stays_consistent():
    batches = _stream(RAGGED[:8], seed=5)
    col = _col()
    ev = Evaluator(col, block_size=4)
    ev.run(batches[:4])
    col.fused_update(*(torch.from_numpy(a) for a in batches[4]))
    ev.run(batches[5:])
    _assert_bitwise(col, _reference(batches))


def test_donation_keeps_the_state_tensors_across_blocks():
    # The port's counterpart of JAX's donated buffers: the states are
    # written in place, the same tensors every block, whatever the bucket.
    batches = _stream((64, 64, 200, 64, 64, 130), seed=7)
    col = _col(donate=True)
    ev = Evaluator(col, block_size=2, prefetch=False)
    ev.run(batches[:2])
    old = col["cm"].confusion_matrix
    ev.run(batches[2:])
    assert col["cm"].confusion_matrix is old
    _assert_bitwise(col, _reference(batches))
    assert resolve_donate(col, None) is True and resolve_donate(_col(), None) is False


# ------------------------------------------------------ step/flush/result
def test_step_buffers_and_auto_dispatches():
    batches = _stream(RAGGED[:5], seed=8)
    ev = Evaluator(_col(), block_size=2)
    for args in batches:
        ev.step(*args)
    assert ev.blocks_dispatched == 2  # one batch pending
    out = ev.result()  # flushes the partial tail
    assert ev.blocks_dispatched == 3 and ev.batches_seen == 5
    np.testing.assert_array_equal(out["cm"].numpy(), _reference(batches).compute()["cm"].numpy())


def test_step_then_run_joins_pending_batches_in_order():
    batches = _stream(RAGGED[:6], seed=9)
    col = _col()
    ev = Evaluator(col, block_size=4)
    ev.step(*batches[0])
    ev.run(batches[1:])
    _assert_bitwise(col, _reference(batches))


def test_single_array_batches():
    vals = [np.asarray([1.0, 2.0], np.float32), np.asarray([3.0, 4.0, 5.0], np.float32)]
    col = tm.MetricCollection({"s": tm.Sum(device="cpu")}, bucket=False)
    ev = Evaluator(col, block_size=2, bucket=False).run(vals)
    jcol = jm.MetricCollection({"s": jm.Sum()}, bucket=False, donate=False)
    JaxEvaluator(jcol, block_size=2, bucket=False, donate=False).run(
        [jnp.asarray(v) for v in vals])
    assert float(ev.result()["s"]) == 15.0 == float(jcol.compute()["s"])


def test_reset_between_epochs():
    batches = _stream(RAGGED[:4], seed=10)
    col = _col()
    ev = Evaluator(col, block_size=4)
    ev.run(batches)
    col.reset()
    ev.run(batches)
    _assert_bitwise(col, _reference(batches))


def test_periodic_snapshots_and_callback():
    batches = _stream((64,) * 8, seed=11)
    seen = []
    ev = Evaluator(_col(), block_size=2, snapshot_every=2,
                   on_snapshot=lambda blocks, vals: seen.append(blocks))
    ev.run(batches)
    assert ev.blocks_dispatched == 4 and seen == [2, 4] and len(ev.snapshots) == 2
    assert ev.last_snapshot is ev.snapshots[-1]
    np.testing.assert_array_equal(ev.last_snapshot["cm"].numpy(), ev.result()["cm"].numpy())


def test_snapshots_publish_quality_events_when_the_bus_is_on():
    telemetry.enable()
    ev = Evaluator(_col(slices=2), block_size=2, snapshot_every=1)
    ev.run(_stream((64,) * 4, seed=19, slices=2))
    quality = port_events.events("quality")
    # acc and f1 are scalars, the matrix is not: (1 global + 2 slices) x 2
    # members, at each of the 2 snapshots.
    assert len(quality) == 12
    assert {(e.metric, e.slice_label, e.window, e.step) for e in quality} == {
        (m, s, "lifetime", b) for m in ("acc", "f1") for s in ("", "0", "1") for b in (1, 2)}


# ------------------------------------------------------------- warmup
def test_warmed_stream_adds_zero_captures():
    batches = _stream(RAGGED, seed=12)
    col = _col()
    ev = Evaluator(col, block_size=4)
    sweep = ev.warmup(batches[0], max_batch=max(RAGGED))
    assert sweep == (128, 256)
    # Warmup is state-invisible and bypasses the dispatch counters.
    assert ev.blocks_dispatched == 0
    _assert_bitwise(col, _col())
    before = aot.trace_count()
    ev.run(batches)
    assert aot.trace_count() == before
    _assert_bitwise(col, _reference(batches))


def test_aot_warmup_delegates_to_evaluator():
    batches = _stream((64, 200), seed=13)
    ev = Evaluator(_col(), block_size=2)
    sweep = aot.warmup(ev, batches[0], max_batch=256)
    assert sweep == ev.warmup(batches[0], max_batch=256)


# ------------------------------------------------------------- telemetry
def test_dispatch_counters_measure_o_n_over_block():
    batches = _stream(RAGGED, seed=14)
    telemetry.enable()
    Evaluator(_col(), block_size=4).run(batches)
    rep = telemetry.report()
    eng = rep["engine"]
    assert eng["blocks"] == 3 and eng["batches"] == 12
    assert eng["dispatches_per_batch"] == pytest.approx(0.25)
    assert rep["spans"]["Evaluator.engine_block"]["calls"] == 3
    assert rep["spans"]["Evaluator.engine_block"]["state_bytes"] > 0
    assert "Evaluator.prefetch_wait" in rep["spans"]


def test_pad_steps_counted_for_partial_tail():
    telemetry.enable()
    Evaluator(_col(), block_size=4).run(_stream(RAGGED[:5], seed=15))
    assert telemetry.report()["engine"]["pad_steps"] == 3


def test_engine_events_match_jax():
    batches = _stream(RAGGED[:9], seed=20)
    telemetry.enable()
    jax_events.enable()
    Evaluator(_col(), block_size=4, prefetch=False).run(batches)
    JaxEvaluator(_jax_col(), block_size=4, prefetch=False, donate=False).run(
        _jax_stream(batches))

    def blocks(events):
        return [(e.block_size, e.batches, e.pad_steps) for e in events.events("engine_block")]

    assert blocks(port_events) == blocks(jax_events) == [(4, 4, 0), (4, 4, 0), (4, 1, 3)]


# ---------------------------------------------------------- abort safety
def test_prefetch_source_error_propagates_with_usable_states():
    batches = _stream(RAGGED[:8], seed=16)

    def bad_stream():
        yield from batches[:6]
        raise ValueError("loader died mid-stream")

    col = _col()
    ev = Evaluator(col, block_size=2, prefetch=True)
    with pytest.raises(ValueError, match="loader died"):
        ev.run(bad_stream())
    _assert_bitwise(col, _reference(batches[:6]))
    col.reset()
    ev.run(batches)
    _assert_bitwise(col, _reference(batches))


@pytest.mark.parametrize("donate", [False, True])
def test_exploding_member_restores_states(donate):
    class _Exploding(tm.Sum):
        def update(self, *args, **kwargs):
            raise RuntimeError("boom inside the block")

    col = tm.MetricCollection({"s": _Exploding(device="cpu")}, bucket=False, donate=donate)
    ev = Evaluator(col, block_size=2, bucket=False, prefetch=False)
    vals = _stream((64, 64), seed=17)
    with pytest.raises(RuntimeError, match="boom"):
        ev.run([(v[0][:, 0],) for v in vals])
    assert float(col["s"].weighted_sum) == 0.0


def test_start_fleet_merge_waits_for_the_fleet_merge():
    # Over a LocalWorld of two engines, each still stepping after the
    # merge starts: the outcome is the flat merge of the snapshots, and
    # the engines' later states are the per-batch loop's.
    from torcheval_tpu_torch.distributed import LocalWorld
    from torcheval_tpu_torch.metrics.toolkit import get_synced_metric
    from torcheval_tpu_torch.parallel import MergePolicy

    vals = _stream((64, 48, 64, 32), seed=23)

    def rank_fn(g, rank):
        ev = Evaluator(_col(), block_size=2, prefetch=False)
        ev.run(vals[2 * rank:2 * rank + 1])
        snapshot = _col()
        snapshot.fused_update(*vals[2 * rank])
        pending = ev.start_fleet_merge(g, topology="tree", recipient="all",
                                       policy=MergePolicy(level_deadline=0.25, poll_slice=0.01))
        ev.step(*vals[2 * rank + 1])
        outcome = pending.result(timeout=30)
        flat = get_synced_metric(snapshot, g, "all").compute()
        loop = _col()
        for v in vals[2 * rank:2 * rank + 2]:
            loop.fused_update(*v)
        return outcome, flat, ev.result(), loop.compute()

    for outcome, flat, later, loop in LocalWorld(2).run(rank_fn):
        assert not outcome.partial and outcome.world_effective == 2
        for name in flat:
            np.testing.assert_array_equal(np.asarray(outcome.value[name]), flat[name].numpy())
            assert torch.equal(later[name], loop[name])


@pytest.mark.parametrize(
    "sizes, block, bucketed",
    [((33, 70, 0, 12), 6, True), ((64, 64, 64), 3, False), ((5,), 4, True),
     ((0, 9), 3, True)],
    ids=["ragged-empty-batch-pad-steps", "unbucketed-full", "one-batch", "empty-first"],
)
def test_card_block_rows_give_the_host_block(sizes, block, bucketed):
    """The card's assembly (concatenate, then gather ``_block_rows``) gives
    the host assembly's arrays and mask, bit for bit."""
    from torcheval_tpu_torch.engine import _block_rows

    batches = _stream(sizes, seed=23)
    ev = Evaluator(_col(bucket=bucketed), block_size=block, bucket=bucketed)
    ev._pending = list(batches)
    host = ev._make_block()
    lead = tuple(host.args[0].shape[:2])
    rows, mask = _block_rows(list(sizes), lead, bucketed, "cpu")
    for j, arg in enumerate(host.args):
        first = batches[0][j]
        whole = np.concatenate([b[j] for b in batches]
                               + [np.zeros((1,) + first.shape[1:], first.dtype)])
        np.testing.assert_array_equal(whole[rows.numpy()].reshape(arg.shape), arg.numpy())
    if bucketed:
        assert torch.equal(mask, host.mask)
    else:
        assert mask is None and host.mask is None
        assert torch.equal(rows, torch.arange(sum(sizes)))


# ------------------------------------------------------------- validation
@pytest.mark.parametrize(
    "make, error, match",
    [
        (lambda: Evaluator(tm.MulticlassAccuracy(num_classes=3, device="cpu")),
         TypeError, "MetricCollection"),
        (lambda: Evaluator(_col(), block_size=0), ValueError, "block_size"),
        (lambda: Evaluator(_col(), snapshot_every=0), ValueError, "snapshot_every"),
        (lambda: Evaluator(tm.MetricCollection({"s": tm.Sum(device="cpu")}), bucket=True),
         ValueError, "mask-aware"),
        (lambda: Evaluator(tm.MetricCollection({"a": tm.BinaryAUROC(device="cpu")})),
         ValueError, "tensor states"),
    ],
    ids=["non-collection", "block-size", "snapshot-every", "mask-aware", "unfusable"],
)
def test_validation(make, error, match):
    with pytest.raises(error, match=match):
        make()


def test_bucket_inherited_from_collection():
    assert Evaluator(_col())._bucket is True
    assert Evaluator(_col(bucket=False))._bucket is False


def test_runner_surface():
    col = _col()
    ev = Evaluator(col, block_size=2).run(_stream((40, 50, 300), seed=21))
    runner = ev.runner
    assert isinstance(runner, ScanRunner) and runner.donate is False and not runner.health
    assert runner.captures == 2 and runner.replays == 2
    assert states_nbytes(col) == sum(v.numel() * v.element_size()
                                     for v in col.state_dict().values())
    assert read_state_arrays(col)["cm"]["confusion_matrix"] is col["cm"].confusion_matrix
    assert Prefetcher is not None


# ------------------------------------------------------------ data health
def _health_col():
    return tm.MetricCollection(
        {"acc": tm.MulticlassAccuracy(num_classes=4, average="macro", device="cpu")},
        bucket=True)


def _jax_health_col():
    return jm.MetricCollection(
        {"acc": jm.MulticlassAccuracy(num_classes=4, average="macro")}, bucket=True,
        donate=False)


def _health_stream(sizes, seed):
    rng = np.random.default_rng(seed)
    return [(rng.random((b, 4), dtype=np.float32), rng.integers(0, 4, b).astype(np.int32))
            for b in sizes]


def _findings(events):
    return [(e.check, e.metric, e.arg, e.count, e.source)
            for e in events.events("data_health")]


@pytest.mark.parametrize(
    "case, sizes, poke, want",
    [
        ("clean", (33, 70, 150, 97, 40, 12), None, []),
        ("partial-tail", (33, 70, 150, 97, 40, 12), None, []),
        ("inf", (33, 70, 150, 97, 40, 12),
         lambda b: (b[4][0].__setitem__((2, 1), np.inf), b[4][0].__setitem__((6, 0), np.inf)),
         [("inf", "", 0, 2, "engine_block")]),
        ("label-range", (33, 70, 40), lambda b: b[1][1].__setitem__(5, 7),
         [("label_range", "acc", 1, 1, "engine_block")]),
    ],
)
def test_engine_health_findings_match_jax(case, sizes, poke, want):
    batches = _health_stream(sizes, seed=len(case))
    if poke is not None:
        poke(batches)
    off = _health_col()
    Evaluator(off, block_size=4, prefetch=False).run(batches)
    health.enable()
    jax_health.enable()
    on = _health_col()
    ev = Evaluator(on, block_size=4, prefetch=False).run(batches)
    JaxEvaluator(_jax_health_col(), block_size=4, prefetch=False, donate=False).run(
        _jax_stream(batches))
    assert ev.blocks_dispatched == 2 if len(sizes) == 6 else 1
    assert _findings(port_events) == _findings(jax_events) == want
    _assert_bitwise(on, off)
    assert ev.runner.health and ev.runner.bounds == (("acc", 4),)


def test_engine_raises_on_corrupt_after_applying():
    batches = _health_stream((33, 70, 40), seed=5)
    batches[0][0][1, 1] = np.inf
    off = _health_col()
    Evaluator(off, block_size=4, prefetch=False).run(batches)
    health.enable(raise_on_corrupt=True)
    col = _health_col()
    with pytest.raises(health.DataCorruptionError):
        Evaluator(col, block_size=4, prefetch=False).run(batches)
    # The monitor observes, it does not gate: the block WAS applied.
    _assert_bitwise(col, off)


def test_no_health_entry_point_runs_disabled(monkeypatch):
    counter = {}

    def counting(name, fn):
        def wrapper(*args, **kwargs):
            counter[name] = counter.get(name, 0) + 1
            return fn(*args, **kwargs)

        return wrapper

    for name in ("label_bounds", "batch_stats", "stats_for_update", "inspect"):
        monkeypatch.setattr(health, name, counting(name, getattr(health, name)))
    batches = _health_stream((33, 70, 150, 97, 40), seed=6)
    Evaluator(_health_col(), block_size=2, prefetch=True).run(batches)
    assert counter == {}


def test_runner_rebuilds_once_per_health_flip():
    batches = _health_stream((32, 32, 32, 32), seed=7)
    ev = Evaluator(_health_col(), block_size=2, prefetch=False)
    ev.run(batches[:2])
    runner = ev.runner
    ev.run(batches[2:])
    assert ev.runner is runner
    health.enable()
    ev.run(batches[:2])
    assert ev.runner is not runner and ev.runner.health


def test_engine_batch_corrupt_rule_is_found_with_its_count():
    # The "engine.batch" chaos site pokes one NaN into the batch; the
    # monitor finds exactly it.
    health.enable()
    batches = _health_stream((33, 70, 40, 90), seed=8)
    with FaultPlan([{"site": "engine.batch", "action": "corrupt", "after": 2, "count": 1}]):
        Evaluator(_health_col(), block_size=2, prefetch=False).run(batches)
    assert _findings(port_events) == [("nan", "", 0, 1, "engine_block")]


# ------------------------------------------------------ checkpoint/resume
_RESUME_SIZES = (33, 70, 150, 97, 40, 12, 130, 64, 99, 5)


def _port_bytes(values):
    return {k: v.numpy().tobytes() for k, v in values.items()}


@pytest.mark.parametrize(
    "bucket, prefetch, donate, sizes, kill_hit",
    [
        (True, False, None, _RESUME_SIZES, 3),
        (True, True, None, _RESUME_SIZES, 3),
        (True, True, True, _RESUME_SIZES, 3),
        (False, True, None, (64,) * 7, 2),
    ],
    ids=["bucketed", "prefetch", "donated", "unbucketed"],
)
def test_kill_and_resume_bit_identity(tmp_path, bucket, prefetch, donate, sizes, kill_hit):
    batches = _stream(sizes, seed=0)
    jref = _jax_col(bucket=bucket)
    JaxEvaluator(jref, block_size=2, bucket=bucket, donate=False).run(_jax_stream(batches))

    def evaluator(**kw):
        return Evaluator(_col(bucket=bucket, donate=donate), block_size=2, bucket=bucket,
                         prefetch=prefetch, **kw)

    reference = evaluator().run(batches).result()
    first = evaluator(checkpoint_dir=str(tmp_path), checkpoint_every_blocks=1)
    assert first.resumed_from is None
    with FaultPlan([{"site": "engine.scan", "after": kill_hit, "count": 1}]):
        with pytest.raises(InjectedFault):
            first.run(batches)
    second = evaluator(checkpoint_dir=str(tmp_path), checkpoint_every_blocks=1)
    assert second.resumed_from is not None and second.batches_seen > 0
    resumed = second.run(batches).result()
    assert second.batches_seen == len(batches)
    assert _port_bytes(resumed) == _port_bytes(reference)
    _assert_bitwise(second.collection, jref)


def test_uninterrupted_run_with_checkpoints_matches_plain(tmp_path):
    batches = _stream(_RESUME_SIZES)
    plain = Evaluator(_col(), block_size=2).run(batches).result()
    checked = Evaluator(_col(), block_size=2, checkpoint_dir=str(tmp_path),
                        checkpoint_every_blocks=2).run(batches).result()
    assert _port_bytes(checked) == _port_bytes(plain)


def test_final_save_checkpoint_flushes_cursor(tmp_path):
    batches = _stream(_RESUME_SIZES)
    evaluator = Evaluator(_col(), block_size=4, checkpoint_dir=str(tmp_path),
                          checkpoint_every_blocks=100)
    evaluator.run(batches)
    path = evaluator.save_checkpoint()
    with open(path, "rb") as fh:
        record = pickle.loads(fh.read())
    assert record["cursor"]["batches_seen"] == len(batches)
    again = Evaluator(_col(), block_size=4, checkpoint_dir=str(tmp_path),
                      checkpoint_every_blocks=100)
    assert again.resumed_from is not None
    resumed = again.run(batches).result()
    assert _port_bytes(resumed) == _port_bytes(evaluator.collection.compute())


@pytest.mark.parametrize(
    "kwargs, error",
    [({"checkpoint_every_blocks": 2}, ValueError),
     ({"checkpoint_every_blocks": 0, "checkpoint_dir": "ckpt"}, ValueError)],
    ids=["every-blocks-requires-dir", "every-blocks-validation"],
)
def test_checkpoint_argument_validation(kwargs, error, tmp_path):
    if "checkpoint_dir" in kwargs:
        kwargs = dict(kwargs, checkpoint_dir=str(tmp_path / kwargs["checkpoint_dir"]))
    with pytest.raises(error):
        Evaluator(_col(), **kwargs)


def test_save_checkpoint_requires_dir():
    with pytest.raises(RuntimeError):
        Evaluator(_col()).save_checkpoint()


def test_save_emits_checkpoint_event(tmp_path):
    telemetry.enable()
    Evaluator(_col(), block_size=2, checkpoint_dir=str(tmp_path),
              checkpoint_every_blocks=1).run(_stream(_RESUME_SIZES))
    assert telemetry.report()["resilience"]["checkpoint"]["save"]["count"] >= 1


def test_capture_counter_counts_once_a_signature():
    before = _stats.trace_counts()
    Evaluator(_col(), block_size=4).run(_stream((33, 70, 40, 12, 150, 97, 256, 130, 5),
                                                seed=22))
    after = _stats.trace_counts()
    assert sum(after.values()) - sum(before.values()) == 2  # buckets 128 and 256
    assert after.get("mega_scan", 0) - before.get("mega_scan", 0) == 2


# ------------------------------------------------- the text family (engine)
# Ported from tests/metrics/test_text.py::TestTextFusionOneProgram: WER,
# WIL and Perplexity ride one engine block program (on the card, one
# captured graph with wavefront.cu inside; here the eager steps).
_SEQ, _VOCAB = 12, 9


def _logits_stream(sizes, seed):
    rng = np.random.default_rng(seed)
    out = []
    for b in sizes:
        logits = rng.normal(size=(b, _SEQ, _VOCAB)).astype(np.float32)
        lens = rng.integers(1, _SEQ + 1, b)
        target = rng.integers(0, _VOCAB, (b, _SEQ)).astype(np.int32)
        target[np.arange(_SEQ)[None, :] >= lens[:, None]] = -1
        out.append((logits, target))
    return out


def _text_family(ns, ppl_only=False):
    members = {"ppl": ns.Perplexity(ignore_index=-1, **_cpu(ns))}
    if not ppl_only:
        members = {"wer": ns.WordErrorRate(**_cpu(ns)),
                   "wil": ns.WordInformationLost(**_cpu(ns)), **members}
    kw = {"donate": False} if ns is jm else {}
    return ns.MetricCollection(members, bucket=True, **kw)


def _cpu(ns):
    return {"device": "cpu"} if ns is tm else {}


def test_text_family_is_one_block_program_and_matches_jax(monkeypatch):
    from torcheval_tpu import _stats as jax_stats
    from torcheval_tpu import telemetry as jax_telemetry

    batches = _logits_stream((16,) * 8, seed=2)
    before = _stats.trace_counts()
    telemetry.enable()
    col = _text_family(tm)
    Evaluator(col, block_size=4).run(batches)
    after = _stats.trace_counts()
    # One program (one capture on the card) for the one bucket signature.
    assert sum(after.values()) - sum(before.values()) == 1
    assert after.get("engine_scan", 0) - before.get("engine_scan", 0) == 1
    family = telemetry.report()["engine"]
    assert family["blocks"] == 2
    reset_all()
    telemetry.enable()
    Evaluator(_text_family(tm, ppl_only=True), block_size=4).run(batches)
    ppl_only = telemetry.report()["engine"]
    assert family["blocks"] == ppl_only["blocks"]
    assert family["dispatches_per_batch"] == ppl_only["dispatches_per_batch"]
    # The JAX engine on the same stream: the same block counts, the word
    # counters bit-equal, perplexity within float32 summation order.
    jax_telemetry.disable()
    jax_telemetry.clear()
    jax_telemetry.enable()
    base = jax_stats.trace_count("engine_scan")
    jcol = _text_family(jm)
    JaxEvaluator(jcol, block_size=4).run(_jax_stream(batches))
    assert jax_stats.trace_count("engine_scan") - base == 1
    assert jax_telemetry.report()["engine"]["blocks"] == family["blocks"]
    jax_telemetry.disable()
    jax_telemetry.clear()
    for name in ("wer", "wil"):
        for state in ("errors", "target_total", "input_total"):
            assert np.asarray(getattr(col[name], state)).tobytes() == np.asarray(
                getattr(jcol[name], state)).tobytes(), f"{name}.{state}"
    got, want = col.compute(), jcol.compute()
    assert float(got["wer"]) == float(want["wer"]) and float(got["wil"]) == float(want["wil"])
    assert float(got["ppl"]) == pytest.approx(float(want["ppl"]), rel=1e-6)
    assert col["ppl"].num_total.item() == float(jcol["ppl"].num_total)


def test_text_family_blocks_are_bit_equal_to_the_per_batch_loop():
    batches = _logits_stream((5, 9, 3, 16, 7), seed=1)
    col = _text_family(tm)
    Evaluator(col, block_size=4).run(batches)
    ref = _text_family(tm)
    for b in batches:
        ref.fused_update(*(torch.from_numpy(a) for a in b))
    _assert_bitwise(col, ref)


def test_text_engine_counters_bit_equal_to_host_strings_and_jax():
    from torcheval_tpu.metrics.text._tokens import WordInterner as JaxInterner
    from torcheval_tpu.metrics.text._tokens import tokenize_pairs as jax_tokenize

    from torcheval_tpu_torch.metrics.text._tokens import WordInterner, tokenize_pairs

    rng = np.random.default_rng(3)
    words = [f"w{k}" for k in range(11)]

    def sentence():
        return " ".join(rng.choice(words, rng.integers(0, 9)))

    string_batches = [([sentence() for _ in range(b)], [sentence() for _ in range(b)])
                      for b in (6, 11, 4, 9, 7, 3)]
    it, jit_ = WordInterner(), JaxInterner()
    token_batches = [tokenize_pairs(h, r, interner=it) for h, r in string_batches]
    jax_batches = [tuple(map(jnp.asarray, jax_tokenize(h, r, interner=jit_)))
                   for h, r in string_batches]

    def members(ns):
        return {"wer": ns.WordErrorRate(**_cpu(ns)), "wip": ns.WordInformationPreserved(**_cpu(ns)),
                "wil": ns.WordInformationLost(**_cpu(ns))}

    col = tm.MetricCollection(members(tm), bucket=True)
    Evaluator(col, block_size=3).run(token_batches)
    jcol = jm.MetricCollection(members(jm), bucket=True, donate=False)
    JaxEvaluator(jcol, block_size=3).run(jax_batches)
    host = tm.WordErrorRate(device="cpu")
    for h, r in string_batches:
        host.update(h, r)
    for name in ("wer", "wip", "wil"):
        for state in ("errors", "target_total", "input_total"):
            got = getattr(col[name], state).numpy().tobytes()
            assert got == getattr(host, state).numpy().tobytes(), f"{name}.{state} vs host"
            assert got == np.asarray(getattr(jcol[name], state)).tobytes(), f"{name}.{state} vs JAX"
