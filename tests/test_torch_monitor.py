"""The port's monitor wrappers (``monitor/decay.py``, ``monitor/window.py``,
``monitor/digest.py``, ``monitor/quality.window_kind``) against the JAX
package's on the same numpy streams, made from a seed: ``Decayed``'s
float32 states bit-equal to JAX's over many updates (the recurrence
``s = s * d + x`` is two rounded operations in both packages, the
multiply then the add), ``SlidingWindow``'s bucket axis and epoch
metadata, and ``StreamDigest``'s counts, each on the per-batch path, in a
``fused_update`` collection and through the engine's eager step loop (the
card's CUDA-graph path: tests/test_torch_cuda.py); and ``state_from_jax``
continuing each wrapper from a JAX ``state_dict``.

Mirrors ``tests/monitor/test_decay.py``, ``test_window.py``,
``test_digest.py``, the monitor cases of
``tests/metrics/test_fusable_window.py`` and the ``window_kind`` cases of
``tests/monitor/test_quality.py``, at small sizes."""

import copy
import itertools
import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
import torcheval_tpu.monitor as jmon
from torcheval_tpu.engine import Evaluator as JaxEvaluator

import torcheval_tpu_torch.metrics as P
import torcheval_tpu_torch.monitor as tmon
from torcheval_tpu_torch.convert import state_from_jax
from torcheval_tpu_torch.engine import Evaluator
from torcheval_tpu_torch.metrics.window import WindowedClickThroughRate
from torcheval_tpu_torch.monitor import Decayed, SlidingWindow, StreamDigest, window_kind
from torcheval_tpu_torch.resilience import FaultPlan, InjectedFault

CPU = "cpu"
C = 4
RAGGED = (20, 33, 7, 41, 12, 9, 64, 15)


@pytest.fixture(autouse=True)
def _megakernel(monkeypatch):
    # Collections take the collection kernel's plain version on the CPU, as
    # the card's replays take the kernel.
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "1")


def _acc(lib=P, **kw):
    dev = {"device": CPU} if lib is P else {}
    return lib.MulticlassAccuracy(num_classes=C, **kw, **dev)


def _batch(rng, n):
    return rng.random((n, C), dtype=np.float32), rng.integers(0, C, n).astype(np.int32)


def _j(batch):
    return tuple(jnp.asarray(a) for a in batch)


def _numpy_state(metric):
    return {k: np.asarray(v) for k, v in metric.state_dict().items()}


def _same_state(port, jax_metric):
    want = _numpy_state(jax_metric)
    got = port.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        g = got[k].numpy()
        assert g.dtype == v.dtype, k
        np.testing.assert_array_equal(g, v, err_msg=k)


def _bits(values):
    return {k: np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v).tobytes()
            for k, v in values.items()}


# ------------------------------------------------------------------- Decayed
def test_exactly_one_of_decay_and_half_life():
    with pytest.raises(ValueError, match="exactly one"):
        Decayed(_acc())
    with pytest.raises(ValueError, match="exactly one"):
        Decayed(_acc(), decay=0.9, half_life_updates=4)


@pytest.mark.parametrize("bad", [0.0, 1.0, -0.5, 1.5])
def test_decay_range(bad):
    with pytest.raises(ValueError, match="decay"):
        Decayed(_acc(), decay=bad)


def test_half_life_positive():
    with pytest.raises(ValueError, match="half_life_updates"):
        Decayed(_acc(), half_life_updates=0)


def test_decayed_wraps_metrics_only():
    with pytest.raises(TypeError, match="Metric instance"):
        Decayed(object(), decay=0.9)


def test_decayed_rejects_buffer_state_metrics():
    with pytest.raises(TypeError, match="array states"):
        Decayed(P.BinaryAUROC(device=CPU), decay=0.9)


def test_half_life_factor():
    d = Decayed(_acc(), half_life_updates=3)
    assert d.decay == jmon.Decayed(_acc(J), half_life_updates=3).decay
    assert d.decay == pytest.approx(0.5 ** (1 / 3)) and d.device == torch.device(CPU)


@pytest.mark.parametrize("inner", ["accuracy", "confusion_matrix"])
def test_decayed_states_bit_equal_to_jax_over_many_updates(inner):
    # Forty updates of s = s * d + x in float32: the port's multiply and add
    # are two rounded operations, as the JAX package's eager update runs
    # them, so the states agree bit for bit (no tolerance needed).
    rng = np.random.default_rng(3)

    def make(lib):
        dev = {"device": CPU} if lib is P else {}
        if inner == "accuracy":
            return lib.MulticlassAccuracy(num_classes=C, average="macro", **dev)
        return lib.MulticlassConfusionMatrix(num_classes=C, **dev)

    port = Decayed(make(P), half_life_updates=5)
    ref = jmon.Decayed(make(J), half_life_updates=5)
    for _ in range(40):
        x, y = _batch(rng, int(rng.integers(5, 60)))
        port.update(x, y)
        ref.update(*_j((x, y)))
    _same_state(port, ref)
    np.testing.assert_allclose(np.asarray(port.compute()), np.asarray(ref.compute()),
                               rtol=1e-6)


def _np_binned_counts(scores, hits, edges):
    # Per-edge `score >= edge` counts, the binned family's statistics.
    ge = scores[None, :] >= edges[:, None]
    return {"num_tp": (ge & hits[None, :]).sum(1)[None],
            "num_fp": (ge & ~hits[None, :]).sum(1)[None],
            "num_pos": np.asarray([hits.sum()]), "num_total": np.asarray([hits.size])}


def _curve(kind, **dev):
    if kind == "binned":
        return P.BinaryBinnedAUROC(threshold=16, **dev)
    return P.BinaryAUROC(sketch=True, sketch_bins=16, **dev)


@pytest.mark.parametrize("kind", ["binned", "sketch"])
def test_decayed_curve_keeps_its_edges_and_decays_counts_as_numpy(kind):
    # Only the counts decay: the edges stay the metric's own, and the counts
    # follow a numpy float32 recurrence over per-batch counts at those edges.
    rng = np.random.default_rng(3)
    port = Decayed(_curve(kind, device=CPU), half_life_updates=5)
    edges = _curve(kind, device=CPU).threshold.numpy()
    d = np.float32(port.decay)
    want = {k: np.float32(0) for k in ("num_tp", "num_fp", "num_pos", "num_total")}
    for _ in range(40):
        n = int(rng.integers(5, 60))
        x, y = rng.random(n, dtype=np.float32), rng.integers(0, 2, n).astype(np.int32)
        port.update(x, y)
        for k, v in _np_binned_counts(x, y == 1, edges).items():
            want[k] = want[k] * d + v.astype(np.float32)
    assert port.threshold.dtype == torch.float32
    np.testing.assert_array_equal(port.threshold.numpy(), edges)
    for k, v in want.items():
        np.testing.assert_array_equal(getattr(port, k).numpy(), v, err_msg=k)
    ref = _curve(kind, device=CPU)
    for k in want:
        setattr(ref, k, getattr(port, k))
    assert _bits({"c": port.compute()[0] if kind == "binned" else port.compute()}) == \
        _bits({"c": ref.compute()[0] if kind == "binned" else ref.compute()})


def test_decayed_binned_edges_the_kept_divergence():
    # JAX's Decayed multiplies the threshold edges with the counts, so after
    # k updates its curve counts against edges scaled by d^k; the port keeps
    # the edges (ROADMAP queue 3).
    rng = np.random.default_rng(31)
    port = Decayed(P.BinaryBinnedAUROC(threshold=16, device=CPU), decay=0.5)
    ref = jmon.Decayed(J.BinaryBinnedAUROC(threshold=16), decay=0.5)
    for _ in range(4):
        x, y = rng.random(50, dtype=np.float32), rng.integers(0, 2, 50).astype(np.int32)
        port.update(x, y)
        ref.update(*_j((x, y)))
    edges = np.linspace(0, 1, 16, dtype=np.float32)
    np.testing.assert_allclose(port.threshold.numpy(), edges, atol=1e-7)
    np.testing.assert_allclose(np.asarray(ref.state_dict()["threshold"]), edges * 0.5 ** 4,
                               atol=1e-7)


def test_compute_matches_closed_form():
    rng = np.random.default_rng(3)
    d = 0.5
    m = Decayed(_acc(), decay=d)
    per_batch = []
    for n in (5, 9, 3, 7):
        scores, target = _batch(rng, n)
        m.update(scores, target)
        per_batch.append((float((scores.argmax(1) == target).sum()), float(n)))
    k = len(per_batch)
    num = sum(d ** (k - 1 - i) * c for i, (c, _) in enumerate(per_batch))
    den = sum(d ** (k - 1 - i) * t for i, (_, t) in enumerate(per_batch))
    assert float(m.compute()) == pytest.approx(num / den, rel=1e-6)


def test_recent_batches_dominate():
    wrong = np.asarray([[1.0, 0.0, 0.0, 0.0]] * 8, np.float32)
    right = np.asarray([[0.0, 1.0, 0.0, 0.0]] * 8, np.float32)
    one = np.ones(8, np.int32)
    decayed, lifetime = Decayed(_acc(), decay=0.25), _acc()
    for m in (decayed, lifetime):
        for _ in range(4):
            m.update(wrong, one)
        m.update(right, one)
    assert float(lifetime.compute()) == pytest.approx(0.2)
    assert float(decayed.compute()) > 0.7


def test_fully_masked_update_is_bit_exact_noop():
    rng = np.random.default_rng(4)
    m = Decayed(_acc(), decay=0.9)
    m.update(*_batch(rng, 6))
    before = _bits(m.state_dict())
    m.update(*_batch(rng, 6), mask=np.zeros(6, np.int32))
    assert _bits(m.state_dict()) == before


def test_masked_update_decays_once():
    rng = np.random.default_rng(5)
    scores, target = _batch(rng, 8)
    mask = np.asarray([1, 1, 1, 1, 1, 0, 0, 0], np.int32)
    a, b = Decayed(_acc(), decay=0.5), Decayed(_acc(), decay=0.5)
    ref = jmon.Decayed(_acc(J), decay=0.5)
    seed = _batch(rng, 4)
    for m in (a, b):
        m.update(*seed)
    ref.update(*_j(seed))
    a.update(scores, target, mask=mask)
    ref.update(*_j((scores, target)), mask=jnp.asarray(mask))
    b.update(scores[:5], target[:5])
    assert torch.equal(a.compute(), b.compute())
    _same_state(a, ref)


def test_decayed_fused_matches_unfused_and_jax():
    rng = np.random.default_rng(6)
    batches = [_batch(rng, n) for n in (20, 33, 7)]
    fused = P.MetricCollection({"dacc": Decayed(_acc(), decay=0.75)}, bucket=True)
    plain = copy.deepcopy(fused)
    ref = J.MetricCollection({"dacc": jmon.Decayed(_acc(J), decay=0.75)}, bucket=True,
                             donate=False)
    for b in batches:
        fused.fused_update(*b)
        plain.update(*b)
        ref.fused_update(*_j(b))
    assert _bits(fused.state_dict()) == _bits(plain.state_dict())
    assert _bits(fused.state_dict()) == _bits({k: np.asarray(v)
                                               for k, v in ref.state_dict().items()})


def test_decayed_engine_bit_identical_to_perbatch():
    # The engine's blocks run fully masked pad steps the per-batch path never
    # sees; the torch.where(any valid, d, 1.0) factor makes them exact no-ops.
    rng = np.random.default_rng(7)
    batches = [_batch(rng, n) for n in (20, 33, 7, 41, 12, 9)]
    scan_col = P.MetricCollection({"dacc": Decayed(_acc(), decay=0.9)}, bucket=True)
    ref_col = copy.deepcopy(scan_col)
    Evaluator(scan_col, block_size=4, prefetch=False).run(batches).flush()
    for b in batches:
        ref_col.fused_update(*b)
    assert _bits(scan_col.compute()) == _bits(ref_col.compute())
    jcol = J.MetricCollection({"dacc": jmon.Decayed(_acc(J), decay=0.9)}, bucket=True,
                              donate=False)
    JaxEvaluator(jcol, block_size=4, prefetch=False).run(batches).flush()
    assert _bits(scan_col.state_dict()) == _bits({k: np.asarray(v)
                                                  for k, v in jcol.state_dict().items()})


def test_decayed_state_dict_round_trip():
    rng = np.random.default_rng(8)
    a = Decayed(_acc(), decay=0.8).update(*_batch(rng, 10))
    b = Decayed(_acc(), decay=0.8)
    b.load_state_dict(a.state_dict())
    assert torch.equal(a.compute(), b.compute())
    nxt = _batch(rng, 5)
    a.update(*nxt)
    b.update(*nxt)
    assert torch.equal(a.compute(), b.compute())


def test_decayed_pickle_reshares_registry():
    rng = np.random.default_rng(9)
    a = Decayed(_acc(), decay=0.8).update(*_batch(rng, 10))
    b = pickle.loads(pickle.dumps(a))
    assert b._state_name_to_default is b.inner._state_name_to_default
    assert torch.equal(a.compute(), b.compute())
    b.reset()
    assert float(b.num_total) == 0.0


def test_integer_states_cast_to_float():
    d = Decayed(P.MulticlassConfusionMatrix(num_classes=C, device=CPU), decay=0.9)
    for name, default in d._state_name_to_default.items():
        assert getattr(d, name).dtype == torch.float32 and default.dtype == torch.float32
    d.reset()
    assert d.confusion_matrix.dtype == torch.float32


def test_merge_requires_matching_decay():
    a = Decayed(_acc(), decay=0.9)
    with pytest.raises(ValueError, match="same"):
        a.merge_state([Decayed(_acc(), decay=0.5)])
    with pytest.raises(ValueError, match="same"):
        a.merge_state([_acc()])
    rng = np.random.default_rng(10)
    b = Decayed(_acc(), decay=0.9).update(*_batch(rng, 9))
    a.update(*_batch(rng, 7)).merge_state([b])
    assert float(a.num_total) == pytest.approx(16.0)


# -------------------------------------------------------------- SlidingWindow
def test_buckets_at_least_one():
    with pytest.raises(ValueError, match="buckets"):
        SlidingWindow(_acc(), buckets=0)


def test_window_wraps_metrics_only():
    with pytest.raises(TypeError, match="Metric instance"):
        SlidingWindow(object(), buckets=2)


def test_window_rejects_buffer_state_metrics():
    with pytest.raises(TypeError, match="array states"):
        SlidingWindow(P.BinaryAUROC(device=CPU), buckets=2)


def test_window_refuses_extremum_states_the_kept_divergence():
    # A window sums its buckets and opens each at zero: neither holds for
    # a max / min state.  ROADMAP's smallest input: the window of the last
    # two epochs holds [-2, 1] and [4], so its max is 4.0.
    jax_window = jmon.SlidingWindow(J.Max(), buckets=2)
    for epoch, xs in enumerate(([3.0, 5.0], [-2.0, 1.0], [4.0])):
        if epoch:
            jax_window.advance()
        jax_window.update(jnp.asarray(xs))
    assert float(jax_window.compute()) == 5.0  # the JAX package: 1 + 4
    for inner in (P.Max(device=CPU), P.Min(device=CPU),
                  P.PeakSignalNoiseRatio(device=CPU)):
        with pytest.raises(TypeError, match="merges by max / min"):
            SlidingWindow(inner, buckets=2)
    # With a data_range PSNR never reads its target extrema: its window
    # is a sum of counts, as JAX's, and stays allowed.
    w = SlidingWindow(P.PeakSignalNoiseRatio(data_range=1.0, device=CPU), buckets=2)
    jw = jmon.SlidingWindow(J.PeakSignalNoiseRatio(data_range=1.0), buckets=2)
    rng = np.random.default_rng(3)
    for _ in range(3):
        a, b = rng.random((2, 4, 4)).astype(np.float32)
        w.update(torch.from_numpy(a), torch.from_numpy(b))
        jw.update(jnp.asarray(a), jnp.asarray(b))
        w.advance()
        jw.advance()
    np.testing.assert_allclose(float(w.compute()), float(jw.compute()), rtol=1e-6)


def test_tumbling_window_forgets_on_advance():
    rng = np.random.default_rng(1)
    w = SlidingWindow(_acc(), buckets=1)
    w.update(*_batch(rng, 12))
    w.advance()
    fresh = _batch(rng, 9)
    w.update(*fresh)
    assert torch.equal(w.compute(), _acc().update(*fresh).compute())


def test_sliding_window_covers_last_k_epochs_bit_equal_to_jax():
    rng = np.random.default_rng(2)
    epoch_a, epoch_b, epoch_c = (_batch(rng, n) for n in (10, 14, 8))
    w = SlidingWindow(_acc(), buckets=2)
    ref = jmon.SlidingWindow(_acc(J), buckets=2)
    for m, to in ((w, lambda b: b), (ref, _j)):
        m.update(*to(epoch_a))
        m.advance()
        m.update(*to(epoch_b))
    assert torch.equal(w.compute(), _acc().update(*epoch_a).update(*epoch_b).compute())
    _same_state(w, ref)
    for m, to in ((w, lambda b: b), (ref, _j)):
        m.advance()
        m.update(*to(epoch_c))
    assert torch.equal(w.compute(), _acc().update(*epoch_b).update(*epoch_c).compute())
    assert w.epochs_advanced == ref.epochs_advanced == 2
    _same_state(w, ref)


@pytest.mark.parametrize("kind", ["binned", "sketch"])
def test_window_of_a_curve_keeps_its_edges_and_matches_a_fresh_metric(kind):
    # Three epochs through buckets=2: the reading is a fresh metric's over
    # the last two epochs' batches, and its counts are numpy's at the edges.
    rng = np.random.default_rng(21)
    epochs = [[(rng.random(n, dtype=np.float32), rng.integers(0, 2, n).astype(np.int32))
               for n in sizes] for sizes in ((40, 17), (33,), (25, 8))]
    w = SlidingWindow(_curve(kind, device=CPU), buckets=2)
    for i, epoch in enumerate(epochs):
        if i:
            w.advance()
        for b in epoch:
            w.update(*b)
    edges = _curve(kind, device=CPU).threshold.numpy()
    assert w.threshold.shape == edges.shape
    np.testing.assert_array_equal(w.threshold.numpy(), edges)
    fresh = _curve(kind, device=CPU)
    for b in epochs[1] + epochs[2]:
        fresh.update(*b)
    got, want = w.compute(), fresh.compute()
    if kind == "binned":
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        assert torch.equal(got, want)
    x = np.concatenate([b[0] for b in epochs[1] + epochs[2]])
    y = np.concatenate([b[1] for b in epochs[1] + epochs[2]])
    for k, v in _np_binned_counts(x, y == 1, edges).items():
        np.testing.assert_array_equal(getattr(w, k).sum(0).numpy(), v, err_msg=k)


def test_window_of_a_curve_through_the_engine_matches_a_fresh_metric():
    rng = np.random.default_rng(22)
    batches = [(rng.random(n, dtype=np.float32), rng.integers(0, 2, n).astype(np.int32))
               for n in (30, 41, 12, 50, 27, 9)]
    col = P.MetricCollection({"w": SlidingWindow(_curve("binned", device=CPU), buckets=2)},
                             bucket=True)
    ev = Evaluator(col, block_size=2, prefetch=False)
    for lo in range(0, 6, 2):
        ev.run(batches[lo:lo + 2])
        col["w"].advance()
    fresh = _curve("binned", device=CPU)
    for b in batches[4:]:
        fresh.update(*b)
    got, want = col["w"].compute(), fresh.compute()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_window_binned_edges_the_kept_divergence():
    # JAX's SlidingWindow gives the threshold edges a zero-filled bucket
    # axis, so its windowed binned curve counts every score at edges of
    # zero; the port keeps the edges unbucketed (ROADMAP queue 3), and
    # refuses to continue such a checkpoint.
    rng = np.random.default_rng(23)
    x, y = rng.random(80, dtype=np.float32), rng.integers(0, 2, 80).astype(np.int32)
    ref = jmon.SlidingWindow(J.BinaryBinnedAUROC(threshold=16), buckets=2)
    ref.update(*_j((x, y)))
    ref_score, ref_edges = ref.compute()
    assert not np.asarray(ref_edges).any() and float(ref_score) == 0.5
    port = SlidingWindow(P.BinaryBinnedAUROC(threshold=16, device=CPU), buckets=2)
    port.update(x, y)
    want = P.BinaryBinnedAUROC(threshold=16, device=CPU).update(x, y).compute()
    assert torch.equal(port.compute()[0], want[0]) and float(want[0]) != 0.5
    with pytest.raises(RuntimeError, match="unbucketed"):
        port.load_state_dict(state_from_jax(_numpy_state(ref)))


def test_window_merge_requires_matching_edges():
    with pytest.raises(ValueError, match="threshold"):
        SlidingWindow(_curve("binned", device=CPU), buckets=2).merge_state(
            [SlidingWindow(P.BinaryBinnedAUROC(threshold=8, device=CPU), buckets=2)])


def test_reset_clears_epoch_counter():
    rng = np.random.default_rng(3)
    w = SlidingWindow(_acc(), buckets=3)
    w.update(*_batch(rng, 5)).advance()
    w.reset()
    assert w.epochs_advanced == 0 and float(w.num_total.abs().sum()) == 0.0
    assert w.num_total.shape == (3,)


def test_merge_adds_bucket_rows():
    rng = np.random.default_rng(4)
    batch_a, batch_b = _batch(rng, 11), _batch(rng, 17)
    w1 = SlidingWindow(_acc(), buckets=2).update(*batch_a)
    w2 = SlidingWindow(_acc(), buckets=2).update(*batch_b)
    w1.merge_state([w2])
    assert torch.equal(w1.compute(), _acc().update(*batch_a).update(*batch_b).compute())


def test_merge_requires_matching_buckets():
    with pytest.raises(ValueError, match="buckets"):
        SlidingWindow(_acc(), buckets=2).merge_state([SlidingWindow(_acc(), buckets=3)])


def test_window_state_dict_round_trip_with_epoch_meta():
    rng = np.random.default_rng(5)
    a = SlidingWindow(_acc(), buckets=3)
    a.update(*_batch(rng, 10)).advance().update(*_batch(rng, 6))
    sd = a.state_dict()
    assert sd["window_epochs"].tolist() == [3, 1]
    b = SlidingWindow(_acc(), buckets=3)
    b.load_state_dict(sd)
    assert b.epochs_advanced == a.epochs_advanced == 1
    assert torch.equal(a.compute(), b.compute())
    nxt = _batch(rng, 7)
    for w in (a, b):
        w.advance().update(*nxt)
    assert torch.equal(a.compute(), b.compute())


def test_bucket_mismatch_rejected_at_load():
    a = SlidingWindow(_acc(), buckets=2)
    with pytest.raises(RuntimeError, match="buckets=2"):
        SlidingWindow(_acc(), buckets=4).load_state_dict(a.state_dict())


def _monitored(lib):
    dev = {"device": CPU} if lib is P else {}
    mon = tmon if lib is P else jmon
    return lib.MetricCollection(
        {
            "dacc": mon.Decayed(lib.MulticlassAccuracy(num_classes=C, average="macro", **dev),
                                half_life_updates=8),
            "wf1": mon.SlidingWindow(lib.MulticlassF1Score(num_classes=C, average="macro",
                                                           **dev), buckets=2),
        },
        bucket=True, **({} if lib is P else {"donate": False}),
    )


def _ragged(seed=11):
    rng = np.random.default_rng(seed)
    return [_batch(rng, n) for n in (33, 70, 15, 97, 40, 12, 64, 9)]


def test_kill_and_resume_bit_identity(tmp_path):
    reference = Evaluator(_monitored(P), block_size=2, prefetch=False).run(_ragged()).result()
    directory = os.path.join(str(tmp_path), "ckpt")
    first = Evaluator(_monitored(P), block_size=2, prefetch=False, checkpoint_dir=directory,
                      checkpoint_every_blocks=1)
    assert first.resumed_from is None
    with FaultPlan([{"site": "engine.scan", "after": 2, "count": 1}]):
        with pytest.raises(InjectedFault):
            first.run(_ragged())
    second = Evaluator(_monitored(P), block_size=2, prefetch=False, checkpoint_dir=directory,
                       checkpoint_every_blocks=1)
    assert second.resumed_from is not None
    assert _bits(second.run(_ragged()).result()) == _bits(reference)


def test_uninterrupted_checkpointing_matches_plain_and_jax(tmp_path):
    plain_ev = Evaluator(_monitored(P), block_size=2, prefetch=False).run(_ragged())
    checked = Evaluator(_monitored(P), block_size=2, prefetch=False,
                        checkpoint_dir=os.path.join(str(tmp_path), "ckpt2"),
                        checkpoint_every_blocks=2).run(_ragged()).result()
    assert _bits(checked) == _bits(plain_ev.result())
    jev = JaxEvaluator(_monitored(J), block_size=2, prefetch=False).run(_ragged())
    want = {k: np.asarray(v) for k, v in jev.collection.state_dict().items()}
    assert _bits(plain_ev.collection.state_dict()) == _bits(want)


def test_window_fused_and_engine_bit_identical_to_unfused_and_jax():
    # Fusable: the epoch cursor stays on the host (advance() between runs)
    # and the accumulation is plain tensor ops, so the fused path and the
    # engine's blocks give the per-batch bits, as JAX's do.
    rng = np.random.default_rng(0)

    def col(lib):
        dev = {"device": CPU} if lib is P else {}
        mon = tmon if lib is P else jmon
        return lib.MetricCollection(
            {"wacc": mon.SlidingWindow(lib.MulticlassAccuracy(num_classes=C, average="macro",
                                                              **dev), buckets=2),
             "wcm": mon.SlidingWindow(lib.MulticlassConfusionMatrix(num_classes=C, **dev),
                                      buckets=3)},
            bucket=True, **({} if lib is P else {"donate": False}),
        )

    fused, ref = col(P), col(J)
    fused._check_fusable()
    plain, engine = copy.deepcopy(fused), copy.deepcopy(fused)
    ev = Evaluator(engine, block_size=2, prefetch=False)
    first, second = [_batch(rng, n) for n in (20, 33, 7)], [_batch(rng, n) for n in (14, 9)]
    for part in (first, second):
        for b in part:
            fused.fused_update(*b)
            plain.update(*b)
            ref.fused_update(*_j(b))
        ev.run(part)
        for c in (fused, plain, engine, ref):
            c["wacc"].advance()
            c["wcm"].advance()
    want = _bits({k: np.asarray(v) for k, v in ref.state_dict().items()})
    for c in (fused, plain, engine):
        assert _bits(c.state_dict()) == want
    assert _bits(fused.compute()) == _bits(plain.compute())


def test_ring_windowed_member_still_refused():
    col = P.MetricCollection({"wctr": WindowedClickThroughRate(device=CPU)})
    with pytest.raises(ValueError, match="windowed member 'wctr'"):
        col.fused_update(torch.tensor([1.0, 0.0, 1.0]))
    with pytest.raises(ValueError, match="wctr"):
        Evaluator(col, block_size=2)
    with pytest.raises(ValueError, match="member 'auroc' state"):
        P.MetricCollection({"auroc": P.BinaryAUROC(device=CPU)})._check_fusable()


# --------------------------------------------------------------- StreamDigest
def _latencies(seed=0, n=4096):
    rng = np.random.default_rng(seed)
    return rng.lognormal(mean=-4.0, sigma=1.5, size=n).astype(np.float32)


def test_digest_relative_error_within_bound_and_bit_equal_to_jax():
    values = _latencies(seed=1)
    digest = StreamDigest(device=CPU).update(values)
    ref = jmon.StreamDigest()
    ref.update(jnp.asarray(values))
    _same_state(digest, ref)
    got = digest.compute().numpy()
    np.testing.assert_array_equal(got, np.asarray(ref.compute()))
    for q, g in zip(digest.quantiles, got):
        want = np.quantile(values, q)
        assert abs(g - want) / want <= 2.0 / digest.bins
    assert float(digest.quantile(0.5)) == float(ref.quantile(0.5))


def test_digest_empty_sentinel():
    assert StreamDigest(device=CPU).compute().shape == (0,)


def test_digest_streamed_equals_one_shot():
    values = _latencies(seed=2)
    one = StreamDigest(device=CPU).update(values)
    chunked = StreamDigest(device=CPU)
    for lo in range(0, 4096, 512):
        chunked.update(values[lo:lo + 512])
    assert torch.equal(one.counts, chunked.counts)


def test_digest_bad_quantile_rejected():
    for qs in ((0.5, 1.5), (0.0,)):
        with pytest.raises(ValueError):
            StreamDigest(quantiles=qs, device=CPU)


def test_digest_all_merge_orders_identical():
    def shards():
        return [StreamDigest(device=CPU).update(_latencies(seed=10 + i, n=700)) for i in range(3)]

    jroot = jmon.StreamDigest()
    jroot.update(jnp.asarray(_latencies(seed=9, n=300)))
    jshards = []
    for i in range(3):
        d = jmon.StreamDigest()
        d.update(jnp.asarray(_latencies(seed=10 + i, n=700)))
        jshards.append(d)
    jroot.merge_state(jshards)
    for order in itertools.permutations(range(3)):
        parts = shards()
        root = StreamDigest(device=CPU).update(_latencies(seed=9, n=300))
        for i in order:
            root.merge_state([parts[i]])
        np.testing.assert_array_equal(root.counts.numpy(), np.asarray(jroot.counts))


def test_digest_geometry_mismatch_rejected():
    with pytest.raises(ValueError, match="ladder geometry"):
        StreamDigest(bins=64, device=CPU).merge_state([StreamDigest(bins=32, device=CPU)])


def test_digest_mask_equals_dropping_samples():
    values = _latencies(seed=3, n=1024)
    mask = np.arange(1024) % 4 != 0
    masked = StreamDigest(device=CPU).update(values, mask=mask)
    assert torch.equal(masked.counts, StreamDigest(device=CPU).update(values[mask]).counts)


def test_digest_reset_checkpoint_and_state_from_jax():
    ref = jmon.StreamDigest(base=1e-3, levels=20, bins=48)
    ref.update(jnp.asarray(_latencies(seed=4, n=512)))
    d = StreamDigest(base=1e-3, levels=20, bins=48, device=CPU)
    d.load_state_dict(state_from_jax(_numpy_state(ref)))
    more = _latencies(seed=44, n=300)
    d.update(more)
    ref.update(jnp.asarray(more))
    _same_state(d, ref)
    d.reset()
    assert int(d.counts.sum()) == 0 and d.edges.dtype == torch.float32


def test_digest_fill_accounts_for_every_sample():
    d = StreamDigest(device=CPU).update(_latencies(seed=5, n=2048))
    assert int(d.fill().sum()) == 2048 and d.fill().shape == (32,)


def test_digest_in_a_sliced_collection_and_the_engine():
    rng = np.random.default_rng(12)
    batches = [(rng.lognormal(-4, 1, n).astype(np.float32),) for n in (50, 120, 33, 70)]
    col = P.MetricCollection({"lat": StreamDigest(device=CPU)}, bucket=True)
    ref = copy.deepcopy(col)
    Evaluator(col, block_size=2, prefetch=False).run(batches)
    for b in batches:
        ref.fused_update(*b)
    assert torch.equal(col["lat"].counts, ref["lat"].counts)
    assert int(col["lat"].counts.sum()) == 273


# ------------------------------------------------ state_from_jax and labels
def test_state_from_jax_continues_decayed_and_window():
    rng = np.random.default_rng(13)
    first, second = [_batch(rng, n) for n in (25, 31)], [_batch(rng, n) for n in (17, 40)]
    jd = jmon.Decayed(J.MulticlassConfusionMatrix(num_classes=C), decay=0.8)
    jw = jmon.SlidingWindow(J.MulticlassF1Score(num_classes=C, average="macro"), buckets=3)
    for b in first:
        jd.update(*_j(b))
        jw.update(*_j(b))
    jw.advance()
    td = Decayed(P.MulticlassConfusionMatrix(num_classes=C, device=CPU), decay=0.8)
    tw = SlidingWindow(P.MulticlassF1Score(num_classes=C, average="macro", device=CPU),
                       buckets=3)
    td.load_state_dict(state_from_jax(_numpy_state(jd)))
    tw.load_state_dict(state_from_jax(_numpy_state(jw)))
    assert tw.epochs_advanced == 1
    for b in second:
        jd.update(*_j(b))
        jw.update(*_j(b))
        td.update(*b)
        tw.update(*b)
    jw.advance()
    tw.advance()
    _same_state(td, jd)
    _same_state(tw, jw)
    np.testing.assert_array_equal(tw.compute().numpy(), np.asarray(jw.compute()))


def test_window_kind_mapping_and_exports():
    assert tmon.__all__ == jmon.__all__
    assert window_kind(_acc()) == "lifetime"
    assert window_kind(Decayed(_acc(), decay=0.5)) == "decayed"
    assert window_kind(SlidingWindow(_acc(), buckets=2)) == "window"
    assert window_kind(StreamDigest(device=CPU)) == "lifetime"
