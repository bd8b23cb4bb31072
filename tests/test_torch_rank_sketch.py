"""The port's rank-sketch tier (``ops/rank_sketch.py``,
``metrics/_rank_state.py``, ``sketch=True`` on ``BinaryAUROC`` /
``BinaryAUPRC`` / ``MulticlassAUROC``) against the JAX package's on the
same numpy inputs, made from a seed: edges (uniform and ladder), rank
counts with and without a mask and with NaN, every metric's count states
and merges in every order are bit-equal; computed figures agree within
1e-6.  On the CPU the port's update runs its plain version
(``_rank_counts_bincount``); the kernel route's counts
(``binned_counts``' plain version here, ``binned_count.cu`` on the card:
tests/test_torch_cuda.py) are held equal to it.

Mirrors ``tests/metrics/classification/test_rank_sketch.py`` case for case,
at small sizes (<= 2^12 samples, <= 20 classes, 16-64 bins)."""

import itertools
import os
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
from torcheval_tpu.metrics._sketch import RankSketch as JaxRankSketch
from torcheval_tpu.ops import rank_sketch as jrs

import torcheval_tpu_torch.metrics as P
from torcheval_tpu_torch.convert import state_from_jax
from torcheval_tpu_torch.metrics._rank_state import RANK_COUNTS, predicted_epsilon, sketch_census
from torcheval_tpu_torch.metrics._sketch import RankSketch
from torcheval_tpu_torch.ops import _build, _flags as ops_flags
from torcheval_tpu_torch.ops import rank_sketch as trs
from torcheval_tpu_torch.ops._mega_plan import plan_for, route_token

CPU = "cpu"
BINS = 64
TOL = 1e-6


def _stream(seed=0, n=4096):
    """Scores correlated with targets, so the curves carry information."""
    rng = np.random.default_rng(seed)
    scores = rng.random(n).astype(np.float32)
    targets = (rng.random(n) < scores).astype(np.float32)
    return scores, targets


def _mc_stream(seed=0, n=2048, c=4):
    rng = np.random.default_rng(seed)
    logits = rng.random((n, c)).astype(np.float32)
    scores = (logits / logits.sum(axis=1, keepdims=True)).astype(np.float32)
    return scores, rng.integers(0, c, n).astype(np.int32)


def _counts(metric):
    return tuple(np.asarray(getattr(metric, name)) for name in RANK_COUNTS)


def _assert_same_counts(a, b):
    for name, x, y in zip(RANK_COUNTS, _counts(a), _counts(b)):
        np.testing.assert_array_equal(x, y, err_msg=name)


def _pair(jcls, tcls, *batches, **kwargs):
    """The same batches through a JAX and a port sketch-mode metric; the
    counts must be bit-equal."""
    jm = jcls(sketch=True, **kwargs)
    tm = tcls(sketch=True, device=CPU, **kwargs)
    for batch in batches:
        jm.update(*(jnp.asarray(a) for a in batch))
        tm.update(*batch)
    _assert_same_counts(tm, jm)
    np.testing.assert_array_equal(tm.threshold.numpy(), np.asarray(jm.threshold))
    return jm, tm


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=TOL)


# ------------------------------------------------------------ edges and counts
@pytest.mark.parametrize("bins", [16, 33, 64, 512])
def test_uniform_edges_bit_equal_to_jax(bins):
    got = trs.uniform_edges(bins).numpy()
    np.testing.assert_array_equal(got.view(np.int32), np.asarray(jrs.uniform_edges(bins)).view(np.int32))
    assert got.dtype == np.float32 and trs.rank_error_bound(bins) == jrs.rank_error_bound(bins)
    with pytest.raises(ValueError, match="bins"):
        trs.uniform_edges(1)


@pytest.mark.parametrize("base,levels,bins", [(1e-4, 32, 64), (1e-3, 20, 48), (0.37, 9, 100)])
def test_ladder_edges_bit_equal_to_jax(base, levels, bins):
    got = trs.ladder_edges(base, levels, bins).numpy()
    want = np.asarray(jrs.ladder_edges(base, levels, bins))
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_ladder_rejects_bad_geometry():
    for args in ((1e-4, 0, 64), (1e-4, 4, 1), (0.0, 4, 64)):
        with pytest.raises(ValueError):
            trs.ladder_edges(*args)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("nan", [False, True])
def test_rank_counts_bit_equal_to_jax(masked, nan):
    rng = np.random.default_rng(3)
    s = rng.random((3, 1000)).astype(np.float32)
    s[1, :4] = [-np.inf, np.inf, 1.0, 0.0]
    s[2, :6] = trs.uniform_edges(32).numpy()[:6]  # scores equal to edges
    if nan:
        s[0, ::37] = np.nan
    h = rng.random((3, 1000)) < 0.4
    mask = rng.random(1000) < 0.7 if masked else None
    edges = trs.uniform_edges(32)
    want = jrs._rank_counts_bincount(
        jnp.asarray(s), jnp.asarray(h), jnp.asarray(edges.numpy()),
        None if mask is None else jnp.asarray(mask),
    )
    tmask = None if mask is None else torch.from_numpy(mask)
    _build.reset_counts()
    plain = trs.rank_counts_rows(torch.from_numpy(s), torch.from_numpy(h), edges, mask=tmask)
    assert _build.PLAIN_CALLS["rank_counts"] == 1
    kernel_route = trs.rank_counts_rows(
        torch.from_numpy(s), torch.from_numpy(h), edges, route="kernel", mask=tmask
    )
    for w, p, k in zip(want, plain, kernel_route):
        np.testing.assert_array_equal(p.numpy(), np.asarray(w))
        assert torch.equal(p, k) and p.dtype == torch.int32
    if nan:  # a NaN score counts at every edge, in both packages
        assert int(plain[0][0].sum() + plain[1][0].sum()) >= 27 * 32


def test_a_masked_sample_counts_at_no_edge_on_both_routes():
    # The kernel route sees a masked score as -inf, the plain route puts it
    # in cell 0; both equal the counts of the batch without it.
    s = torch.tensor([[0.9, 0.2, float("nan"), 0.6]])
    h = torch.tensor([[True, False, True, True]])
    mask = torch.tensor([1, 1, 0, 0])
    edges = trs.uniform_edges(16)
    dense = trs.rank_counts_rows(s[:, :2], h[:, :2], edges)
    for route in ("bincount", "kernel"):
        got = trs.rank_counts_rows(s, h, edges, route=route, mask=mask)
        for g, d in zip(got, dense):
            assert torch.equal(g, d)


def test_the_plain_version_takes_cpu_tensors_only():
    meta = torch.empty((1, 8), device="meta")
    with pytest.raises(ValueError, match="CPU tensors only"):
        trs.rank_counts_rows(meta, meta.bool(), trs.uniform_edges(16), route="bincount")
    with pytest.raises(ValueError, match="cuda or cpu"):
        trs._select_rank_route(8, meta)
    assert trs._select_rank_route(8, trs.uniform_edges(16)) == "bincount"
    with pytest.raises(ValueError, match="route"):
        trs.rank_counts_rows(torch.zeros(1, 4), torch.zeros(1, 4, dtype=torch.bool),
                             trs.uniform_edges(16), route="broadcast")


def test_ladder_counts_quantiles_and_fill_bit_equal_to_jax():
    rng = np.random.default_rng(4)
    v = rng.lognormal(-4.0, 1.5, 3000).astype(np.float32)
    v[:3] = [np.nan, -1.0, 1e9]
    mask = rng.random(3000) < 0.8
    edges = trs.ladder_edges(1e-4, 32, 64)
    jedges = jnp.asarray(edges.numpy())
    for m in (None, mask):
        want = np.asarray(jrs.ladder_counts(jnp.asarray(v), jedges, None if m is None else jnp.asarray(m)))
        got = trs.ladder_counts(torch.from_numpy(v), edges, None if m is None else torch.from_numpy(m))
        np.testing.assert_array_equal(got.numpy(), want)
        qs = (0.01, 0.5, 0.9, 0.99, 1.0)
        np.testing.assert_array_equal(
            trs.ladder_quantiles(got, edges, qs).numpy(),
            np.asarray(jrs.ladder_quantiles(jnp.asarray(want), jedges, qs)),
        )
        np.testing.assert_array_equal(
            trs.ladder_fill(got, 32).numpy(), np.asarray(jrs.ladder_fill(jnp.asarray(want), 32))
        )


# ------------------------------------------------- the JAX suite, case for case
@pytest.mark.parametrize("bins", [16, BINS])
def test_binary_auroc_within_eps(bins):
    scores, targets = _stream(seed=1)
    jm, sketch = _pair(J.BinaryAUROC, P.BinaryAUROC, (scores, targets), sketch_bins=bins)
    exact = P.BinaryAUROC(device=CPU).update(scores, targets)
    err = abs(float(sketch.compute()) - float(exact.compute()))
    assert err <= trs.rank_error_bound(bins) == predicted_epsilon(sketch)
    _close(sketch.compute(), jm.compute())


def test_binary_auprc_within_eps():
    scores, targets = _stream(seed=2)
    jm, sketch = _pair(J.BinaryAUPRC, P.BinaryAUPRC, (scores, targets), sketch_bins=BINS)
    exact = P.BinaryAUPRC(device=CPU).update(scores, targets)
    assert abs(float(sketch.compute()) - float(exact.compute())) <= trs.rank_error_bound(BINS)
    _close(sketch.compute(), jm.compute())


@pytest.mark.parametrize("average", ["macro", None])
def test_multiclass_auroc_within_eps(average):
    scores, targets = _mc_stream(seed=3, n=4096, c=20)
    jm, sketch = _pair(J.MulticlassAUROC, P.MulticlassAUROC, (scores, targets),
                       num_classes=20, average=average, sketch_bins=BINS)
    exact = P.MulticlassAUROC(num_classes=20, average=average, device=CPU).update(scores, targets)
    err = (sketch.compute() - exact.compute()).abs().max()
    assert float(err) <= trs.rank_error_bound(BINS)
    _close(sketch.compute(), jm.compute())


def test_streamed_equals_one_shot():
    scores, targets = _stream(seed=4)
    one = P.BinaryAUROC(sketch=True, sketch_bins=BINS, device=CPU).update(scores, targets)
    chunks = [(scores[lo:lo + 512], targets[lo:lo + 512]) for lo in range(0, 4096, 512)]
    _, chunked = _pair(J.BinaryAUROC, P.BinaryAUROC, *chunks, sketch_bins=BINS)
    _assert_same_counts(one, chunked)
    assert float(one.compute()) == float(chunked.compute())


def _shards(lib, k=4, **dev):
    out = []
    for i in range(k):
        m = lib.BinaryAUROC(sketch=True, sketch_bins=BINS, **dev)
        s, t = _stream(seed=10 + i, n=777)
        if lib is J:
            s, t = jnp.asarray(s), jnp.asarray(t)
        out.append(m.update(s, t))
    return out


def _fold(lib, order, **dev):
    shards = _shards(lib, **dev)
    root = lib.BinaryAUROC(sketch=True, sketch_bins=BINS, **dev)
    s, t = _stream(seed=99, n=333)
    root.update(*((jnp.asarray(s), jnp.asarray(t)) if lib is J else (s, t)))
    for i in order:
        root.merge_state([shards[i]])
    return root


def test_all_merge_orders_bit_identical():
    reference = _fold(J, (0, 1, 2, 3))
    for order in itertools.permutations(range(4)):
        folded = _fold(P, order, device=CPU)
        _assert_same_counts(folded, reference)
        _close(folded.compute(), reference.compute())


def test_tree_vs_flat_split():
    flat = _shards(P, device=CPU)
    flat[0].merge_state(flat[1:])
    tree = _shards(P, device=CPU)
    tree[0].merge_state([tree[1]])
    tree[2].merge_state([tree[3]])
    tree[0].merge_state([tree[2]])
    _assert_same_counts(flat[0], tree[0])


def test_merge_rejects_buffer_operand():
    sketch = P.BinaryAUROC(sketch=True, device=CPU)
    buffer = P.BinaryAUROC(device=CPU).update(*_stream(seed=0, n=32))
    with pytest.raises(ValueError, match="sample-buffer"):
        sketch.merge_state([buffer])


def test_merge_rejects_bins_mismatch():
    a = P.BinaryAUROC(sketch=True, sketch_bins=16, device=CPU)
    b = P.BinaryAUROC(sketch=True, sketch_bins=32, device=CPU)
    with pytest.raises(ValueError, match="edge geometry"):
        a.merge_state([b])


@pytest.mark.parametrize("multiclass", [False, True])
def test_mask_equals_dropping_samples(multiclass):
    if multiclass:
        scores, targets = _mc_stream(seed=5, n=1024, c=6)
        jcls, tcls, kw = J.MulticlassAUROC, P.MulticlassAUROC, {"num_classes": 6}
    else:
        scores, targets = _stream(seed=5, n=1024)
        jcls, tcls, kw = J.BinaryAUROC, P.BinaryAUROC, {}
    mask = np.arange(1024) % 3 != 0
    jm = jcls(sketch=True, sketch_bins=BINS, **kw)
    jm.update(jnp.asarray(scores), jnp.asarray(targets), mask=jnp.asarray(mask))
    masked = tcls(sketch=True, sketch_bins=BINS, device=CPU, **kw)
    masked.update(scores, targets, mask=mask)
    dense = tcls(sketch=True, sketch_bins=BINS, device=CPU, **kw).update(scores[mask], targets[mask])
    _assert_same_counts(masked, dense)
    _assert_same_counts(masked, jm)


def test_buffer_mode_mask_raises():
    scores, targets = _stream(seed=0, n=16)
    for cls in (P.BinaryAUROC, P.BinaryAUPRC):
        with pytest.raises(ValueError, match="sketch=True"):
            cls(device=CPU).update(scores, targets, mask=np.ones(16, bool))
    with pytest.raises(ValueError, match="sketch=True"):
        P.MulticlassAUROC(num_classes=4, device=CPU).update(
            *_mc_stream(n=16), mask=np.ones(16, bool))


def test_sketch_plus_fused_raises():
    with pytest.raises(ValueError, match="use_fused"):
        P.BinaryAUROC(sketch=True, use_fused=True, device=CPU)


def test_rank_kind_round_trips_counts():
    m = P.BinaryAUROC(sketch=True, sketch_bins=BINS, device=CPU).update(*_stream(seed=6, n=2048))
    sk = m.sketch_state("rank")
    assert isinstance(sk, RankSketch)
    np.testing.assert_array_equal(sk.num_tp, m.num_tp.numpy())
    assert float(sk.compute()) == float(m.compute())
    assert m.sketch_state("exact").nbytes() == sk.nbytes()


def test_payload_is_o_compactors():
    small = P.BinaryAUROC(sketch=True, device=CPU).update(*_stream(seed=7, n=128))
    big = P.BinaryAUROC(sketch=True, device=CPU).update(*_stream(seed=7, n=4096))
    assert small.sketch_state("rank").nbytes() == big.sketch_state("rank").nbytes()
    jm = J.BinaryAUROC(sketch=True)
    jm.update(*(jnp.asarray(a) for a in _stream(seed=7, n=4096)))
    assert big.sketch_state("rank").nbytes() == jm.sketch_state("rank").nbytes()


def test_sample_kinds_rejected_on_sketch_mode():
    m = P.BinaryAUROC(sketch=True, device=CPU)
    for kind in ("reservoir", "histogram", "count"):
        with pytest.raises(ValueError):
            m.sketch_state(kind)
    with pytest.raises(ValueError, match="no options"):
        m.sketch_state("rank", bins=64)


def test_host_built_sketch_is_bit_parity_with_device():
    scores, targets = _stream(seed=8)
    jm, m = _pair(J.BinaryAUROC, P.BinaryAUROC, (scores, targets), sketch_bins=BINS)
    host = RankSketch.from_samples("binary_auroc", scores, targets, bins=BINS, device=CPU)
    jhost = JaxRankSketch.from_samples("binary_auroc", scores, targets, bins=BINS)
    for name in ("edges", "num_tp", "num_fp", "num_pos", "num_total"):
        np.testing.assert_array_equal(getattr(host, name), getattr(jhost, name))
    np.testing.assert_array_equal(host.num_tp, m.num_tp.numpy())
    np.testing.assert_array_equal(host.num_fp, m.num_fp.numpy())
    assert float(host.compute()) == float(m.compute())


def test_merged_sketches_match_merged_metrics():
    a = P.BinaryAUROC(sketch=True, device=CPU).update(*_stream(seed=20, n=1500))
    b = P.BinaryAUROC(sketch=True, device=CPU).update(*_stream(seed=21, n=1500))
    merged = a.sketch_state("rank").merge(b.sketch_state("rank"))
    a.merge_state([b])
    assert float(merged.compute()) == float(a.compute())


def test_kill_and_resume_bit_identity():
    scores, targets = _stream(seed=9)
    straight = P.BinaryAUROC(sketch=True, device=CPU)
    straight.update(scores[:2048], targets[:2048]).update(scores[2048:], targets[2048:])
    killed = P.BinaryAUROC(sketch=True, device=CPU).update(scores[:2048], targets[:2048])
    snapshot = {k: v.numpy() for k, v in killed.state_dict().items()}
    del killed
    resumed = P.BinaryAUROC(sketch=True, device=CPU)
    resumed.load_state_dict(state_from_jax(snapshot))
    resumed.update(scores[2048:], targets[2048:])
    _assert_same_counts(straight, resumed)
    assert float(straight.compute()) == float(resumed.compute())


@pytest.mark.parametrize("which", ["binary_auroc", "binary_auprc", "multiclass_auroc"])
def test_state_from_jax_continues_a_jax_sketch(which):
    # A JAX sketch-mode metric's state_dict, through numpy, continues in the
    # port bit for bit.
    if which == "multiclass_auroc":
        first, second = _mc_stream(seed=30, n=1000, c=5), _mc_stream(seed=31, n=700, c=5)
        jcls, tcls, kw = J.MulticlassAUROC, P.MulticlassAUROC, {"num_classes": 5}
    else:
        first, second = _stream(seed=30, n=1000), _stream(seed=31, n=700)
        jcls, tcls = (J.BinaryAUROC, P.BinaryAUROC) if which == "binary_auroc" else (
            J.BinaryAUPRC, P.BinaryAUPRC)
        kw = {}
    jm = jcls(sketch=True, sketch_bins=32, **kw)
    jm.update(*(jnp.asarray(a) for a in first))
    tm = tcls(sketch=True, sketch_bins=32, device=CPU, **kw)
    tm.load_state_dict(state_from_jax({k: np.asarray(v) for k, v in jm.state_dict().items()}))
    jm.update(*(jnp.asarray(a) for a in second))
    tm.update(*second)
    _assert_same_counts(tm, jm)
    _close(tm.compute(), jm.compute())


def test_collection_fold_bit_identical():
    # A sketch-mode binary member plans as the collection kernel's "binned"
    # kind (its plain version on the CPU) and folds the bits of its own
    # update; the JAX collection (megakernel on, interpret mode) agrees.
    scores, targets = _stream(seed=11, n=2048)
    targets = targets.astype(np.int32)
    solo_roc = P.BinaryAUROC(sketch=True, sketch_bins=BINS, device=CPU).update(scores, targets)
    solo_prc = P.BinaryAUPRC(sketch=True, sketch_bins=BINS, device=CPU).update(scores, targets)
    env = {"TORCHEVAL_TPU_MEGAKERNEL": "1", "TORCHEVAL_TPU_TORCH_MEGAKERNEL": "1"}
    with mock.patch.dict(os.environ, env):
        members = {"roc": P.BinaryAUROC(sketch=True, sketch_bins=BINS, device=CPU),
                   "prc": P.BinaryAUPRC(sketch=True, sketch_bins=BINS, device=CPU)}
        plan = plan_for(members, (torch.from_numpy(scores), torch.from_numpy(targets)), {}, None)
        assert [mp.kind for mp in plan.members] == ["binned", "binned"]
        col = P.MetricCollection(members)
        _build.reset_counts()
        col.fused_update(scores, targets)
        assert _build.PLAIN_CALLS["mega_counts"] == 1 and not _build.PLAIN_CALLS["rank_counts"]
        jcol = J.MetricCollection({"roc": J.BinaryAUROC(sketch=True, sketch_bins=BINS),
                                   "prc": J.BinaryAUPRC(sketch=True, sketch_bins=BINS)},
                                  donate=False)
        jcol.fused_update(jnp.asarray(scores), jnp.asarray(targets))
    _assert_same_counts(solo_roc, col["roc"])
    _assert_same_counts(solo_prc, col["prc"])
    _assert_same_counts(col["roc"], jcol["roc"])
    out = col.compute()
    assert float(out["roc"]) == float(solo_roc.compute())
    assert float(out["prc"]) == float(solo_prc.compute())


def test_plan_declines_a_multirow_sketch_member():
    members = {"mc": P.MulticlassAUROC(num_classes=4, sketch=True, device=CPU),
               "wide": P.BinaryAUROC(sketch=True, sketch_bins=513, device=CPU)}
    with mock.patch.dict(os.environ, {"TORCHEVAL_TPU_TORCH_MEGAKERNEL": "1"}):
        plan = plan_for(members, (torch.rand(8), torch.zeros(8, dtype=torch.int32)), {}, None)
    assert plan is None  # neither member is supported


def test_rank_sketch_mode_in_token(monkeypatch):
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_RANK_SKETCH", "1")
    on = route_token()
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_RANK_SKETCH", "0")
    off = route_token()
    assert on[-1] is True and off[-1] is False and on != off
    monkeypatch.setenv("TORCHEVAL_TPU_RANK_SKETCH", "1")  # the JAX switch
    monkeypatch.delenv("TORCHEVAL_TPU_TORCH_RANK_SKETCH")
    assert ops_flags.rank_sketch_mode() is None and not ops_flags.rank_sketch_enabled()


def test_env_flag_engages_sketch_mode(monkeypatch):
    before = sketch_census().get("members_constructed", 0)
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_RANK_SKETCH", "1")
    for m in (P.BinaryAUROC(device=CPU), P.BinaryAUPRC(device=CPU),
              P.MulticlassAUROC(num_classes=3, device=CPU)):
        assert m._sketch_mode and m._supports_mask
    assert not P.BinaryAUROC(sketch=False, device=CPU)._sketch_mode
    census = sketch_census()
    assert census["members_constructed"] == before + 3
    assert census["predicted_eps_max"] >= trs.rank_error_bound(trs.DEFAULT_BINS)
