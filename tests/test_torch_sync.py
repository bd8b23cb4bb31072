"""``torcheval_tpu_torch.parallel`` (mesh and sync) against the JAX
package's ``parallel`` on a k-device CPU mesh (the root ``conftest.py``
gives JAX 8 CPU devices).  The port runs over ``LocalWorld(k)``: every
rank is a thread, passes its ``shard_batch`` block of the same global
numpy-seeded arrays, and must return the same result.

Tolerances: merged counts bit for bit equal to the JAX counts of the
whole array; weighted sums within 1e-6 of the JAX weighted kernel (run in
interpret mode) relative to the sum of |w| a cell; AUROC and AP within
1e-6.  The JAX public functions take the scatter or binned-counts route on
the CPU; ``_grid_np`` makes those set-identical to the kernels' counts."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu import parallel as jpar
from torcheval_tpu.metrics.functional.classification._sort_scan import (
    class_hits as jax_class_hits,
)
from torcheval_tpu.metrics.functional.classification.accuracy import (
    _multiclass_accuracy_update_kernel as jax_accuracy_update,
)
from torcheval_tpu.metrics.functional.classification.binned_auc import (
    _binned_counts_rows as jax_counts_rows,
)
from torcheval_tpu.ops.pallas_binned import _pallas_binned_weighted_counts_jit
from torcheval_tpu.parallel.sync import _grid_np as jax_grid_np
from torcheval_tpu_torch import parallel as tpar
from torcheval_tpu_torch.distributed import LocalWorld
from torcheval_tpu_torch.metrics import BinaryAUROC, toolkit
from torcheval_tpu_torch.metrics.functional._host_checks import skip_value_checks
from torcheval_tpu_torch.metrics.functional.classification._sort_scan import class_hits
from torcheval_tpu_torch.metrics.functional.classification.accuracy import (
    _multiclass_accuracy_update_kernel,
)
from torcheval_tpu_torch.ops import _build
from torcheval_tpu_torch.parallel import sync as tsync

TOL = 1e-6
# (world size, mesh shape, axis names); the port's axis is every name.
MESHES = [(4, (4,), ("dp",)), (8, (4, 2), ("dp", "sp"))]


def _axis(names):
    return names[0] if len(names) == 1 else names


def _run(world, shape, names, fn):
    """``fn(mesh)`` on every rank of ``LocalWorld(world)``; the ranks'
    results, which must all be the same."""

    def rank_fn(group, rank):
        return fn(tpar.make_mesh(shape, names, group=group))

    out = LocalWorld(world).run(rank_fn)
    for other in out[1:]:
        for a, b in zip(torch.utils._pytree.tree_leaves(out[0]),
                        torch.utils._pytree.tree_leaves(other)):
            assert torch.equal(a, b)
    return out[0]


def _jax_mesh(shape, names):
    return jpar.make_mesh(shape, names)


def _shards(mesh, names, *arrays):
    return tpar.shard_batch(mesh, *(torch.from_numpy(a) for a in arrays), axis=_axis(names))


def _binary_data(seed, n, soft=False):
    rng = np.random.default_rng(seed)
    s = rng.random(n).astype(np.float32)
    t = (rng.random(n) < 0.4).astype(np.float32)
    if soft:
        t = rng.choice(np.array([0.0, 0.25, 0.5, 1.0], np.float32), size=n)
    w = (rng.random(n) * 2 + 0.1).astype(np.float32)
    return s, t, w


@pytest.mark.parametrize("num_bins", [1, 2, 7, 100, 256, 512, 1000, 2048, 8192, 16384])
def test_grid_bitwise_with_jax(num_bins):
    got, want = tsync._grid_np(num_bins), jax_grid_np(num_bins)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("world,shape,names", MESHES)
@pytest.mark.parametrize("kind", ["unweighted", "weighted", "soft", "soft-weighted"])
def test_binary_histograms_match_jax(world, shape, names, kind):
    s, t, w = _binary_data(world + len(kind), 2048, soft=kind.startswith("soft"))
    weighted = kind.endswith("weighted")
    jm = _jax_mesh(shape, names)
    js, jt, jw = jpar.shard_batch(jm, jnp.asarray(s), jnp.asarray(t), jnp.asarray(w),
                                  axis=_axis(names))
    kw = {"weights": jw} if weighted else {}
    want = [float(jpar.sharded_auroc_histogram(js, jt, jm, axis=_axis(names), num_bins=512, **kw)),
            float(jpar.sharded_auprc_histogram(js, jt, jm, axis=_axis(names), num_bins=512, **kw))]

    def fn(mesh):
        ps, pt, pw = _shards(mesh, names, s, t, w)
        kw = {"weights": pw} if weighted else {}
        return [tpar.sharded_auroc_histogram(ps, pt, mesh, axis=_axis(names), num_bins=512, **kw),
                tpar.sharded_auprc_histogram(ps, pt, mesh, axis=_axis(names), num_bins=512, **kw)]

    _build.reset_counts()
    got = _run(world, shape, names, fn)
    route = "binned_weighted_counts" if weighted else "binned_counts"
    if kind.startswith("soft"):  # the scatter route: no kernel, no plain version
        assert not _build.PLAIN_CALLS
    else:  # each rank's local stage, once for AUROC and once for AP
        assert dict(_build.PLAIN_CALLS) == {route: 2 * world}
    assert not _build.LAUNCHES
    for g, x in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == ()
        assert abs(float(g) - x) <= TOL, (float(g), x)


@pytest.mark.parametrize("world,shape,names", MESHES)
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("average", [None, "macro"])
def test_multiclass_histogram_matches_jax(world, shape, names, weighted, average):
    rng = np.random.default_rng(world * 10 + weighted)
    n, c = 1024, 6
    s = rng.random((n, c)).astype(np.float32)
    t = rng.integers(0, c, n).astype(np.int32)
    w = (rng.random(n) + 0.5).astype(np.float32)
    jm = _jax_mesh(shape, names)
    js, jt, jw = jpar.shard_batch(jm, jnp.asarray(s), jnp.asarray(t), jnp.asarray(w),
                                  axis=_axis(names))
    kw = {"weights": jw} if weighted else {}
    want = np.asarray(jpar.sharded_multiclass_auroc_histogram(
        js, jt, jm, axis=_axis(names), num_bins=256, average=average, **kw))

    def fn(mesh):
        ps, pt, pw = _shards(mesh, names, s, t, w)
        kw = {"weights": pw} if weighted else {}
        return tpar.sharded_multiclass_auroc_histogram(
            ps, pt, mesh, axis=_axis(names), num_bins=256, average=average, **kw)

    got = _run(world, shape, names, fn)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


def test_merged_counts_bitwise_and_weighted_sums_within_tolerance():
    # The kernels' route itself: each rank's local counts merged with
    # mesh_merge_states, against the JAX counts and the JAX weighted
    # kernel (interpret mode) on the whole array.
    rng = np.random.default_rng(9)
    n, c, bins = 2048, 5, 300
    s = rng.random((n, c)).astype(np.float32)
    t = rng.integers(0, c, n).astype(np.int32)
    w = ((rng.random(n) - 0.3) * 4).astype(np.float32)
    grid = jnp.asarray(jax_grid_np(bins))
    hits = jax_class_hits(jnp.asarray(t), c)
    want_tp, want_fp, _, _ = jax_counts_rows(jnp.asarray(s).T, hits, grid)
    want_w = _pallas_binned_weighted_counts_jit(jnp.asarray(s).T, hits, jnp.asarray(w), grid,
                                                interpret=True, split3=True)
    scale = _pallas_binned_weighted_counts_jit(jnp.asarray(s).T, hits, jnp.abs(jnp.asarray(w)),
                                               grid, interpret=True, split3=True)

    def fn(mesh):
        ps, pt, pw = _shards(mesh, ("dp",), s, t, w)
        hits = class_hits(pt, c)
        counts = tsync._counts_local(ps.T, hits, None, bins)
        sums = tsync._counts_local(ps.T, hits, pw, bins)
        return tsync.mesh_merge_states({"counts": counts, "sums": sums}, "dp", mesh=mesh)

    got = _run(4, (4,), ("dp",), fn)
    for g, x in zip(got["counts"], (want_tp, want_fp)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(x))
    for g, x, a in zip(got["sums"], want_w[:2], scale[:2]):
        assert np.all(np.abs(g.numpy() - np.asarray(x)) <= TOL * np.asarray(a) + 1e-30)


def test_weighted_ones_bitwise_equal_unweighted_on_bin_edges():
    grid = jax_grid_np(1000)
    rng = np.random.default_rng(3)
    edges = np.concatenate([grid, np.nextafter(grid, 0), np.nextafter(grid, 1)])
    s = np.clip(np.concatenate([edges, rng.random(8192 - len(edges)).astype(np.float32)]),
                0.0, 1.0).astype(np.float32)
    t = (rng.random(8192) < 0.4).astype(np.float32)

    def fn(mesh):
        ps, pt = _shards(mesh, ("dp",), s, t)
        ones = torch.ones_like(ps)
        return [f(ps, pt, mesh, num_bins=1000, weights=wt)
                for f in (tpar.sharded_auroc_histogram, tpar.sharded_auprc_histogram)
                for wt in (None, ones)]

    au, au_w, ap, ap_w = _run(4, (4,), ("dp",), fn)
    assert torch.equal(au, au_w) and torch.equal(ap, ap_w)


def test_out_of_range_scores_raise_on_every_rank():
    s, t, _ = _binary_data(1, 64)
    s[5] = 1.5  # on rank 0's shard only

    def fn(mesh):
        ps, pt = _shards(mesh, ("dp",), s, t)
        errors = []
        for call in (lambda: tpar.sharded_auroc_histogram(ps, pt, mesh),
                     lambda: tpar.sharded_auprc_histogram(ps, pt, mesh, assume_01_targets=True),
                     lambda: tpar.sharded_multiclass_auroc_histogram(
                         torch.stack([ps, 1 - ps], 1), pt.to(torch.int64), mesh)):
            with pytest.raises(ValueError, match=r"should be in the range of \[0, 1\] for "
                               "histogram-binned curve metrics, got min .* max 1.5"):
                call()
            errors.append(True)
        return torch.tensor(errors)

    assert bool(_run(4, (4,), ("dp",), fn).all())
    with pytest.raises(ValueError, match="range of"):
        jpar.sharded_auroc_histogram(jnp.asarray(s), jnp.asarray(t), jpar.make_mesh(1))
    with skip_value_checks():  # no read back: the scatter route, no error
        m = tpar.make_mesh()
        tpar.sharded_auroc_histogram(torch.from_numpy(s), torch.from_numpy(t), m)


@pytest.mark.parametrize("weighted", [False, True])
def test_binary_route_under_skip_value_checks(weighted):
    """0/1 targets take the kernels' route when the gate reads them; under
    ``skip_value_checks`` the gate reads nothing and the scatter runs, as
    in JAX, unless ``assume_01_targets=True`` pins the kernels."""
    s, t, w = _binary_data(9, 4096)
    s, t = torch.from_numpy(s), torch.from_numpy(t)
    w = torch.from_numpy(w) if weighted else None
    kernel = "binned_weighted_counts" if weighted else "binned_counts"
    mesh = tpar.make_mesh()
    _build.reset_counts()
    checked = tpar.sharded_auroc_histogram(s, t, mesh, num_bins=256, weights=w)
    assert dict(_build.PLAIN_CALLS) == {kernel: 1}
    with skip_value_checks():
        _build.reset_counts()
        scattered = tpar.sharded_auroc_histogram(s, t, mesh, num_bins=256, weights=w)
        assert not _build.PLAIN_CALLS
        pinned = tpar.sharded_auroc_histogram(s, t, mesh, num_bins=256, weights=w,
                                              assume_01_targets=True)
        assert dict(_build.PLAIN_CALLS) == {kernel: 1}
    assert torch.equal(pinned, checked)
    assert abs(float(scattered) - float(checked)) <= TOL


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int32, torch.bool])
def test_score_range_check_in_the_scores_own_dtype(dtype):
    """The world's min / max are taken in the scores' dtype and only the
    two scalars widened: the same route and value as f32 scores."""
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 2, 512) if dtype in (torch.int32, torch.bool) else rng.random(512)
    s = torch.from_numpy(raw).to(dtype)
    t = torch.from_numpy((rng.random(512) < 0.5).astype(np.float32))
    mesh = tpar.make_mesh()
    want = tpar.sharded_auroc_histogram(s.to(torch.float32), t, mesh, num_bins=64)
    assert torch.equal(tpar.sharded_auroc_histogram(s, t, mesh, num_bins=64), want)
    with pytest.raises(ValueError, match=r"range of \[0, 1\]"):
        tpar.sharded_auroc_histogram(s * 2 + 1, t, mesh, num_bins=64)


def test_shape_errors_and_empty_input():
    m = tpar.make_mesh()
    with pytest.raises(ValueError, match="1-D"):
        tpar.sharded_auprc_histogram(torch.ones(2, 2), torch.ones(2, 2), m)
    with pytest.raises(ValueError, match=r"\(N, C\)"):
        tpar.sharded_multiclass_auroc_histogram(torch.ones(4), torch.ones(4), m)
    empty = torch.zeros(0)
    assert float(tpar.sharded_auroc_histogram(empty, empty, m, num_bins=16)) == 0.5
    assert float(tpar.sharded_auprc_histogram(empty, empty, m, num_bins=16)) == 0.0
    zeros = torch.zeros(32)
    assert float(tpar.sharded_auprc_histogram(torch.rand(32), zeros, m, num_bins=64)) == 0.0


@pytest.mark.parametrize("how", ["sum", "max", "min", "mean", "concat"])
def test_make_synced_update_matches_jax(how):
    rng = np.random.default_rng(2)
    scores = rng.random((64, 5)).astype(np.float32)
    target = rng.integers(0, 5, 64).astype(np.int32)
    jm = jpar.make_mesh(4)
    jstep = jpar.make_synced_update(
        lambda s, t: jax_accuracy_update(s, t, "macro", 5, 1), jm, reductions=how)
    want = jstep(*jpar.shard_batch(jm, jnp.asarray(scores), jnp.asarray(target)))

    def fn(mesh):
        step = tpar.make_synced_update(
            lambda s, t: _multiclass_accuracy_update_kernel(s, t, "macro", 5, 1), mesh,
            reductions=how)
        return step(*_shards(mesh, ("dp",), scores, target))

    got = _run(4, (4,), ("dp",), fn)
    for g, x in zip(got, want):
        x = np.asarray(x)
        assert g.dtype == torch.from_numpy(np.array(x)).dtype, (how, g.dtype, x.dtype)
        np.testing.assert_array_equal(g.numpy(), x)
    # One rank's update on the whole batch, for the counters.
    if how == "sum":
        whole = _multiclass_accuracy_update_kernel(
            torch.from_numpy(scores), torch.from_numpy(target), "macro", 5, 1)
        assert all(torch.equal(a, b) for a, b in zip(got, whole))


@pytest.mark.parametrize("op", ["sum", "max", "min", "mean", "concat"])
@pytest.mark.parametrize("dtype", [np.int32, np.float32])
def test_group_all_reduce_against_numpy(op, dtype):
    """``CollectiveGroup.all_reduce`` and ``all_reduce_many`` (the one the
    sharded functions call) on ``LocalWorld(3)``: every rank the same bits,
    folded in rank order, integers kept integer."""
    rng = np.random.default_rng(11)
    parts = [(rng.random((4, 3)) * 100 - 50).astype(dtype) for _ in range(3)]
    extra = [np.arange(5, dtype=np.int64) * (r + 1) for r in range(3)]

    def fn(group, rank):
        one = group.all_reduce(torch.from_numpy(parts[rank]), op)
        many = group.all_reduce_many(
            [torch.from_numpy(parts[rank]), torch.from_numpy(extra[rank])], [op, "sum"])
        return one, many

    out = LocalWorld(3).run(fn)
    for one, many in out:
        assert torch.equal(one, out[0][0]) and torch.equal(many[0], one)
        np.testing.assert_array_equal(many[1].numpy(), extra[0] * 6)
        assert many[1].dtype == torch.int64
    got = out[0][0]
    if op == "concat":
        want = np.concatenate(parts)
    elif op == "max":
        want = np.maximum(np.maximum(parts[0], parts[1]), parts[2])
    elif op == "min":
        want = np.minimum(np.minimum(parts[0], parts[1]), parts[2])
    else:
        want = (parts[0] + parts[1]) + parts[2]
        if op == "mean":
            want = torch.from_numpy(want) / 3
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == (torch.float32 if op == "mean" else torch.from_numpy(parts[0]).dtype)
    single = tpar.make_mesh().group
    assert torch.equal(single.all_reduce(torch.from_numpy(parts[0]), op),
                       torch.from_numpy(parts[0]) / 1 if op == "mean"
                       else torch.from_numpy(parts[0]))
    with pytest.raises(ValueError, match="Unknown reduction"):
        single.all_reduce(torch.ones(2), "prod")
    with pytest.raises(ValueError, match="2 tensors but 1"):
        single.all_reduce_many([torch.ones(2), torch.ones(2)], ["sum"])


def test_mesh_merge_states_trees_and_jax_shard_map():
    data = np.arange(24, dtype=np.float32)

    def fn(mesh):
        (x,) = (_shards(mesh, ("dp",), data),)
        states = {"n": x.sum(), "ext": (x.max(), x.min()), "buf": [x * 2]}
        return tpar.mesh_merge_states(
            states, "dp", {"n": "sum", "ext": ("max", "min"), "buf": "concat"}, mesh=mesh)

    got = _run(4, (4,), ("dp",), fn)
    assert float(got["n"]) == 276.0
    assert float(got["ext"][0]) == 23.0 and float(got["ext"][1]) == 0.0
    assert isinstance(got["ext"], tuple) and isinstance(got["buf"], list)
    np.testing.assert_array_equal(got["buf"][0].numpy(), data * 2)
    with pytest.raises(ValueError, match="Unknown reduction"):
        tpar.mesh_merge_states({"n": torch.ones(2)}, "dp", "prod", mesh=tpar.make_mesh())


def test_sub_axis_and_retry_raise():
    # A reduction over one axis of a 2-D mesh runs in the sub-group of the
    # ranks that share the other coordinate, as a JAX collective over that
    # axis does inside shard_map: each slice merges the whole batch.
    rng = np.random.default_rng(5)
    scores = rng.random((64, 5)).astype(np.float32)
    target = rng.integers(0, 5, 64).astype(np.int32)
    s, t, _ = _binary_data(9, 2048)
    jm = _jax_mesh((4, 2), ("dp", "sp"))
    for axis in ("dp", "sp"):
        jstep = jpar.make_synced_update(
            lambda a, b: jax_accuracy_update(a, b, "macro", 5, 1), jm, axis=axis)
        want = jstep(*jpar.shard_batch(jm, jnp.asarray(scores), jnp.asarray(target), axis=axis))
        js, jt = jpar.shard_batch(jm, jnp.asarray(s), jnp.asarray(t), axis=axis)
        want_auc = float(jpar.sharded_auroc_histogram(js, jt, jm, axis=axis, num_bins=512))

        def fn(mesh):
            step = tpar.make_synced_update(
                lambda a, b: _multiclass_accuracy_update_kernel(a, b, "macro", 5, 1), mesh,
                axis=axis)
            ps, pt = _shards(mesh, (axis,), s, t)
            return [*step(*_shards(mesh, (axis,), scores, target)),
                    tpar.sharded_auroc_histogram(ps, pt, mesh, axis=axis, num_bins=512)]

        got = _run(8, (4, 2), ("dp", "sp"), fn)
        for g, x in zip(got[:-1], want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(x))
        assert abs(float(got[-1]) - want_auc) <= TOL, (float(got[-1]), want_auc)

    # The names in another order: every rank, ranked by the ("sp", "dp")
    # block index, so the concatenation puts the blocks back in order.
    data = torch.arange(8.0)
    got = _run(4, (2, 2), ("dp", "sp"), lambda mesh: tpar.mesh_merge_states(
        tpar.shard_batch(mesh, data, axis=("sp", "dp")), ("sp", "dp"), "concat", mesh=mesh))
    assert torch.equal(got, data)
    # retry= no longer raises: a retried synced update gives the bits of
    # the plain one (tests/test_torch_resilience.py drives its faults).
    from torcheval_tpu_torch.resilience import RetryPolicy

    x = torch.arange(6.0)
    plain = tpar.make_synced_update(lambda v: v * 2, tpar.make_mesh())(x)
    retried = tpar.make_synced_update(lambda v: v * 2, tpar.make_mesh(), retry=RetryPolicy())(x)
    assert torch.equal(retried, plain)


def test_shard_batch_and_bucket_shard_batch():
    data = torch.arange(12).reshape(6, 2)

    def fn(mesh):
        rows = tpar.shard_batch(mesh, data, axis=("dp", "sp"))
        cols = tpar.shard_batch(mesh, data, axis="dp", dim=1)
        return rows, cols

    out = LocalWorld(2).run(lambda g, r: fn(tpar.make_mesh((2, 1), ("dp", "sp"), group=g)))
    assert torch.equal(out[1][0], data[3:]) and torch.equal(out[0][1], data[:, :1])
    with pytest.raises(ValueError, match="does not divide"):
        LocalWorld(4).run(lambda g, r: tpar.shard_batch(tpar.make_mesh(group=g), data))
    with pytest.raises(ValueError, match="needs a world of 4"):
        tpar.make_mesh(4)
    m = tpar.make_mesh()
    assert tpar.shard_batch(m, data) is not data and torch.equal(tpar.shard_batch(m, data), data)
    assert tpar.replicate(m, {"a": data})["a"] is data
    assert tpar.device_count() == torch.cuda.device_count()

    ragged = torch.arange(10, dtype=torch.float32)

    def bucketed(group, rank):
        (x,), mask = tpar.bucket_shard_batch(tpar.make_mesh(group=group), ragged, min_bucket=4)
        return x, mask

    out = LocalWorld(3).run(bucketed)
    xs = torch.cat([x for x, _ in out])
    masks = torch.cat([mk for _, mk in out])
    assert xs.numel() == 18 and int(masks.sum()) == 10  # bucket 16 -> 18 (a multiple of 3)
    jm = jpar.make_mesh(2)
    (jx,), jmask = jpar.bucket_shard_batch(jm, jnp.asarray(ragged.numpy()), min_bucket=4)
    out2 = LocalWorld(2).run(lambda g, r: tpar.bucket_shard_batch(
        tpar.make_mesh(group=g), ragged, min_bucket=4))
    np.testing.assert_array_equal(torch.cat([o[0][0] for o in out2]).numpy(), np.asarray(jx))
    np.testing.assert_array_equal(torch.cat([o[1] for o in out2]).numpy(), np.asarray(jmask))


def test_toolkit_names_the_right_roadmap_items():
    metric = BinaryAUROC(device="cpu")
    # The fleet merge (item 6) is ported: a world of one returns its own
    # outcome, computed locally.
    metric.update(torch.tensor([0.1, 0.9, 0.4, 0.7]), torch.tensor([0, 1, 0, 1]))
    outcome = toolkit.sync_and_compute(metric, topology="tree")
    assert float(outcome.value) == 1.0 and outcome.world_effective == 1 and outcome.levels == 0
    # The sketch tier (item 7) is ported: the flat sketch sync returns the
    # merged value; a world of one computes its own sketch.
    assert float(toolkit.sync_and_compute(metric, sketch="histogram")) == 1.0
