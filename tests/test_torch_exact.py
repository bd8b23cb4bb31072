"""``torcheval_tpu_torch.parallel.exact`` against the JAX package's
``parallel.exact`` on the root ``conftest.py``'s CPU devices.  The port
runs over ``LocalWorld(k)``: every rank is a thread, passes its
``shard_batch`` block of the same numpy-seeded arrays, and must return the
same bits.

Tolerances: the gather-exact family bit for bit equal to the port's
single-device functional on the whole array, and within 1e-6 of JAX's
(except the kept tied-infinity divergence, pinned below); the multiclass
ustat per class bit for bit equal to JAX's rank-sum formulation
(``_kernel="pallas", _interpret=True``: the same integer counts and the
same f32 epilogue) and within 1e-6 of JAX's default (searchsorted, on the
CPU); the binary ustat within 1e-6 of JAX.  Errors raise the same
``ValueError`` on every rank, and no rank waits on a peer."""

import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu import parallel as jpar
from torcheval_tpu.parallel import exact as jexact
from torcheval_tpu_torch import parallel as tpar
from torcheval_tpu_torch.distributed import LocalGroup, LocalWorld
from torcheval_tpu_torch.metrics.functional import (
    binary_auprc,
    binary_auroc,
    multiclass_auroc,
    skip_value_checks,
)
from torcheval_tpu_torch.ops import _build
from torcheval_tpu_torch.parallel import exact as texact

TOL = 1e-6
# (world size, mesh shape, axis names); the port's axis is every name.
MESHES = [(4, (4,), ("dp",)), (8, (4, 2), ("dp", "sp"))]
MESH_IDS = ["dp4", "dp4xsp2"]


def _axis(names):
    return names[0] if len(names) == 1 else names


def _run(world, shape, names, fn):
    """``fn(mesh)`` on every rank of ``LocalWorld(world)``; rank 0's
    result, after checking that every rank returned the same bits."""
    out = LocalWorld(world).run(
        lambda group, rank: fn(tpar.make_mesh(shape, names, group=group))
    )
    for other in out[1:]:
        for a, b in zip(torch.utils._pytree.tree_leaves(out[0]),
                        torch.utils._pytree.tree_leaves(other)):
            assert torch.equal(a, b)
    return out[0]


def _blocks(mesh, names, *arrays, dim=0):
    return tpar.shard_batch(mesh, *(torch.from_numpy(a) for a in arrays),
                            axis=_axis(names), dim=dim)


def _jax(shape, names, fn, *arrays):
    """``fn(*arrays, mesh)`` of the JAX package over a mesh of ``shape``
    CPU devices (its functions shard the global arrays themselves)."""
    return np.asarray(fn(*(jnp.asarray(a) for a in arrays), jpar.make_mesh(shape, names)))


def _binary(seed, n, pos_rate=0.5, levels=None):
    rng = np.random.default_rng(seed)
    s = rng.random(n).astype(np.float32)
    if levels:
        s = (np.round(s * levels) / levels).astype(np.float32)
    return s, (rng.random(n) < pos_rate).astype(np.int32)


def _multiclass(seed, n, c, levels=None):
    rng = np.random.default_rng(seed)
    s = rng.random((n, c)).astype(np.float32)
    if levels:
        s = (np.round(s * levels) / levels).astype(np.float32)
    return s, rng.integers(0, c, n).astype(np.int32)


def _skewed(seed=24, n=2048, c=8):
    """JAX's ``test_ring_comm_skewed_and_empty_classes`` data: 85 % of the
    samples in class 0, class c − 1 empty."""
    rng = np.random.default_rng(seed)
    s = rng.random((n, c)).astype(np.float32)
    t = np.where(rng.random(n) < 0.85, 0, rng.integers(1, c - 1, n)).astype(np.int32)
    return s, t


# ------------------------------------------------------------ gather-exact


def _binary_case(kind):
    s, t = _binary(7, 256, pos_rate=0.3, levels=16)
    if kind == "non-finite":
        s[3], s[100], s[200] = np.inf, -np.inf, np.nan
    if kind == "rare":  # 2^15 samples, 40 positives: the rank-sum / -histogram routes
        s, t = _binary(8, 2**15, pos_rate=40 / 2**15)
    return s, t


@pytest.mark.parametrize("world,shape,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("kind", ["ties", "non-finite", "rare"])
def test_binary_gather_exact_is_the_single_device_bits(world, shape, names, kind):
    s, t = _binary_case(kind)

    def fn(mesh):
        ps, pt = _blocks(mesh, names, s, t)
        return [texact.sharded_binary_auroc_exact(ps, pt, mesh, axis=_axis(names)),
                texact.sharded_binary_auprc_exact(ps, pt, mesh, axis=_axis(names))]

    _build.reset_counts()
    got = _run(world, shape, names, fn)
    if kind == "rare":  # each rank took the route of the whole
        assert dict(_build.PLAIN_CALLS) == {"rank_sum_counts": world, "rank_hist_counts": world}
    whole = [binary_auroc(torch.from_numpy(s), torch.from_numpy(t)),
             binary_auprc(torch.from_numpy(s), torch.from_numpy(t))]
    for g, w in zip(got, whole):
        assert g.dtype == w.dtype and torch.equal(g, w)
    if kind != "non-finite":  # NaN: the two packages' sort orders differ
        want = [_jax(shape, names, lambda a, b, m: jexact.sharded_binary_auroc_exact(
                    a, b, m, axis=_axis(names)), s, t),
                _jax(shape, names, lambda a, b, m: jexact.sharded_binary_auprc_exact(
                    a, b, m, axis=_axis(names)), s, t)]
        for g, w in zip(got, want):
            assert abs(float(g) - float(w)) <= TOL


def test_tied_infinite_scores_the_kept_divergence_survives_the_gather():
    """The single-device divergence (``test_torch_auroc.py``): two tied +inf
    scores, one hit and one miss, give 0.625 in the port (float64
    Mann-Whitney) and 0.75 in JAX's XLA path; the gathered whole keeps
    it."""
    s = np.array([np.inf, np.inf, 0.5, 0.2], np.float32)
    t = np.array([1, 0, 1, 0], np.int32)
    got = _run(4, (4,), ("dp",), lambda mesh: texact.sharded_binary_auroc_exact(
        *_blocks(mesh, ("dp",), s, t), mesh))
    assert float(got) == 0.625
    assert float(_jax((4,), ("dp",), jexact.sharded_binary_auroc_exact, s, t)) == 0.75


@pytest.mark.parametrize("world,shape,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("kind", ["dense", "rare"])
def test_multitask_gather_exact_is_the_single_device_bits(world, shape, names, kind):
    rng = np.random.default_rng(21)
    n = 2**15 if kind == "rare" else 512
    s = (np.round(rng.random((3, n)) * 64) / 64).astype(np.float32)
    t = (rng.random((3, n)) < (40 / n if kind == "rare" else 0.3)).astype(np.int32)

    def fn(mesh):
        ps, pt = _blocks(mesh, names, s, t, dim=1)
        return [texact.sharded_multitask_auroc_exact(ps, pt, mesh, axis=_axis(names)),
                texact.sharded_multitask_auprc_exact(ps, pt, mesh, axis=_axis(names))]

    got = _run(world, shape, names, fn)
    whole = [binary_auroc(torch.from_numpy(s), torch.from_numpy(t), num_tasks=3),
             binary_auprc(torch.from_numpy(s), torch.from_numpy(t), num_tasks=3)]
    for g, w in zip(got, whole):
        assert torch.equal(g, w)
    want = [_jax(shape, names, lambda a, b, m: jexact.sharded_multitask_auroc_exact(
                a, b, m, axis=_axis(names)), s, t),
            _jax(shape, names, lambda a, b, m: jexact.sharded_multitask_auprc_exact(
                a, b, m, axis=_axis(names)), s, t)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=TOL)


@pytest.mark.parametrize("world,shape,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("kind", ["sort-route", "rank-route"])
def test_multiclass_gather_exact_is_the_single_device_bits(world, shape, names, kind):
    # 2^15 samples over 200 classes: the rank-sum route of the whole (cap
    # 256); 512 x 16 takes the sort route.
    s, t = _multiclass(9, 2**15, 200) if kind == "rank-route" else _multiclass(9, 512, 16, 32)
    c = s.shape[1]

    def fn(mesh):
        ps, pt = _blocks(mesh, names, s, t)
        return texact.sharded_multiclass_auroc_exact(
            ps, pt, mesh, axis=_axis(names), num_classes=c, average=None)

    _build.reset_counts()
    got = _run(world, shape, names, fn)
    route = "rank_sum_counts" if kind == "rank-route" else "auc_from_sorted"
    assert dict(_build.PLAIN_CALLS) == {route: world}
    assert torch.equal(got, multiclass_auroc(torch.from_numpy(s), torch.from_numpy(t),
                                             num_classes=c, average=None))
    want = _jax(shape, names, lambda a, b, m: jexact.sharded_multiclass_auroc_exact(
        a, b, m, axis=_axis(names), num_classes=c, average=None), s, t)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)


# -------------------------------------------------------- multiclass ustat


def _mc_case(case):
    if case == "skewed-empty":
        return _skewed()
    if case == "ties":
        return _multiclass(23, 2048, 16, levels=32)
    return _multiclass(11, 2048, 24)


@pytest.mark.parametrize("world,shape,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("case", ["random", "ties", "skewed-empty"])
def test_multiclass_ustat_bits_equal_jax_rank_sum_formulation(world, shape, names, case):
    s, t = _mc_case(case)
    c = s.shape[1]
    comms = ["gather", "ring"] if len(names) == 1 else ["gather"]  # a tuple axis has no ring

    def fn(mesh):
        ps, pt = _blocks(mesh, names, s, t)
        return [texact.sharded_multiclass_auroc_ustat(
            ps, pt, mesh, axis=_axis(names), num_classes=c, average=None, comm=comm)
            for comm in comms]

    _build.reset_counts()
    got = _run(world, shape, names, fn)
    # The rank-sum formulation on every rank: once a rank on the gather,
    # once a ring step on the ring.
    assert dict(_build.PLAIN_CALLS) == {
        "rank_sum_counts": world * (1 + (world if "ring" in comms else 0))}
    for g in got[1:]:
        assert torch.equal(g, got[0])
    for comm, g in zip(comms, got):
        pinned = _jax(shape, names, lambda a, b, m: jexact.sharded_multiclass_auroc_ustat(
            a, b, m, axis=_axis(names), num_classes=c, average=None, comm=comm,
            _kernel="pallas", _interpret=True), s, t)
        np.testing.assert_array_equal(g.numpy(), pinned)
    default = _jax(shape, names, lambda a, b, m: jexact.sharded_multiclass_auroc_ustat(
        a, b, m, axis=_axis(names), num_classes=c, average=None), s, t)
    np.testing.assert_allclose(got[0].numpy(), default, rtol=0, atol=TOL)
    if case == "skewed-empty":
        assert float(got[0][c - 1]) == 0.5
    macro = _run(world, shape, names, lambda mesh: texact.sharded_multiclass_auroc_ustat(
        *_blocks(mesh, names, s, t), mesh, axis=_axis(names), num_classes=c))
    assert abs(float(macro) - float(got[0].mean())) <= TOL


@pytest.mark.parametrize("route", ["disable-ustat", "skip-value-checks", "float64", "pinned"])
def test_multiclass_ustat_routes(route, monkeypatch):
    """The rank-sum formulation declines on the route switch and on
    float64 scores, and takes searchsorted (no kernel, no plain version)
    within 1e-6; ``_kernel="pallas"`` pins it back.  Under skipped value
    checks the gate still reads the bounds the call's one read back
    holds, so the rank-sum formulation runs (the JAX package takes
    searchsorted there, skipping that read)."""
    s, t = _mc_case("ties")
    c = s.shape[1]
    kw = {}
    if route == "disable-ustat":
        monkeypatch.setenv("TORCHEVAL_TPU_TORCH_DISABLE_USTAT", "1")
    if route == "float64":
        s = s.astype(np.float64)
    if route == "pinned":
        kw["_kernel"] = "pallas"

    def fn(mesh):
        ps, pt = _blocks(mesh, ("dp",), s, t)
        out = []
        for comm in ("gather", "ring"):
            if route in ("skip-value-checks", "pinned"):
                with skip_value_checks():
                    out.append(texact.sharded_multiclass_auroc_ustat(
                        ps, pt, mesh, num_classes=c, average=None, comm=comm, **kw))
            else:
                out.append(texact.sharded_multiclass_auroc_ustat(
                    ps, pt, mesh, num_classes=c, average=None, comm=comm))
        return out

    _build.reset_counts()
    gather, ring = _run(4, (4,), ("dp",), fn)
    assert not _build.LAUNCHES
    kernel = route in ("skip-value-checks", "pinned")
    assert dict(_build.PLAIN_CALLS) == ({"rank_sum_counts": 4 + 16} if kernel else {})
    assert torch.equal(gather, ring)
    want = _jax((4,), ("dp",), lambda a, b, m: jexact.sharded_multiclass_auroc_ustat(
        a, b, m, num_classes=c, average=None), s.astype(np.float32), t)
    np.testing.assert_allclose(gather.numpy(), want, rtol=0, atol=TOL)


def test_multiclass_ustat_overflowing_cap_under_skipped_checks_counts_with_searchsorted():
    """Under ``skip_value_checks`` an overflowing cap keeps each class's
    ``cap`` largest scores.  The U identity of the rank-sum formulation
    needs every positive in the table, so the gate declines: the call is
    the searchsorted formulation's bits, with no kernel or plain call."""
    c = 4

    def fn(kernel):
        def per_mesh(mesh):
            with skip_value_checks():
                return texact.sharded_multiclass_auroc_ustat(
                    *_blocks(mesh, ("dp",), _MS, _ONE_CLASS), mesh, num_classes=c,
                    average=None, max_class_count_per_shard=20, _kernel=kernel)
        return per_mesh

    want = _run(4, (4,), ("dp",), fn("searchsorted"))
    _build.reset_counts()
    got = _run(4, (4,), ("dp",), fn("auto"))
    assert not _build.PLAIN_CALLS and not _build.LAUNCHES
    assert torch.equal(got, want)


@pytest.mark.parametrize("world,shape,names", MESHES, ids=MESH_IDS)
@pytest.mark.parametrize("comm", ["auto", "gather", "ring"])
def test_eager_ustat_pin(world, shape, names, comm):
    """The port's pin gives JAX's cap; its kernel is ``"pallas"`` where the
    port's gate passes, while JAX on the CPU says ``"searchsorted"`` (its
    gate reads the backend).  And the pin is the function's own decision
    from its blocks plus one all-reduce."""
    axis = _axis(names)
    if comm == "ring" and len(names) > 1:
        with pytest.raises(ValueError, match="single mesh axis"):
            texact.eager_ustat_pin(np.zeros((8, 2), np.float32), np.zeros(8, np.int32), 2,
                                   world, comm=comm, axis=axis)
        return
    for s, t in (_mc_case("random"), _skewed()):
        c = s.shape[1]
        cap, kernel = texact.eager_ustat_pin(torch.from_numpy(s), torch.from_numpy(t), c, world,
                                             comm=comm, axis=axis)
        j_cap, j_kernel = jexact.eager_ustat_pin(jnp.asarray(s), jnp.asarray(t), c, world,
                                                 comm=comm, axis=axis)
        assert (cap, kernel, j_kernel) == (j_cap, "pallas", "searchsorted")

        def plan(mesh):
            ps, pt = _blocks(mesh, names, s, t)
            decided, _ = texact._mc_ustat_plan(ps, pt, mesh, axis, c, None, comm, "auto")
            return torch.tensor([decided.cap, decided.kernel])

        assert _run(world, shape, names, plan).tolist() == [cap, True]


# ------------------------------------------------------------ binary ustat


@pytest.mark.parametrize(
    "n,pos_rate,levels,cap",
    [(4096, 0.5, None, None), (4096, 0.03, None, None), (4096, 0.03, None, 64),
     (2**13, 0.2, 128, None), (4096, 0.0, None, None), (4096, 1.0, None, None)],
    ids=["balanced", "rare", "rare-capped", "ties", "no-positives", "no-negatives"],
)
def test_binary_ustat_matches_jax(n, pos_rate, levels, cap):
    s, t = _binary(n + int(pos_rate * 100), n, pos_rate, levels)

    def fn(mesh):
        ps, pt = _blocks(mesh, ("dp",), s, t)
        return [f(ps, pt, mesh, comm=comm, **{arg: cap})
                for f, arg in ((texact.sharded_binary_auroc_ustat, "max_minority_count_per_shard"),
                               (texact.sharded_binary_auprc_ustat, "max_positive_count_per_shard"))
                for comm in ("gather", "ring")]

    _build.reset_counts()
    auroc_g, auroc_r, ap_g, ap_r = _run(4, (4,), ("dp",), fn)
    assert not _build.PLAIN_CALLS and not _build.LAUNCHES  # no kernel in this family
    assert torch.equal(auroc_g, auroc_r)
    assert abs(float(ap_g) - float(ap_r)) <= TOL
    want_auroc = _jax((4,), ("dp",), lambda a, b, m: jexact.sharded_binary_auroc_ustat(
        a, b, m, max_minority_count_per_shard=cap), s, t)
    want_ap = _jax((4,), ("dp",), lambda a, b, m: jexact.sharded_binary_auprc_ustat(
        a, b, m, max_positive_count_per_shard=cap), s, t)
    assert abs(float(auroc_g) - float(want_auroc)) <= TOL
    assert abs(float(ap_g) - float(want_ap)) <= TOL
    whole = binary_auroc(torch.from_numpy(s), torch.from_numpy(t))
    assert abs(float(auroc_g) - float(whole)) <= TOL


@pytest.mark.parametrize("world,shape,names", MESHES, ids=MESH_IDS)
def test_binary_ustat_exact_on_integer_grid(world, shape, names):
    """JAX's ``test_ustat_exact_on_integer_grid``: U is a small integer, so
    the ustat equals the single-device AUROC exactly."""
    s = np.array([0.0, 0.25, 0.25, 0.5, 0.5, 0.5, 0.75, 1.0] * 4, np.float32)
    t = np.array([0, 1, 0, 1, 1, 0, 0, 1] * 4, np.int32)
    got = _run(world, shape, names, lambda mesh: texact.sharded_binary_auroc_ustat(
        *_blocks(mesh, names, s, t), mesh, axis=_axis(names)))
    assert float(got) == float(binary_auroc(torch.from_numpy(s), torch.from_numpy(t)))
    want = _jax(shape, names, lambda a, b, m: jexact.sharded_binary_auroc_ustat(
        a, b, m, axis=_axis(names)), s, t)
    assert float(got) == float(want)


# ------------------------------------------------------------------ errors


class _NoP2P(LocalGroup):
    @property
    def supports_p2p(self) -> bool:
        return False


def _rank_errors(world, shape, names, fn, group_type=LocalGroup, timeout=60.0):
    """``fn(mesh, rank)`` on every rank of ``LocalWorld(world)``, each rank
    catching its own exception and returning it; fails if a rank is still
    waiting after ``timeout`` seconds."""
    lw = LocalWorld(world)

    def rank_fn(group, rank):
        mesh = tpar.make_mesh(shape, names, group=group_type(lw, rank))
        try:
            fn(mesh, rank)
        except Exception as e:  # noqa: BLE001 - the rank's own error is the result
            return e
        return None

    box = []
    runner = threading.Thread(target=lambda: box.append(lw.run(rank_fn)), daemon=True)
    runner.start()
    runner.join(timeout)
    assert not runner.is_alive(), "a rank is still waiting on a peer"
    return box[0]


def _uneven(mesh, rank, fn, *arrays, dim=0):
    """Rank r's block of ``arrays`` split into blocks of unequal length."""
    parts = [np.array_split(a, mesh.group.world_size, axis=dim)[rank] for a in arrays]
    return fn(*(torch.from_numpy(np.ascontiguousarray(p)) for p in parts), mesh)


_S, _T = _binary(6, 4096, 0.5)
_MS, _MT = _multiclass(17, 256, 4)
_ONE_CLASS = np.zeros(256, np.int32)
_ONE_CLASS[:64] = np.arange(64) % 4  # rank 0's block is balanced; the others one class


def _with_inf_on_rank_2(mesh, rank, fn, s, t):
    ps, pt = _blocks(mesh, ("dp",), s, t)
    if rank == 2:
        ps = ps.clone()
        ps[1] = np.inf
    return fn(ps, pt, mesh)


def _one_rank_2d(mesh, rank, fn, s, t):
    """Rank 1 passes its 1-D scores block as a column."""
    ps, pt = _blocks(mesh, ("dp",), s, t)
    return fn(ps[:, None] if rank == 1 else ps, pt, mesh)


def _one_rank_flat(mesh, rank, s, t):
    """Rank 1 passes its ``(T, n)`` block flattened to 1-D."""
    ps, pt = _blocks(mesh, ("dp",), s, t, dim=1)
    return (ps.reshape(-1), pt.reshape(-1)) if rank == 1 else (ps, pt)


def _one_rank_columns(mesh, rank, s, t):
    """Rank 1 passes one class column too few."""
    ps, pt = _blocks(mesh, ("dp",), s, t)
    return (ps[:, :-1], pt) if rank == 1 else (ps, pt)


_ERROR_CASES = {
    "auroc-ustat-cap": ("minority-class samples", lambda m, r: texact.sharded_binary_auroc_ustat(
        *_blocks(m, ("dp",), _S, _T), m, max_minority_count_per_shard=8)),
    "auprc-ustat-cap": ("positive samples", lambda m, r: texact.sharded_binary_auprc_ustat(
        *_blocks(m, ("dp",), _S, _T), m, max_positive_count_per_shard=8)),
    "multiclass-ustat-cap": ("max_class_count_per_shard", lambda m, r:
        texact.sharded_multiclass_auroc_ustat(*_blocks(m, ("dp",), _MS, _ONE_CLASS), m,
                                              num_classes=4, max_class_count_per_shard=20)),
    "auroc-ustat-inf": ("finite scores", lambda m, r: _with_inf_on_rank_2(
        m, r, texact.sharded_binary_auroc_ustat, _S, _T)),
    "auprc-ustat-inf": ("finite scores", lambda m, r: _with_inf_on_rank_2(
        m, r, texact.sharded_binary_auprc_ustat, _S, _T)),
    "multiclass-ustat-inf": ("finite scores", lambda m, r: _with_inf_on_rank_2(
        m, r, lambda s, t, mesh: texact.sharded_multiclass_auroc_ustat(
            s, t, mesh, num_classes=4), _MS, _MT)),
    **{f"uneven-{f.__name__}": ("divide evenly",
                                lambda m, r, f=f: _uneven(m, r, f, _S[:10], _T[:10]))
       for f in (texact.sharded_binary_auroc_exact, texact.sharded_binary_auprc_exact,
                 texact.sharded_binary_auroc_ustat, texact.sharded_binary_auprc_ustat)},
    **{f"uneven-{f.__name__}": ("divide evenly", lambda m, r, f=f: _uneven(
        m, r, f, _S[:30].reshape(3, 10), _T[:30].reshape(3, 10), dim=1))
       for f in (texact.sharded_multitask_auroc_exact, texact.sharded_multitask_auprc_exact)},
    **{f"uneven-{f.__name__}": ("divide evenly", lambda m, r, f=f: _uneven(
        m, r, lambda s, t, mesh: f(s, t, mesh, num_classes=4), _MS[:10], _MT[:10]))
       for f in (texact.sharded_multiclass_auroc_exact, texact.sharded_multiclass_auroc_ustat)},
    **{f"one-rank-shape-{f.__name__}": ("1-D of equal length", lambda m, r, f=f: _one_rank_2d(
        m, r, f, _S, _T))
       for f in (texact.sharded_binary_auroc_exact, texact.sharded_binary_auprc_exact,
                 texact.sharded_binary_auroc_ustat, texact.sharded_binary_auprc_ustat)},
    **{f"one-rank-shape-{f.__name__}": ("(num_tasks, N)", lambda m, r, f=f: f(
        *_one_rank_flat(m, r, _S[:64].reshape(2, 32), _T[:64].reshape(2, 32)), m))
       for f in (texact.sharded_multitask_auroc_exact, texact.sharded_multitask_auprc_exact)},
    **{f"one-rank-width-{f.__name__}": ("differ in shape", lambda m, r, f=f: f(
        *_blocks(m, ("dp",), _S[:96 if r == 1 else 64].reshape(-1, 32),
                 _T[:96 if r == 1 else 64].reshape(-1, 32), dim=1), m))
       for f in (texact.sharded_multitask_auroc_exact, texact.sharded_multitask_auprc_exact)},
    **{f"one-rank-shape-{f.__name__}": ("4 columns", lambda m, r, f=f: f(
        *_one_rank_columns(m, r, _MS, _MT), m, num_classes=4))
       for f in (texact.sharded_multiclass_auroc_exact, texact.sharded_multiclass_auroc_ustat)},
    "bad-comm": ("comm should be", lambda m, r: texact.sharded_multiclass_auroc_ustat(
        *_blocks(m, ("dp",), _MS, _MT), m, num_classes=4, comm="tree")),
    "average-micro-ustat": ("average", lambda m, r: texact.sharded_multiclass_auroc_ustat(
        *_blocks(m, ("dp",), _MS, _MT), m, num_classes=4, average="micro")),
    "average-micro-exact": ("average", lambda m, r: texact.sharded_multiclass_auroc_exact(
        *_blocks(m, ("dp",), _MS, _MT), m, num_classes=4, average="micro")),
}


@pytest.mark.parametrize("case", sorted(_ERROR_CASES))
def test_errors_raise_the_same_value_error_on_every_rank(case):
    match, fn = _ERROR_CASES[case]
    errors = _rank_errors(4, (4,), ("dp",), fn)
    assert all(isinstance(e, ValueError) for e in errors), errors
    assert len({str(e) for e in errors}) == 1 and match in str(errors[0]), errors


def test_ring_needs_a_single_axis_and_a_point_to_point_group():
    def ring(mesh, rank, names):
        ps, pt = _blocks(mesh, names, _S, _T)
        return texact.sharded_binary_auroc_ustat(ps, pt, mesh, axis=_axis(names), comm="ring")

    errors = _rank_errors(8, (4, 2), ("dp", "sp"), lambda m, r: ring(m, r, ("dp", "sp")))
    assert {str(e) for e in errors} == {str(errors[0])} and "single mesh axis" in str(errors[0])
    errors = _rank_errors(4, (4,), ("dp",), lambda m, r: ring(m, r, ("dp",)), group_type=_NoP2P)
    assert all(isinstance(e, ValueError) and "_NoP2P" in str(e) for e in errors), errors
    # A sub-axis of a 2-D mesh runs in the sub-group of the ranks along it:
    # the JAX shard_map result over that axis, on every rank.  The ring
    # over one sub-axis gives the gather's bits.
    want = _jax((4, 2), ("dp", "sp"), lambda s, t, m: jexact.sharded_binary_auroc_exact(
        s, t, m, axis="dp"), _S, _T)
    got = _run(8, (4, 2), ("dp", "sp"), lambda m: [texact.sharded_binary_auroc_exact(
        *_blocks(m, ("dp",), _S, _T), m, axis="dp")] + [texact.sharded_binary_auroc_ustat(
            *_blocks(m, ("sp",), _S, _T), m, axis="sp", comm=c) for c in ("gather", "ring")])
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert torch.equal(got[1], got[2])
    # A world of one sends nothing, so it needs no point-to-point channel.
    got = _run(1, (1,), ("dp",), lambda m: texact.sharded_multiclass_auroc_ustat(
        torch.from_numpy(_MS), torch.from_numpy(_MT), m, num_classes=4, comm="ring"))
    assert torch.equal(got, multiclass_auroc(torch.from_numpy(_MS), torch.from_numpy(_MT),
                                             num_classes=4))


def test_numpy_input_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mesh = tpar.make_mesh()
    with pytest.raises(RuntimeError, match="CPU tensors"):
        texact.sharded_binary_auroc_exact(_S, _T, mesh)
