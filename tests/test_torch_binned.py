"""``ops/binned.py`` (the binned-count op) and the threshold grid against
the JAX package.  Counts are held bit for bit against the JAX kernel run
in interpret mode and against the JAX sort formulation; the NaN case
against the sort formulation only (the JAX routes disagree on NaN)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.metrics.functional.classification.binned_auc import (
    _binned_counts_rows_sort as jax_sort_counts,
)
from torcheval_tpu.ops.pallas_binned import pallas_binned_counts
from torcheval_tpu_torch.metrics.functional.classification import binned_auc
from torcheval_tpu_torch.metrics.functional.classification.binned_precision_recall_curve import (
    _create_threshold_tensor,
    _linspace_grid,
)
from torcheval_tpu_torch.ops import _build
from torcheval_tpu_torch.ops.binned import binned_counts

_NAMES = ("num_tp", "num_fp", "num_pos", "num_total")


def _assert_counts_equal(got, want, msg=""):
    for x, y, name in zip(got, want, _NAMES):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        assert x.dtype == np.int32, f"{msg} {name}: {x.dtype}"
        np.testing.assert_array_equal(x, np.asarray(y), err_msg=f"{msg} {name}")


def _port(s, h, th):
    return binned_counts(torch.from_numpy(s), torch.from_numpy(h), torch.from_numpy(th))


def _jax_both(s, h, th):
    s, h, th = jnp.asarray(s), jnp.asarray(h), jnp.asarray(th)
    return pallas_binned_counts(s, h, th, interpret=True), jax_sort_counts(s, h, th)


def _grid(t_count):
    return np.array(jnp.linspace(0, 1.0, t_count)) if t_count > 1 else np.array([0.5], np.float32)


@pytest.mark.parametrize(
    "r,n,t_count",
    [(1, 5000, 200), (3, 2048, 100), (1, 10000, 1000), (2, 777, 300), (16, 555, 33),
     (1, 4096, 1), (1, 4096, 4), (1, 4096, 128)],
)
def test_counts_bitwise_with_jax_kernel_and_sort(r, n, t_count):
    rng = np.random.default_rng(r * n + t_count)
    s = rng.random((r, n)).astype(np.float32)
    h = rng.random((r, n)) > 0.4
    th = _grid(t_count)
    _build.reset_counts()
    got = _port(s, h, th)
    assert _build.PLAIN_CALLS["binned_counts"] == 1 and not _build.LAUNCHES
    kernel, sort = _jax_both(s, h, th)
    _assert_counts_equal(got, kernel, f"kernel r={r} n={n} T={t_count}")
    _assert_counts_equal(got, sort, f"sort r={r} n={n} T={t_count}")


def _edge_case(name):
    rng = np.random.default_rng(2)
    if name == "ties_out_of_range":
        s = (rng.random((1, 4096)) * 20 - 5).round().astype(np.float32)
        th = np.sort(rng.choice(np.arange(-6, 18.0), 17, replace=False)).astype(np.float32)
        return s, rng.random((1, 4096)) > 0.5, th
    if name == "equal_to_thresholds":
        s = np.array([[0.0, 0.25, 0.25, 0.5, 0.75, 1.0, 0.125, 0.625]], np.float32)
        h = np.array([[1, 0, 1, 1, 0, 1, 0, 1]], bool)
        return s, h, np.array([0.0, 0.125, 0.25, 0.5, 0.625, 0.75, 1.0], np.float32)
    if name == "huge_and_infinite":
        s = np.array([[3.0e38, 3.39e38, np.inf, 0.5, -1.0, -np.inf]], np.float32)
        return s, np.array([[1, 0, 1, 1, 0, 1]], bool), np.array([0.0, 0.5, 1.0], np.float32)
    if name == "one_bin":
        return np.full((2, 3000), 0.37, np.float32), rng.random((2, 3000)) > 0.5, _grid(100)
    assert name == "empty"
    return np.zeros((2, 0), np.float32), np.zeros((2, 0), bool), _grid(5)


@pytest.mark.parametrize(
    "name", ["ties_out_of_range", "equal_to_thresholds", "huge_and_infinite", "one_bin", "empty"]
)
def test_edge_cases_bitwise_with_jax(name):
    s, h, th = _edge_case(name)
    kernel, sort = _jax_both(s, h, th)
    got = _port(s, h, th)
    _assert_counts_equal(got, kernel, name)
    _assert_counts_equal(got, sort, name)


def test_nan_scores_count_at_every_threshold_as_the_sort_route():
    s = np.array([[0.1, np.nan, 0.7, 0.3]], np.float32)
    h = np.array([[1, 1, 0, 0]], bool)
    th = np.array(jnp.linspace(0, 1.0, 5))
    got = _port(s, h, th)
    _assert_counts_equal(got, jax_sort_counts(jnp.asarray(s), jnp.asarray(h), jnp.asarray(th)))
    assert got[0][0].tolist() == [2, 1, 1, 1, 1]
    port_sort = binned_auc._binned_counts_rows_sort(
        torch.from_numpy(s), torch.from_numpy(h), torch.from_numpy(th)
    )
    _assert_counts_equal(port_sort, got, "port sort route")


def test_strided_multiclass_layout_and_sort_route():
    # The (N, C) buffer read as (C, N) in place with (C, N) class hits,
    # as the multiclass path passes them; the port's own sort route agrees.
    rng = np.random.default_rng(5)
    n, c = 2000, 40
    buf = (rng.integers(0, 33, (n, c)) / 32).astype(np.float32)
    y = rng.integers(0, c, n)
    hits = y[None, :] == np.arange(c)[:, None]
    th = np.array(jnp.linspace(0, 1.0, 33))
    got = binned_counts(torch.from_numpy(buf).T, torch.from_numpy(hits), torch.from_numpy(th))
    want = jax_sort_counts(jnp.asarray(buf.T), jnp.asarray(hits), jnp.asarray(th))
    _assert_counts_equal(got, want, "strided")
    port_sort = binned_auc._binned_counts_rows_sort(
        torch.from_numpy(buf).T, torch.from_numpy(hits), torch.from_numpy(th)
    )
    _assert_counts_equal(port_sort, want, "port sort route")


def test_route_is_the_kernel_below_2_31_samples():
    assert binned_auc._select_binned_route(2**22) == "kernel"
    assert binned_auc._select_binned_route(2**31 - 1) == "kernel"
    assert binned_auc._select_binned_route(2**31) == "sort"


def test_masked_rows_keep_the_kernel_route():
    rng = np.random.default_rng(6)
    s = rng.random((3, 500)).astype(np.float32)
    h = rng.random((3, 500)) > 0.5
    mask = rng.random(500) > 0.3
    th = _linspace_grid(50, torch.device("cpu"))
    _build.reset_counts()
    got = binned_auc._binned_counts_rows(
        torch.from_numpy(s), torch.from_numpy(h), th, mask=torch.from_numpy(mask)
    )
    assert dict(_build.PLAIN_CALLS) == {"binned_counts": 1}
    want = binned_auc._binned_counts_rows(
        torch.from_numpy(s[:, mask]), torch.from_numpy(h[:, mask]), th
    )
    _assert_counts_equal(got, [w.numpy() for w in want], "masked")


# Every count up to 64, then counts where a correctly rounded division
# (42, 48, ...) or the product carried to the last entry (83, 84, ...)
# misses jnp.linspace, and the large grids.
_LINSPACE_SAMPLE = list(range(1, 65)) + [83, 84, 95, 98, 100, 200, 2048, 4096, 10_000, 32_768]


def test_grid_bitwise_with_jnp_linspace():
    # One program for all sampled grids (per-count eager calls compile
    # each count anew).
    want = jax.jit(
        lambda: jnp.concatenate([jnp.linspace(0, 1.0, c) for c in _LINSPACE_SAMPLE])
    )()
    got = torch.cat([_create_threshold_tensor(c, "cpu") for c in _LINSPACE_SAMPLE])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32), np.asarray(want).view(np.int32))
    assert _create_threshold_tensor(1, "cpu").tolist() == [0.0]


def test_grid_bitwise_with_xla_for_every_count():
    # jnp.linspace(0, 1, T) is the f32 iota 0..T-2 times XLA's f32
    # reciprocal of T - 1, then 1.0 (JAX's source and its compiled HLO;
    # held against jnp.linspace itself above, with T = 1).  Here every T
    # in 2..4096, 10 000 and 32 768 against that product, computed by XLA
    # in one call.
    counts = list(range(2, 4097)) + [10_000, 32_768]
    iota = np.concatenate([np.arange(c - 1, dtype=np.float32) for c in counts])
    recip = np.concatenate(
        [np.full(c - 1, np.float32(1) / np.float32(c - 1), np.float32) for c in counts]
    )
    products = np.split(np.asarray(jnp.asarray(iota) * jnp.asarray(recip)),
                        np.cumsum([c - 1 for c in counts])[:-1])
    want = np.concatenate([np.append(p, np.float32(1.0)) for p in products])
    got = np.concatenate([_linspace_grid(c, torch.device("cpu")).numpy() for c in counts])
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_grid_is_cached_per_count_and_device():
    a = _create_threshold_tensor(77, "cpu")
    assert _create_threshold_tensor(77, torch.device("cpu")) is a
    assert _create_threshold_tensor(78, "cpu") is not a
    listed = _create_threshold_tensor([0.0, 0.1, 1.0], "cpu")
    assert listed.dtype == torch.float32 and listed.tolist()[1] == float(np.float32(0.1))


@pytest.mark.parametrize(
    "s,h,th",
    [
        (torch.zeros(2, 8), torch.zeros(2, 7, dtype=torch.bool), torch.zeros(3)),
        (torch.zeros(8), torch.zeros(8, dtype=torch.bool), torch.zeros(3)),
        (torch.zeros(2, 8), torch.zeros(2, 8, dtype=torch.bool), torch.zeros(0)),
    ],
)
def test_binned_counts_rejects_bad_shapes(s, h, th):
    with pytest.raises(ValueError):
        binned_counts(s, h, th)


def test_non_cuda_devices_are_refused():
    s = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        binned_counts(s, torch.zeros(2, 8, dtype=torch.bool, device="meta"),
                      torch.zeros(3, device="meta"))


@pytest.mark.parametrize("hit_dtype", [np.bool_, np.int64, np.int32, np.uint8])
@pytest.mark.parametrize("grid", ["bisected-2048", "geometric-300", "linspace-10000"])
def test_hits_of_any_width_and_the_slot_grids_bitwise_with_jax(hit_dtype, grid):
    # The grids the kernel's slot guess serves (the sync's bisected grid,
    # jnp.linspace) and one far from uniform, which takes its binary
    # search; hits as the callers hand them, in any integer width.
    from torcheval_tpu_torch.parallel.sync import _grid_np

    kind, t_count = grid.split("-")
    th = {
        "bisected": lambda t: _grid_np(t).copy(),
        "geometric": lambda t: np.geomspace(1e-4, 1.0, t).astype(np.float32),
        "linspace": _grid,
    }[kind](int(t_count))
    rng = np.random.default_rng(int(t_count))
    s = rng.random((2, 3001)).astype(np.float32)
    s[0, :4] = [np.nextafter(th[5], np.float32(0)), th[5], -0.0, 1.5]
    h = rng.random((2, 3001)) > 0.5
    got = binned_counts(torch.from_numpy(s), torch.from_numpy(h.astype(hit_dtype)),
                        torch.from_numpy(th))
    kernel, sort = _jax_both(s, h, th)
    _assert_counts_equal(got, kernel, grid)
    _assert_counts_equal(got, sort, grid)


def test_unaligned_view_and_ragged_rows_bitwise_with_jax():
    # scores[:, 1:] (the card's scalar path) at N % 4 != 0.
    rng = np.random.default_rng(8)
    base = rng.random((3, 1027)).astype(np.float32)
    hits = rng.random((3, 1027)) > 0.3
    th = _grid(200)
    got = binned_counts(torch.from_numpy(base)[:, 1:], torch.from_numpy(hits)[:, 1:],
                        torch.from_numpy(th))
    kernel, sort = _jax_both(base[:, 1:], hits[:, 1:], th)
    _assert_counts_equal(got, kernel, "unaligned")
    _assert_counts_equal(got, sort, "unaligned")
