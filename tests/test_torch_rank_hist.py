"""``ops/ustat.py``'s rank histogram (the exact-AUPRC route) against the
JAX package: histograms bit for bit against the JAX kernel run in
interpret mode, per-row average precision within 1e-6 (f32 sums in
another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.ops import pallas_ustat as jx
from torcheval_tpu_torch.ops import _build, ustat

_BIG = 3.0e38


def _jax_hist(q, t, tile=512):
    return np.asarray(
        jx.rank_hist_counts(jnp.asarray(q), jnp.asarray(t), interpret=True, tile=tile)
    )


def _numpy_hist(tables, queries):
    want = np.zeros(tables.shape, np.int32)
    for r, (t, q) in enumerate(zip(tables, queries)):
        bins = np.searchsorted(t, q, side="right") - 1
        np.add.at(want[r], bins[bins >= 0], 1)
    return want


def _case(name):
    rng = np.random.default_rng(len(name))
    if name.startswith("random"):
        r, n, cap = (3, 300, 16) if name == "random_a" else (9, 512, 32)
        tables = np.sort(rng.normal(size=(r, cap)).astype(np.float32), axis=1)
        return tables, rng.normal(size=(r, n)).astype(np.float32), 512
    # ties between queries and entries on a 1/8 grid, half-pad tables
    r, n, cap = 8, 300, 32
    tables = np.sort((rng.integers(0, 6, (r, cap)) * 0.125).astype(np.float32), axis=1)
    tables[:, cap // 2 :] = _BIG
    return tables, (rng.integers(0, 6, (r, n)) * 0.125).astype(np.float32), 128


@pytest.mark.parametrize("name", ["random_a", "random_b", "ties_pads_multi_tile"])
def test_rank_hist_counts_bitwise_with_jax(name):
    tables, queries, tile = _case(name)
    _build.reset_counts()
    got = ustat.rank_hist_counts(torch.from_numpy(queries), torch.from_numpy(tables))
    assert _build.PLAIN_CALLS["rank_hist_counts"] == 1
    assert not _build.LAUNCHES
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax_hist(queries, tables, tile))
    np.testing.assert_array_equal(got.numpy(), _numpy_hist(tables, queries))


def test_strided_rows_empty_class_and_pad_queries():
    # The (N, C) buffer read as (C, N) in place, 37 rows (past a multiple
    # of 32), a row of pads only (a class without positives: no bin), and
    # queries equal to a pad or to the smallest entry.
    rng = np.random.default_rng(3)
    n, c, cap = 700, 37, 16
    buf = (rng.integers(-4, 5, (n, c)) / 4).astype(np.float32)
    tables = np.sort((rng.integers(-4, 5, (c, cap)) / 4).astype(np.float32), axis=1)
    tables[5] = _BIG
    tables[6, 10:] = _BIG
    buf[:3, 6] = _BIG
    got = ustat.rank_hist_counts(torch.from_numpy(buf).T, torch.from_numpy(tables))
    want = _numpy_hist(tables, buf.T)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), _jax_hist(np.ascontiguousarray(buf.T), tables))
    assert not got[5].any() and int(got[6, 10:].sum()) == 3


def test_nan_queries_fall_in_no_bin():
    tables = np.array([[0.0, 0.5] + [_BIG] * 14], np.float32)
    queries = np.array([[0.25, np.nan, 0.75, -1.0]], np.float32)
    got = ustat.rank_hist_counts(torch.from_numpy(queries), torch.from_numpy(tables))
    assert got[0, :2].tolist() == [1, 1] and int(got.sum()) == 2


def test_suffix_cumsum_and_ap_from_hist_match_jax():
    rng = np.random.default_rng(4)
    r, cap = 5, 32
    counts = np.array([0, 3, 16, 32, 7], np.int32)
    table = np.full((r, cap), _BIG, np.float32)
    for i, k in enumerate(counts):
        table[i, :k] = np.sort((rng.integers(0, 8, k) / 8).astype(np.float32))
    hist = rng.integers(0, 50, (r, cap)).astype(np.int32)
    cum = ustat._suffix_cumsum(torch.from_numpy(hist))
    assert cum.dtype == torch.int32
    np.testing.assert_array_equal(cum.numpy(), np.asarray(jx._suffix_cumsum(jnp.asarray(hist))))
    got = ustat._ap_from_hist(
        torch.from_numpy(table), torch.from_numpy(counts), torch.from_numpy(hist)
    )
    want = jx._ap_from_hist(jnp.asarray(table), jnp.asarray(counts), jnp.asarray(hist))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert float(got[0]) == 0.0


@pytest.mark.parametrize("average", ["macro", None])
def test_multiclass_auprc_ustat_matches_jax(average):
    rng = np.random.default_rng(11)
    n, c, cap = 512, 6, 128
    s = (rng.integers(0, 64, (n, c)) / 64).astype(np.float32)
    y = rng.integers(0, c, n).astype(np.int32)
    y[y == 5] = 4  # class 5 has no positives: AP 0
    want = jx.multiclass_auprc_ustat(
        jnp.asarray(s), jnp.asarray(y), num_classes=c, average=average,
        cap=cap, interpret=True, tile=256,
    )
    got = ustat.multiclass_auprc_ustat(
        torch.from_numpy(s), torch.from_numpy(y), num_classes=c, average=average, cap=cap
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    if average is None:
        assert float(got[5]) == 0.0


def test_binary_auprc_ustat_matches_jax():
    rng = np.random.default_rng(12)
    r, n, cap = 3, 600, 64
    s = (rng.integers(0, 100, (r, n)) / 100).astype(np.float32)
    y = (rng.random((r, n)) < 0.05).astype(np.int32)
    y[2] = 0  # no positives: AP 0
    want = jx.binary_auprc_ustat(
        jnp.asarray(s), jnp.asarray(y), cap=cap, interpret=True, tile=256
    )
    got = ustat.binary_auprc_ustat(torch.from_numpy(s), torch.from_numpy(y), cap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    assert float(got[2]) == 0.0


@pytest.mark.parametrize(
    "q,t,error",
    [
        (torch.zeros(2, 8), torch.zeros(2, 24), ValueError),  # cap % 16
        (torch.zeros(2, 8), torch.zeros(3, 16), ValueError),  # row count
        (torch.zeros(8), torch.zeros(1, 16), ValueError),  # 1-D queries
        (torch.zeros(2, 8, dtype=torch.float64), torch.zeros(2, 16), TypeError),
    ],
)
def test_rank_hist_counts_rejects_bad_arguments(q, t, error):
    with pytest.raises(error):
        ustat.rank_hist_counts(q, t)


def test_non_cuda_devices_are_refused():
    q = torch.zeros(2, 8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ustat.rank_hist_counts(q, torch.zeros(2, 16, device="meta"))
