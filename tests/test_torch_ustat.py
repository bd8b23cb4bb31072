"""``ops/ustat.py`` (the rank-sum AUROC route) against the JAX package.

Counts and per-row AUROCs are held bit for bit against the JAX kernels
run in interpret mode.  The JAX route deciders return None off the TPU,
so the decision tests run them with the backend reported as "tpu".
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.ops import pallas_ustat as jx
from torcheval_tpu_torch.ops import _build, ustat

_BIG = 3.0e38


def _tables(rng, r, cap, pad_front=0, pad_back=0):
    t = np.sort((rng.integers(-8, 8, (r, cap)) / 4).astype(np.float32), axis=1)
    if pad_back:
        t[:, cap - pad_back :] = _BIG
    if pad_front:
        t[:, :pad_front] = -_BIG
    return t


def _jax_counts(q, t, tile=128):
    return np.asarray(
        jx.rank_sum_counts(jnp.asarray(q), jnp.asarray(t), interpret=True, tile=tile)
    )


@pytest.mark.parametrize(
    "r,n,cap,front,back", [(5, 300, 16, 0, 6), (13, 700, 64, 10, 0), (3, 200, 64, 0, 0)]
)
def test_rank_sum_counts_bitwise_with_jax(r, n, cap, front, back):
    rng = np.random.default_rng(r * n)
    t = _tables(rng, r, cap, front, back)
    q = (rng.integers(-9, 9, (r, n)) / 4).astype(np.float32)  # ties with t
    got = ustat.rank_sum_counts(torch.from_numpy(q), torch.from_numpy(t))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), _jax_counts(q, t))


def test_negated_half_and_strided_queries():
    rng = np.random.default_rng(7)
    r, n, cap = 6, 400, 32
    t2 = np.concatenate([_tables(rng, r, cap, 0, 4), _tables(rng, r, cap, 4, 0)])
    q = rng.normal(size=(n, r)).astype(np.float32)  # (N, C): rows are q.T
    got = ustat.rank_sum_counts(torch.from_numpy(q).T, torch.from_numpy(t2), negate=True)
    stacked = np.concatenate([q.T, -q.T])
    np.testing.assert_array_equal(got.numpy(), _jax_counts(stacked, t2))


def test_multiclass_auroc_ustat_bitwise_with_jax():
    rng = np.random.default_rng(11)
    n, c, cap = 512, 6, 128
    s = (rng.integers(0, 64, (n, c)) / 64).astype(np.float32)
    y = rng.integers(0, c, n).astype(np.int32)
    y[y == 5] = 4  # class 5 has no positives: 0.5
    want = np.asarray(
        jx.multiclass_auroc_ustat(
            jnp.asarray(s), jnp.asarray(y), num_classes=c, average=None,
            cap=cap, interpret=True, tile=256,
        )
    )
    got = ustat.multiclass_auroc_ustat(
        torch.from_numpy(s), torch.from_numpy(y), num_classes=c, average=None, cap=cap
    ).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert got[5] == 0.5


@pytest.mark.parametrize("side", ["pos", "neg"])
def test_binary_auroc_ustat_bitwise_with_jax(side):
    rng = np.random.default_rng(12)
    r, n, cap = 3, 600, 64
    s = (rng.integers(0, 100, (r, n)) / 100).astype(np.float32)
    rare = rng.random((r, n)) < 0.05
    y = (rare if side == "pos" else ~rare).astype(np.int32)
    want = np.asarray(
        jx.binary_auroc_ustat(
            jnp.asarray(s), jnp.asarray(y), cap=cap, table_side=side,
            interpret=True, tile=256,
        )
    )
    got = ustat.binary_auroc_ustat(
        torch.from_numpy(s), torch.from_numpy(y), cap=cap, table_side=side
    ).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_win_cap_matches_jax():
    for n in (2**14, 2**15, 2**16, 2**17, 2**20, 2**22):
        for most in (0, 1, 16, 17, 100, 256, 257, 511, 512, 513, 4000):
            assert ustat._win_cap(most, n) == jx._win_cap(most, n), (most, n)


def _on_tpu():
    return mock.patch.object(jax, "default_backend", return_value="tpu")


@pytest.mark.parametrize(
    "case", ["headline_like", "skewed", "nan", "small_n"]
)
def test_ustat_route_cap_matches_jax(case):
    rng = np.random.default_rng(5)
    n, c = (2**14, 200) if case == "small_n" else (2**15, 200)
    s = rng.random((n, c)).astype(np.float32)
    y = rng.integers(0, c, n).astype(np.int32)
    if case == "skewed":
        y[: n // 2] = 0
    if case == "nan":
        s[3, 4] = np.nan
    with _on_tpu():
        want = jx.ustat_route_cap(jnp.asarray(s), jnp.asarray(y), c)
    got = ustat.ustat_route_cap(torch.from_numpy(s), torch.from_numpy(y), c)
    assert got == want
    if case == "headline_like":
        assert got == 256


def test_route_switch_and_out_of_range_targets(monkeypatch):
    rng = np.random.default_rng(6)
    s = torch.from_numpy(rng.random((2**15, 200)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 200, 2**15).astype(np.int32))
    assert ustat.ustat_route_cap(s, y, 200) == 256
    y_bad = y.clone()
    y_bad[0] = 200
    assert ustat.ustat_route_cap(s, y_bad, 200) is None
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_DISABLE_USTAT", "1")
    assert ustat.ustat_route_cap(s, y, 200) is None


@pytest.mark.parametrize("case", ["rare_pos", "rare_neg", "balanced", "non01"])
def test_binary_ustat_route_matches_jax(case):
    rng = np.random.default_rng(9)
    r, n = 2, 2**15
    s = rng.random((r, n)).astype(np.float32)
    p = {"rare_pos": 0.003, "rare_neg": 0.997, "balanced": 0.5, "non01": 0.003}[case]
    y = (rng.random((r, n)) < p).astype(np.float32)
    if case == "non01":
        y[0, 0] = 0.5
    with _on_tpu():
        want = jx.binary_ustat_route(jnp.asarray(s), jnp.asarray(y))
    assert ustat.binary_ustat_route(torch.from_numpy(s), torch.from_numpy(y)) == want


@pytest.mark.parametrize(
    "q,t,negate",
    [
        (torch.zeros(2, 8), torch.zeros(2, 24), False),  # cap % 16
        (torch.zeros(2, 8), torch.zeros(3, 16), False),  # row count
        (torch.zeros(2, 8), torch.zeros(2, 16), True),  # negate needs 2·Rq rows
        (torch.zeros(1, 1).expand(1, 2**27), torch.zeros(1, 16), False),  # cap·N ≥ 2^31
    ],
)
def test_rank_sum_counts_rejects_bad_shapes(q, t, negate):
    with pytest.raises(ValueError):
        ustat.rank_sum_counts(q, t, negate=negate)


def test_cpu_tensors_take_the_plain_version():
    _build.reset_counts()
    ustat.rank_sum_counts(torch.zeros(2, 8), torch.zeros(2, 16))
    assert _build.PLAIN_CALLS["rank_sum_counts"] == 1
    assert _build.LAUNCHES["rank_sum_counts"] == 0
