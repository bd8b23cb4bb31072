"""The port's sort-scan core against the JAX package's on the same inputs.

The JAX sort is not stable, so within a tie group the order of the hits
(and the cumulative counts at a group's inner positions) may differ; the
sorted scores, the tie-group flags and every group-end count must match.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.metrics.functional.classification._sort_scan import (
    class_hits as jax_class_hits,
    sorted_tie_cumsums as jax_sorted_tie_cumsums,
)
from torcheval_tpu_torch.metrics.functional.classification._sort_scan import (
    class_hits,
    sort_desc,
    sorted_tie_cumsums,
)


def _inputs(seed, rows, n, levels):
    rng = np.random.default_rng(seed)
    scores = (rng.integers(0, levels, (rows, n)) / levels).astype(np.float32)
    hits = rng.random((rows, n)) < 0.4
    return scores, hits


@pytest.mark.parametrize(
    "rows,n,levels,hit_dtype",
    [(4, 200, 16, np.bool_), (1, 300, 1000, np.int32), (3, 64, 2, np.float32)],
)
def test_sorted_tie_cumsums_matches_jax(rows, n, levels, hit_dtype):
    scores, hits = _inputs(rows * n, rows, n, levels)
    hits = hits.astype(hit_dtype)
    want = [np.asarray(a) for a in jax_sorted_tie_cumsums(jnp.asarray(scores), jnp.asarray(hits))]
    got = [a.numpy() for a in sorted_tie_cumsums(torch.from_numpy(scores), torch.from_numpy(hits))]
    np.testing.assert_array_equal(got[0], want[0])  # thresholds
    np.testing.assert_array_equal(got[1], want[1])  # is_last
    last = want[1]
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g[last], w[last])


def test_fractional_targets_follow_the_int8_cast():
    # JAX casts the hit payload to int8 before the sort: 0.7 → 0, 1.0 → 1.
    scores = np.array([[0.9, 0.8, 0.7, 0.6]], np.float32)
    target = np.array([[0.7, 1.0, 0.0, 1.0]], np.float32)
    want = np.asarray(jax_sorted_tie_cumsums(jnp.asarray(scores), jnp.asarray(target))[2])
    got = sorted_tie_cumsums(torch.from_numpy(scores), torch.from_numpy(target))[2]
    np.testing.assert_array_equal(got.numpy(), want)


def test_sort_desc_is_stable():
    scores = torch.tensor([[0.5, 1.0, 0.5, 0.5, 2.0]])
    hits = torch.tensor([[True, False, False, True, False]])
    values, sorted_hits = sort_desc(scores, hits)
    assert values.tolist() == [[2.0, 1.0, 0.5, 0.5, 0.5]]
    assert sorted_hits.tolist() == [[False, False, True, False, True]]


def test_class_hits_matches_jax():
    target = np.random.default_rng(3).integers(0, 7, 50).astype(np.int32)
    want = np.asarray(jax_class_hits(jnp.asarray(target), 7))
    np.testing.assert_array_equal(class_hits(torch.from_numpy(target), 7).numpy(), want)
