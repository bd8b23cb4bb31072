"""The port's shape bucketing against the JAX package's: bucket sizes,
bucket lists and padded batches (edge rows, the int32 mask, a caller's
mask combined in, empty batches, ``multiple_of``), bit for bit."""

import numpy as np
import pytest
import torch

from torcheval_tpu.metrics import _bucket as jax_bucket
from torcheval_tpu_torch.metrics import _bucket
from torcheval_tpu_torch.telemetry import events


@pytest.mark.parametrize("n", [0, 1, 77, 128, 129, 313, 1000, 4097])
@pytest.mark.parametrize("min_bucket,multiple_of", [(128, 1), (1, 1), (64, 3), (128, 6)])
def test_bucket_size_matches_jax(n, min_bucket, multiple_of):
    kw = dict(min_bucket=min_bucket, multiple_of=multiple_of)
    assert _bucket.bucket_size(n, **kw) == jax_bucket.bucket_size(n, **kw)


@pytest.mark.parametrize("max_batch,kw", [(0, {}), (313, {}), (5000, {"min_bucket": 16}),
                                          (999, {"multiple_of": 3})])
def test_bucket_sizes_match_jax(max_batch, kw):
    assert _bucket.bucket_sizes(max_batch, **kw) == jax_bucket.bucket_sizes(max_batch, **kw)


def test_negative_batch_raises():
    with pytest.raises(ValueError, match="non-negative"):
        _bucket.bucket_size(-1)


@pytest.mark.parametrize(
    "n,with_mask,multiple_of",
    [(77, False, 1), (200, True, 1), (128, True, 1), (128, False, 1), (0, False, 1),
     (0, True, 1), (130, True, 3)],
)
def test_pad_to_bucket_matches_jax(n, with_mask, multiple_of):
    rng = np.random.default_rng(n)
    scores = rng.random((n, 5)).astype(np.float32)
    labels = rng.integers(0, 5, n).astype(np.int32)
    mask = (rng.random(n) < 0.7).astype(np.int32) if with_mask else None
    (js, jl), jm = jax_bucket.pad_to_bucket(scores, labels, mask=mask, multiple_of=multiple_of)
    (ts, tl), tm = _bucket.pad_to_bucket(
        torch.from_numpy(scores), torch.from_numpy(labels),
        mask=None if mask is None else torch.from_numpy(mask), multiple_of=multiple_of,
    )
    for got, want in ((ts, js), (tl, jl), (tm, jm)):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want)
    assert tm.dtype == torch.int32


def test_pad_to_bucket_rejects_bad_shapes():
    with pytest.raises(ValueError, match="at least one"):
        _bucket.pad_to_bucket()
    with pytest.raises(ValueError, match="shared leading dim"):
        _bucket.pad_to_bucket(torch.zeros(3), torch.zeros(4))
    with pytest.raises(ValueError, match="mask must have shape"):
        _bucket.pad_to_bucket(torch.zeros(3), mask=torch.ones(4))


def test_bucket_pads_are_recorded_when_telemetry_is_on(monkeypatch):
    monkeypatch.setattr(events, "ENABLED", True)
    events.clear()
    _bucket.pad_to_bucket(torch.zeros(77))
    _bucket.pad_to_bucket(torch.zeros(256))
    pads = events.events("bucket_pad")
    assert [(e.bucket, e.rows_valid, e.rows_padded) for e in pads] == [(128, 77, 51), (256, 256, 0)]
    assert events.aggregates()["bucket_pad"] == {
        128: {"rows_valid": 77, "rows_padded": 51, "calls": 1},
        256: {"rows_valid": 256, "rows_padded": 0, "calls": 1},
    }
    events.clear()
    monkeypatch.setattr(events, "ENABLED", False)
    _bucket.pad_to_bucket(torch.zeros(77))
    assert events.events("bucket_pad") == []
