"""The port's batched edit distance (``torcheval_tpu_torch.ops.wavefront``)
against the JAX package's three routes on the same numpy-seeded pairs: the
Pallas kernel in interpret mode, the XLA diagonal scan and the native host
DP, and against the port's own native copy.  Distances are integers, so
every comparison is exact.  On the CPU the port runs its plain version,
the torch twin of the CUDA kernel ``csrc/wavefront.cu``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu.native.edit_distance import edit_distance_batch as jax_native_batch
from torcheval_tpu.ops.pallas_wavefront import (
    _edit_distance_pallas,
    _edit_distance_xla,
)
from torcheval_tpu.ops.pallas_wavefront import edit_distance_tokens as jax_edit_distance_tokens
from torcheval_tpu.ops.pallas_wavefront import lens_from_ids as jax_lens_from_ids
from torcheval_tpu_torch import ops
from torcheval_tpu_torch.native import edit_distance as port_native
from torcheval_tpu_torch.ops import _build
from torcheval_tpu_torch.ops.wavefront import (
    _edit_distance_native,
    edit_distance_tokens,
    lens_from_ids,
)


def _pad(seqs, width, fill=-1):
    out = np.full((len(seqs), width), fill, np.int32)
    for row, s in enumerate(seqs):
        out[row, : len(s)] = s
    return out


def _random_pairs(rng, n, max_a, max_b, vocab):
    return [
        (
            rng.integers(0, vocab, int(rng.integers(0, max_a + 1))).tolist(),
            rng.integers(0, vocab, int(rng.integers(0, max_b + 1))).tolist(),
        )
        for _ in range(n)
    ]


def _arrays(pairs, max_a, max_b):
    a = _pad([p[0] for p in pairs], max_a)
    b = _pad([p[1] for p in pairs], max_b)
    al = np.asarray([len(p[0]) for p in pairs], np.int32)
    bl = np.asarray([len(p[1]) for p in pairs], np.int32)
    return a, b, al, bl


def _port(a, b, al=None, bl=None, mask=None):
    _build.reset_counts()
    got = edit_distance_tokens(
        torch.from_numpy(a),
        torch.from_numpy(b),
        None if al is None else torch.from_numpy(al),
        None if bl is None else torch.from_numpy(bl),
        mask=None if mask is None else torch.from_numpy(mask),
    )
    # CPU tensors take the plain version, and only it.
    assert dict(_build.PLAIN_CALLS) == {"edit_distance_tokens": 1} and not _build.LAUNCHES
    assert got.dtype == torch.int32 and got.shape == (a.shape[0],)
    return got.numpy()


def _assert_all_equal(pairs, max_a, max_b):
    a, b, al, bl = _arrays(pairs, max_a, max_b)
    got = _port(a, b, al, bl)
    ja, jb, jal, jbl = (jnp.asarray(x) for x in (a, b, al, bl))
    want = {
        "JAX Pallas kernel (interpret)": np.asarray(
            _edit_distance_pallas(ja, jb, jal, jbl, interpret=True)
        ),
        "JAX XLA scan": np.asarray(_edit_distance_xla(ja, jb, jal, jbl)),
        "JAX native DP": jax_native_batch([p[0] for p in pairs], [p[1] for p in pairs]),
        "the port's native DP": _edit_distance_native(a, b, al, bl),
        "pure-Python DP": np.asarray(
            [port_native._edit_distance_py(p[0], p[1]) for p in pairs]
        ),
    }
    for name, w in want.items():
        np.testing.assert_array_equal(got, w, err_msg=f"differs from {name}")
    # Lengths left to lens_from_ids give the same distances.
    np.testing.assert_array_equal(_port(a, b), got)


@pytest.mark.parametrize("seed", range(5))
def test_randomized_ragged_batches(seed):
    # A small vocabulary forces collisions; lengths 0..24.
    rng = np.random.default_rng(seed)
    _assert_all_equal(_random_pairs(rng, 40, 24, 24, 6), 24, 24)


@pytest.mark.parametrize("max_a,max_b", [(3, 19), (19, 3), (1, 64), (64, 1)])
def test_asymmetric_widths(max_a, max_b):
    rng = np.random.default_rng(11 + max_a)
    _assert_all_equal(_random_pairs(rng, 17, max_a, max_b, 4), max_a, max_b)


def test_degenerate_pairs():
    pairs = [
        ([], []),
        ([], [1, 2, 3]),
        ([4, 4, 4], []),
        ([1, 2, 3], [1, 2, 3]),  # equal: 0
        ([5], [5]),
        ([5], [6]),
        ([0, 0, 0, 0], [0]),
        ([1, 2, 3, 4], [4, 3, 2, 1]),
        ([1, 2, 3, 4], [5, 6, 7, 8]),  # disjoint vocabularies: max length
    ]
    _assert_all_equal(pairs, 4, 4)


def test_zero_width_reference():
    # (n, 0) id arrays: the distance is the hypothesis length.
    a = _pad([[1, 2], [3], []], 2)
    b = np.zeros((3, 0), np.int32)
    al = np.asarray([2, 1, 0], np.int32)
    bl = np.zeros(3, np.int32)
    np.testing.assert_array_equal(_port(a, b, al, bl), al)
    np.testing.assert_array_equal(_port(a, b), al)
    np.testing.assert_array_equal(_port(b, a, bl, al), al)
    jax_got = _edit_distance_xla(*(jnp.asarray(x) for x in (a, b, al, bl)))
    np.testing.assert_array_equal(np.asarray(jax_got), al)


def test_no_pairs():
    a = np.zeros((0, 5), np.int32)
    assert _port(a, a).shape == (0,)


def test_pad_values_never_leak():
    # Same lengths, different garbage past them: same distances.
    pairs = [([1, 2], [1, 3]), ([2], [2, 2, 2])]
    a, b, al, bl = _arrays(pairs, 6, 6)
    noisy_a, noisy_b = a.copy(), b.copy()
    for row in range(2):
        noisy_a[row, al[row] :] = -7 - row
        noisy_b[row, bl[row] :] = 2  # a real token's id, past the length
    np.testing.assert_array_equal(_port(a, b, al, bl), _port(noisy_a, noisy_b, al, bl))
    np.testing.assert_array_equal(_port(a, b, al, bl), [1, 2])


def test_lens_from_ids_is_a_count_as_in_jax():
    ids = _pad([[1, 2, 3], [2, 2], []], 5)
    ids[1, 3] = 4  # a malformed row: a token after a pad
    got = lens_from_ids(torch.from_numpy(ids))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_lens_from_ids(jnp.asarray(ids))))
    np.testing.assert_array_equal(got.numpy(), [3, 3, 0])


def test_mask_zeroes_pad_pairs():
    a = _pad([[1, 2, 3], [2, 2], []], 5)
    b = _pad([[1, 3], [2], [9]], 4)
    mask = np.asarray([1, 0, 1], np.int32)
    want = np.asarray(jax_edit_distance_tokens(a, b, mask=mask))
    np.testing.assert_array_equal(_port(a, b, mask=mask), want)
    np.testing.assert_array_equal(_port(a, b, mask=mask), [1, 0, 1])


def test_explicit_lengths_past_the_width_are_clipped():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 4, (6, 7)).astype(np.int32)
    b = rng.integers(0, 4, (6, 5)).astype(np.int32)
    al = np.asarray([0, 3, 7, 9, 100, -2], np.int32)
    bl = np.asarray([5, 6, 0, 2, -1, 50], np.int32)
    want = np.asarray(
        jax_edit_distance_tokens(a, b, jnp.asarray(al), jnp.asarray(bl), interpret=True)
    )
    np.testing.assert_array_equal(_port(a, b, al, bl), want)
    clipped = _edit_distance_native(a, b, np.clip(al, 0, 7), np.clip(bl, 0, 5))
    np.testing.assert_array_equal(_port(a, b, al, bl), clipped)


@pytest.mark.parametrize(
    "a_shape,b_shape",
    [((3,), (3, 2)), ((3, 2), (4, 2)), ((2, 2, 2), (2, 2))],
    ids=["1-D", "counts differ", "3-D"],
)
def test_validation_errors_match_jax(a_shape, b_shape):
    a, b = np.zeros(a_shape, np.int32), np.zeros(b_shape, np.int32)
    with pytest.raises(ValueError) as jax_err:
        jax_edit_distance_tokens(jnp.asarray(a), jnp.asarray(b))
    with pytest.raises(ValueError) as port_err:
        edit_distance_tokens(torch.from_numpy(a), torch.from_numpy(b))
    assert str(port_err.value) == str(jax_err.value)


def test_float_ids_raise():
    with pytest.raises(TypeError, match="integer ids"):
        edit_distance_tokens(torch.zeros(2, 3), torch.zeros(2, 3, dtype=torch.int32))


def test_exported_from_ops():
    assert ops.edit_distance_tokens is edit_distance_tokens
    assert "edit_distance_tokens" in ops.__all__


def test_native_cpp_equals_the_python_dp(monkeypatch):
    rng = np.random.default_rng(7)
    pairs = _random_pairs(rng, 60, 30, 30, 5) + [([], []), ([1], []), ([], [2, 2])]
    a_seqs, b_seqs = [p[0] for p in pairs], [p[1] for p in pairs]
    assert port_native.backend() == "c++"  # this host has a compiler
    compiled = port_native.edit_distance_batch(a_seqs, b_seqs)
    # The stand-in of a host without a compiler.
    monkeypatch.setattr(port_native, "_LIB", None)
    monkeypatch.setattr(port_native, "_LOAD_FAILED", True)
    assert port_native.backend() == "python"
    fallback = port_native.edit_distance_batch(a_seqs, b_seqs)
    assert compiled.dtype == fallback.dtype == np.int64
    np.testing.assert_array_equal(compiled, fallback)
    np.testing.assert_array_equal(compiled, jax_native_batch(a_seqs, b_seqs))


def test_native_batch_rejects_unequal_counts():
    with pytest.raises(ValueError, match="equally many"):
        port_native.edit_distance_batch([[1]], [[1], [2]])
