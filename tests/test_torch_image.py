"""The port's image metrics (functional ``peak_signal_noise_ratio``,
``structural_similarity``, ``gaussian_frechet_distance``; classes
``PeakSignalNoiseRatio``, ``StructuralSimilarity``,
``FrechetInceptionDistance``) against the JAX package on the same
numpy-seeded inputs.

Tolerances: PSNR and SSIM within 1e-6 relative (float32 sums and the same
float32 gaussian window, convolved in another order).  The Fréchet
distance and FID within 1e-4 relative of the JAX package: both take two
float32 eigendecompositions at D = 64 and FID's covariance is
``cov_sum − n·μμᵀ`` in float32 in both, so the error is the f32
eigensolver's, about D·eps of the spectrum.  Both packages within 1e-3
relative of a float64 ``scipy.linalg.sqrtm`` oracle on the same
features."""

import copy
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from torcheval_tpu import metrics as jm
from torcheval_tpu.metrics import functional as jF
from torcheval_tpu_torch import metrics as tm
from torcheval_tpu_torch.convert import state_from_jax
from torcheval_tpu_torch.metrics import functional as tF
from torcheval_tpu_torch.metrics.functional.image._precision import full_f32
from torcheval_tpu_torch.utils.test_utils import MetricClassTester

RTOL = 1e-6
FID_RTOL = 1e-4
ORACLE_RTOL = 1e-3
D = 64


def _close(got, want, rtol=RTOL):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0, equal_nan=True)


def _images(seed, shape=(2, 3, 32, 32), noise=0.1):
    rng = np.random.default_rng(seed)
    x = rng.random(shape, dtype=np.float32)
    y = np.clip(x + noise * rng.standard_normal(shape), 0.0, 1.0).astype(np.float32)
    return x, y


@pytest.mark.parametrize("data_range", [None, 1.0, 2.5])
@pytest.mark.parametrize("shape", [(2, 3, 32, 32), (5, 7)])
def test_psnr_functional_matches_jax(data_range, shape):
    x, y = _images(len(shape), shape)
    got = tF.peak_signal_noise_ratio(torch.from_numpy(x), torch.from_numpy(y), data_range)
    want = jF.peak_signal_noise_ratio(jnp.asarray(x), jnp.asarray(y), data_range)
    assert got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize(
    "kw",
    [{}, {"data_range": 2.0}, {"kernel_size": 7, "sigma": 1.0}, {"k1": 0.02, "k2": 0.05}],
    ids=["default", "range", "kernel7", "k1k2"],
)
def test_ssim_functional_matches_jax(kw):
    x, y = _images(3)
    got = tF.structural_similarity(torch.from_numpy(x), torch.from_numpy(y), **kw)
    want = jF.structural_similarity(jnp.asarray(x), jnp.asarray(y), **kw)
    assert got.dtype == torch.float32
    _close(got, want)


def test_ssim_of_identical_images_is_one_and_float64_input_is_float32():
    x, _ = _images(4)
    got = tF.structural_similarity(torch.from_numpy(x).double(), torch.from_numpy(x).double())
    assert got.dtype == torch.float32
    _close(got, 1.0)


def _gaussians(seed, d=D, n=400):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, d)).astype(np.float32)
    b = (0.8 * rng.standard_normal((n, d)) + 0.3).astype(np.float32)
    return [
        x.astype(np.float32)
        for f in (a, b)
        for x in (f.mean(0), np.cov(f, rowvar=False))
    ]


def _oracle(mu_x, cov_x, mu_y, cov_y):
    mu_x, cov_x, mu_y, cov_y = (np.asarray(v, np.float64) for v in (mu_x, cov_x, mu_y, cov_y))
    root = scipy.linalg.sqrtm(cov_x @ cov_y).real
    return float(((mu_x - mu_y) ** 2).sum() + np.trace(cov_x) + np.trace(cov_y)
                 - 2.0 * np.trace(root))


@pytest.mark.parametrize("seed", [0, 1])
def test_gaussian_frechet_distance_matches_jax_and_the_oracle(seed):
    args = _gaussians(seed)
    got = tF.gaussian_frechet_distance(*(torch.from_numpy(a) for a in args))
    want = jF.gaussian_frechet_distance(*(jnp.asarray(a) for a in args))
    assert got.dtype == torch.float32 and got.dim() == 0
    _close(got, want, FID_RTOL)
    _close(got, _oracle(*args), ORACLE_RTOL)
    _close(want, _oracle(*args), ORACLE_RTOL)
    # Identical gaussians are at distance ~0.
    same = tF.gaussian_frechet_distance(*(torch.from_numpy(a) for a in args[:2] * 2))
    assert abs(float(same)) < 1e-3


def _projection(seed=9, d=D):
    return (np.random.default_rng(seed).standard_normal((3 * 8 * 8, d)) / 8).astype(np.float32)


class _Extractor(torch.nn.Module):
    """A small feature extractor from a numpy seed: a linear projection of
    the flattened (3, 8, 8) image."""

    def __init__(self, w: np.ndarray) -> None:
        super().__init__()
        self.proj = torch.nn.Parameter(torch.from_numpy(w))

    def forward(self, images):
        return torch.as_tensor(images).reshape(len(images), -1) @ self.proj


def _fid_pair(w):
    wj = jnp.asarray(w)
    ref = jm.FrechetInceptionDistance(
        lambda im: jnp.asarray(im).reshape(im.shape[0], -1) @ wj, feature_dim=w.shape[1])
    return tm.FrechetInceptionDistance(_Extractor(w), feature_dim=w.shape[1], device="cpu"), ref


def _fid_images(seed, n):
    rng = np.random.default_rng(seed)
    real = rng.random((n, 3, 8, 8), dtype=np.float32)
    fake = (rng.random((n, 3, 8, 8), dtype=np.float32) * 0.9 + 0.05).astype(np.float32)
    return real, fake


def test_fid_matches_jax_and_the_oracle():
    w = _projection()
    port, ref = _fid_pair(w)
    real, fake = _fid_images(1, 300)
    for i in range(3):
        sl = slice(100 * i, 100 * (i + 1))
        port.update(torch.from_numpy(real[sl]), is_real=True)
        port.update(torch.from_numpy(fake[sl]), is_real=False)
        ref.update(real[sl], is_real=True)
        ref.update(fake[sl], is_real=False)
    # The states are float32 sums of the same products: within 1e-5
    # relative of the JAX package's (sums of 300 products of ~1).
    for name, value in port.state_dict().items():
        assert value.dtype == torch.float32
        np.testing.assert_allclose(value.numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-5, atol=1e-4)
    got, want = port.compute(), ref.compute()
    _close(got, want, FID_RTOL)
    fr = real.reshape(300, -1).astype(np.float64) @ w.astype(np.float64)
    ff = fake.reshape(300, -1).astype(np.float64) @ w.astype(np.float64)
    oracle = _oracle(fr.mean(0), np.cov(fr, rowvar=False), ff.mean(0), np.cov(ff, rowvar=False))
    _close(got, oracle, ORACLE_RTOL)
    # A JAX state_dict computes the same in the port.
    loaded = tm.FrechetInceptionDistance(_Extractor(w), feature_dim=D, device="cpu")
    loaded.load_state_dict(state_from_jax({k: np.asarray(v) for k, v in ref.state_dict().items()}))
    _close(loaded.compute(), want, FID_RTOL)


def test_fid_merge_pickle_and_deepcopy():
    w = _projection()
    real, fake = _fid_images(2, 100)
    whole, _ = _fid_pair(w)
    whole.update(torch.from_numpy(real), is_real=True)
    whole.update(torch.from_numpy(fake), is_real=False)
    parts = [_fid_pair(w)[0] for _ in range(3)]
    parts[0].update(torch.from_numpy(real[:60]), is_real=True)
    parts[1].update(torch.from_numpy(real[60:]), is_real=True)
    parts[1].update(torch.from_numpy(fake), is_real=False)  # parts[2] never updated
    merged = parts[0].merge_state(parts[1:])
    # The same sums added in another grouping: within the eigensolver's
    # tolerance.
    _close(merged.compute(), whole.compute(), FID_RTOL)
    # A pickle drops the extractor; update then raises until one is assigned.
    loaded = pickle.loads(pickle.dumps(whole))
    assert loaded.model is None
    _close(loaded.compute(), whole.compute(), 0)
    with pytest.raises(RuntimeError, match="assign `metric.model`"):
        loaded.update(torch.from_numpy(real), is_real=True)
    loaded.model = _Extractor(w)
    loaded.update(torch.from_numpy(real[:2]), is_real=True)
    # A deepcopy shares the extractor and copies every state.
    clone = copy.deepcopy(whole)
    assert clone.model is whole.model
    assert clone.real_cov_sum is not whole.real_cov_sum
    assert torch.equal(clone.real_cov_sum, whole.real_cov_sum)
    assert copy.copy(whole).model is whole.model


def test_fid_checks_and_no_autograd_graph():
    w = _projection()
    port, _ = _fid_pair(w)
    real, _ = _fid_images(3, 4)
    port.update(torch.from_numpy(real[:1]), is_real=True)
    port.update(torch.from_numpy(real[1:]), is_real=False)
    # The extractor has parameters that require grad; no state keeps a graph.
    assert not any(v.requires_grad for v in port.state_dict().values())
    with pytest.raises(RuntimeError, match="at least 2 real images, got 1"):
        port.compute()
    with pytest.raises(ValueError, match=r"\(num_images, 5\)"):
        tm.FrechetInceptionDistance(_Extractor(w), feature_dim=5, device="cpu").update(
            torch.from_numpy(real), is_real=True)
    with pytest.raises(ValueError, match="callable"):
        tm.FrechetInceptionDistance(None, feature_dim=4, device="cpu")
    with pytest.raises(ValueError, match="positive"):
        tm.FrechetInceptionDistance(_Extractor(w), feature_dim=0, device="cpu")
    with pytest.raises(ValueError, match="covariances"):
        tF.gaussian_frechet_distance(torch.zeros(3), torch.zeros(3, 2), torch.zeros(3),
                                     torch.zeros(3, 3))
    with pytest.raises(ValueError, match="mean vectors"):
        tF.gaussian_frechet_distance(torch.zeros(3), torch.zeros(3, 3), torch.zeros(2),
                                     torch.zeros(3, 3))


def test_image_input_checks_match_jax():
    x = torch.rand(2, 3, 16, 16)
    for fn, args, kw in [
        ("peak_signal_noise_ratio", (x, x[:1]), {}),
        ("peak_signal_noise_ratio", (x, x), {"data_range": -1.0}),
        ("peak_signal_noise_ratio", (x, x), {"data_range": "1"}),
        ("structural_similarity", (x, x[:1]), {}),
        ("structural_similarity", (x[0], x[0]), {}),
        ("structural_similarity", (x[..., :8], x[..., :8]), {}),
    ]:
        with pytest.raises(ValueError) as port_err:
            getattr(tF, fn)(*args, **kw)
        with pytest.raises(ValueError) as jax_err:
            getattr(jF, fn)(*(jnp.asarray(a.numpy()) for a in args), **kw)
        # Same message, shapes written as tuples in both.
        assert str(port_err.value).split(",")[0] == str(jax_err.value).split(",")[0]


@pytest.mark.parametrize("name", ["PeakSignalNoiseRatio", "StructuralSimilarity"])
@pytest.mark.parametrize("kw", [{}, {"data_range": 2.0}], ids=["default", "range"])
def test_classes_merge_and_load_as_jax(name, kw):
    pairs = [(getattr(tm, name)(device="cpu", **kw), getattr(jm, name)(**kw)) for _ in range(3)]
    for i in range(5):
        x, y = _images(30 + i, (2, 3, 24, 24))
        port, ref = pairs[i % 2]  # pairs[2] never updated
        port.update(torch.from_numpy(x), torch.from_numpy(y))
        ref.update(jnp.asarray(x), jnp.asarray(y))
    port, ref = pairs[0]
    port.merge_state([p for p, _ in pairs[1:]])
    ref.merge_state([j for _, j in pairs[1:]])
    for k, v in port.state_dict().items():
        assert v.dtype == torch.float32, k
        _close(v, np.asarray(getattr(ref, k)))
    _close(port.compute(), ref.compute())
    loaded = getattr(tm, name)(device="cpu", **kw)
    loaded.load_state_dict(state_from_jax({k: np.asarray(v) for k, v in ref.state_dict().items()}))
    _close(loaded.compute(), ref.compute())
    empty_port, empty_ref = getattr(tm, name)(device="cpu"), getattr(jm, name)()
    assert np.isnan(float(empty_port.compute())) and np.isnan(float(empty_ref.compute()))


def test_full_f32_restores_the_callers_settings():
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32)
    try:
        for on in (True, False):
            matmul.allow_tf32 = cudnn.allow_tf32 = on
            with full_f32():
                assert not matmul.allow_tf32 and not cudnn.allow_tf32
            assert matmul.allow_tf32 is on and cudnn.allow_tf32 is on
        with pytest.raises(ZeroDivisionError), full_f32():
            1 / 0
        assert matmul.allow_tf32 is False
        # The caller's generic precision stays readable after the block.
        torch.set_float32_matmul_precision("high")
        with full_f32():
            pass
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision("highest")
        matmul.allow_tf32, cudnn.allow_tf32 = saved


def test_full_f32_blocks_in_two_threads_share_one_save():
    """Thread A enters, thread B enters, A leaves: TF32 stays off for B,
    and B's exit puts back the settings from before A entered."""
    import threading

    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (matmul.allow_tf32, cudnn.allow_tf32)
    a_in, b_in, a_out, seen = threading.Event(), threading.Event(), threading.Event(), []

    def a():
        with full_f32():
            a_in.set()
            b_in.wait()
        a_out.set()

    def b():
        a_in.wait()
        with full_f32():
            b_in.set()
            a_out.wait()
            seen.append((matmul.allow_tf32, cudnn.allow_tf32))

    try:
        matmul.allow_tf32 = cudnn.allow_tf32 = True
        threads = [threading.Thread(target=f) for f in (a, b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert seen == [(False, False)]
        assert matmul.allow_tf32 is True and cudnn.allow_tf32 is True
    finally:
        matmul.allow_tf32, cudnn.allow_tf32 = saved


class TestImageClasses(MetricClassTester):
    def test_psnr_harness(self):
        batches = [_images(50 + i, (2, 3, 16, 16)) for i in range(8)]
        want = jm.PeakSignalNoiseRatio()
        for x, y in batches:
            want.update(jnp.asarray(x), jnp.asarray(y))
        self.run_class_implementation_tests(
            tm.PeakSignalNoiseRatio(device="cpu"),
            {"sum_squared_error", "num_observations", "target_min", "target_max"},
            {"input": [torch.from_numpy(x) for x, _ in batches],
             "target": [torch.from_numpy(y) for _, y in batches]},
            torch.tensor(np.asarray(want.compute())),
        )

    def test_ssim_harness(self):
        batches = [_images(60 + i, (2, 3, 16, 16)) for i in range(8)]
        want = jm.StructuralSimilarity()
        for x, y in batches:
            want.update(jnp.asarray(x), jnp.asarray(y))
        self.run_class_implementation_tests(
            tm.StructuralSimilarity(device="cpu"),
            {"mssim_sum", "num_images"},
            {"input": [torch.from_numpy(x) for x, _ in batches],
             "target": [torch.from_numpy(y) for _, y in batches]},
            torch.tensor(np.asarray(want.compute())),
        )
