"""``ops/token_nll.py`` on the CPU: the plain version of ``token_nll.cu``
against a float64 formula, its semantics at the edges (ignored, masked,
negative and out-of-vocabulary ids; infinite and NaN logits), and
``Perplexity`` through it bit for bit against the update it replaced.
The kernel itself runs in ``tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from torcheval_tpu_torch import routing
from torcheval_tpu_torch.metrics import MetricCollection, Perplexity
from torcheval_tpu_torch.metrics.functional import perplexity
from torcheval_tpu_torch.metrics.functional.text.perplexity import _perplexity_update_kernel
from torcheval_tpu_torch.ops import _build
from torcheval_tpu_torch.ops.token_nll import _token_nll_plain, token_nll
from torcheval_tpu_torch.telemetry import events

INF, NAN = float("inf"), float("nan")
DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _batch(rng, n, seq, vocab, dtype=torch.float32, pad=-100, pad_share=0.1):
    x = torch.from_numpy(rng.standard_normal((n, seq, vocab)).astype(np.float32)).to(dtype)
    t = rng.integers(0, vocab, (n, seq))
    t[rng.random((n, seq)) < pad_share] = pad
    return x, torch.from_numpy(t)


def _nll64(x, t):
    """float64 NLL of each token: logsumexp minus the gathered logit, at
    the clamped id, NaN past the vocabulary."""
    x = x.to(torch.float64)
    idx = t.to(torch.int64).clamp(0, x.shape[-1] - 1)
    picked = x.gather(-1, idx[..., None])[..., 0]
    picked = torch.where(t >= x.shape[-1], torch.full_like(picked, NAN), picked)
    return torch.logsumexp(x, -1) - picked


def _update_before(input, target, ignore_index, mask=None):
    """Perplexity's update as the port computed it before the token-NLL
    kernel: the plain version and its sums, verbatim."""
    logits = input.to(torch.float32)
    vocab = logits.shape[-1]
    index = target.to(torch.int64)
    token_logit = torch.gather(logits, -1, index.clamp(0, max(vocab - 1, 0))[..., None])[..., 0]
    token_logit = torch.where(index >= vocab, torch.full_like(token_logit, NAN), token_logit)
    token_ll = token_logit - torch.logsumexp(logits, dim=-1)
    if ignore_index is None:
        valid = torch.ones(target.shape, dtype=torch.float32, device=logits.device)
    else:
        valid = (target != ignore_index).to(torch.float32)
    if mask is not None:
        valid = valid * mask.to(torch.float32)[:, None]
    return -(token_ll * valid).sum(), valid.sum()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(2, 64, 1000), (3, 17, 50257)])
def test_plain_version_against_float64(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    x, t = _batch(rng, *shape, dtype=dtype, pad_share=0.0)
    _build.reset_counts()
    got = token_nll(x, t)
    assert got.dtype == torch.float32 and got.shape == shape[:2]
    assert dict(_build.PLAIN_CALLS) == {"token_nll": 1} and not _build.LAUNCHES
    # float32 logsumexp over V values of the same (dtype-rounded) logits:
    # a few float32 ulps of log(V) ~ 7-11.
    torch.testing.assert_close(got.to(torch.float64), _nll64(x, t), rtol=1e-6, atol=1e-5)


def test_negative_and_out_of_vocabulary_ids():
    x = torch.tensor([[[0.0, 1.0, 2.0, 3.0]] * 4])
    t = torch.tensor([[2, -1, -100, 4]])
    got = token_nll(x, t)
    lse = float(torch.logsumexp(x[0, 0], 0))
    # a negative id gathers logit 0; an id at or past V gives NaN
    assert torch.equal(got[0, :3], torch.tensor([lse - 2.0, lse, lse]))
    assert torch.isnan(got[0, 3])


def test_non_finite_logits_propagate_as_logsumexp():
    rows = torch.tensor([
        [0.0, 1.0, NAN, 2.0],     # NaN anywhere: NaN
        [0.0, INF, 1.0, -INF],    # +inf: lse +inf, and inf - x_t
        [-INF, -INF, -INF, -INF],  # all -inf: lse -inf, -inf - -inf is NaN
        [0.0, -INF, 1.0, 2.0],    # -inf among finite values adds nothing
        [INF, NAN, 0.0, 0.0],     # NaN beats +inf
        [0.0, INF, 0.0, 0.0],     # the target's logit is +inf: inf - inf
    ])
    t = torch.tensor([[0, 0, 0, 3, 2, 1]])
    got = token_nll(rows[None], t)[0]
    assert torch.isnan(got[0]) and got[1] == INF and torch.isnan(got[2])
    assert got[3] == pytest.approx(float(torch.logsumexp(torch.tensor([0.0, 1.0, 2.0]), 0)) - 2.0)
    assert torch.isnan(got[4]) and torch.isnan(got[5])
    assert torch.equal(got.isnan(), _nll64(rows[None], t)[0].isnan())


@pytest.mark.parametrize("ignore_index", [None, -100, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_update_equals_the_update_it_replaced_bit_for_bit(ignore_index, masked):
    rng = np.random.default_rng(5)
    x, t = _batch(rng, 5, 33, 211, pad=-100 if ignore_index is None else ignore_index)
    if ignore_index is None:
        t = t.abs()
    mask = torch.tensor([1, 0, 1, 1, 0], dtype=torch.int32) if masked else None
    got = _perplexity_update_kernel(x, t, ignore_index, mask=mask)
    want = _update_before(x, t, ignore_index, mask=mask)
    for g, w in zip(got, want):
        assert torch.equal(g, w), (g, w)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_perplexity_updates_and_merge_equal_the_replaced_path_bit_for_bit(dtype):
    rng = np.random.default_rng(7)
    batches = [_batch(rng, 2, 40, 300, dtype=dtype) for _ in range(6)]
    a, b = Perplexity(ignore_index=-100, device="cpu"), Perplexity(ignore_index=-100, device="cpu")
    s, c = torch.tensor(0.0), torch.tensor(0.0)
    s2, c2 = torch.tensor(0.0), torch.tensor(0.0)
    _build.reset_counts()
    for k, (x, t) in enumerate(batches):
        (a if k < 3 else b).update(x, t)
        ds, dc = _update_before(x, t, -100)
        if k < 3:
            s, c = s + ds, c + dc
        else:
            s2, c2 = s2 + ds, c2 + dc
    assert dict(_build.PLAIN_CALLS) == {"token_nll": 6} and not _build.LAUNCHES
    assert torch.equal(b.sum_log_probs, s2) and torch.equal(b.num_total, c2)
    a.merge_state([b])
    assert torch.equal(a.sum_log_probs, s + s2) and torch.equal(a.num_total, c + c2)
    assert torch.equal(a.compute(), torch.exp((s + s2) / (c + c2)))


def test_functional_perplexity_counts_one_plain_call():
    rng = np.random.default_rng(9)
    x, t = _batch(rng, 2, 16, 50, pad_share=0.0)
    _build.reset_counts()
    got = perplexity(x, t)
    assert dict(_build.PLAIN_CALLS) == {"token_nll": 1}
    assert float(got) == pytest.approx(float(torch.exp(_nll64(x, t).mean())), rel=1e-6)


def test_strided_rows_and_narrow_target_types():
    rng = np.random.default_rng(11)
    x, t = _batch(rng, 3, 10, 64, pad_share=0.0)
    wide = torch.cat([x, x], dim=-1)[..., :64]  # rows strided by 128
    assert not wide.is_contiguous() and wide.stride(-1) == 1
    want = token_nll(x, t)
    assert torch.equal(token_nll(wide, t), want)
    assert torch.equal(token_nll(x, t.to(torch.int32)), want)
    assert torch.equal(token_nll(x, t.to(torch.int16)), want)


@pytest.mark.parametrize("x_shape,t_shape", [((2, 3), (2, 3)), ((2, 3, 4), (2, 4)), ((2, 3, 4), (2, 3, 1))])
def test_shapes_that_do_not_match_raise(x_shape, t_shape):
    with pytest.raises(ValueError, match="token_nll takes"):
        token_nll(torch.zeros(x_shape), torch.zeros(t_shape, dtype=torch.int64))


def test_route_names_the_kernel():
    x, t = torch.zeros(1, 2, 5), torch.zeros(1, 2, dtype=torch.int64)
    assert routing.route_kernel(perplexity, x, t) == "token_nll"
    assert "token_nll.cu" in routing.explain_route(perplexity, x, t)


def test_the_kernel_range_lies_inside_the_member_update():
    rng = np.random.default_rng(13)
    col = MetricCollection({"ppl": Perplexity(ignore_index=-100, device="cpu")})
    batches = [_batch(rng, 2, 8, 40) for _ in range(3)]
    events.annotate(True)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for x, t in batches:
                col.update(x, t)
    finally:
        events.annotate(False)
    ranges = {}
    for e in prof.events():
        if e.name.startswith("torcheval_tpu_torch."):
            ranges.setdefault(e.name[len("torcheval_tpu_torch."):], []).append(e.time_range)
    assert len(ranges["update.kernel.token_nll"]) == len(batches)
    assert len(ranges["Perplexity[ppl].update"]) == len(batches)
    for inner, outer in zip(sorted(ranges["update.kernel.token_nll"], key=lambda r: r.start),
                            sorted(ranges["Perplexity[ppl].update"], key=lambda r: r.start)):
        assert outer.start <= inner.start and inner.end <= outer.end
