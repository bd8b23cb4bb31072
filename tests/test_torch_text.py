"""The port's text family (WER / WIP / WIL on strings, token ids and
logits; Perplexity; BLEU) against the JAX package on the same numpy-seeded
inputs.  Counter states are integer sums and must be exactly equal; the
float32 figures computed from them agree within 1e-6 relative (``exp`` and
``log`` are not bit-stable across the two frameworks), perplexity within
1e-5 relative (a float32 logsumexp over the vocabulary, summed in another
order).  The JAX device path runs its Pallas kernel in interpret mode
(``TORCHEVAL_TPU_WAVEFRONT=1``); the port, on CPU tensors, its plain
version."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torcheval_tpu import metrics as jm
from torcheval_tpu.metrics import functional as jF
from torcheval_tpu.metrics.text._tokens import WordInterner as JaxInterner
from torcheval_tpu.metrics.text._tokens import tokenize_pairs as jax_tokenize_pairs
from torcheval_tpu.ops import _mega_plan as jax_mega_plan
from torcheval_tpu_torch import metrics as tm
from torcheval_tpu_torch.convert import state_from_jax
from torcheval_tpu_torch.metrics import functional as tF
from torcheval_tpu_torch.metrics.text._tokens import (
    DEFAULT_MIN_TOKENS,
    PAD_ID,
    WordInterner,
    tokenize_pairs,
)
from torcheval_tpu_torch.ops import _build, _mega_plan
from torcheval_tpu_torch.telemetry import events
from torcheval_tpu_torch.utils.test_utils import MetricClassTester

RTOL = 1e-6
PPL_RTOL = 1e-5
_WORD_CLASSES = ("WordErrorRate", "WordInformationPreserved", "WordInformationLost")
_WORD_FUNCS = ("word_error_rate", "word_information_preserved", "word_information_lost")
_WORDS = [f"w{i}" for i in range(23)]


@pytest.fixture(autouse=True)
def _jax_wavefront_kernel(monkeypatch):
    monkeypatch.setenv("TORCHEVAL_TPU_WAVEFRONT", "1")


def _sentences(rng, n, lo=0, hi=12):
    return [" ".join(rng.choice(_WORDS, int(rng.integers(lo, hi + 1)))) for _ in range(n)]


def _string_batches(seed, batches=3, n=9):
    rng = np.random.default_rng(seed)
    return [(_sentences(rng, n), _sentences(rng, n, lo=1)) for _ in range(batches)]


def _logit_batches(seed, batches=3, n=5, seq=12, vocab=17):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(batches):
        logits = rng.standard_normal((n, seq, vocab)).astype(np.float32)
        target = rng.integers(0, vocab, (n, seq)).astype(np.int32)
        lens = rng.integers(0, seq + 1, n)
        target[np.arange(seq)[None, :] >= lens[:, None]] = -1
        out.append((logits, target))
    return out


def _np_state(metric):
    return {
        k: [np.asarray(a) for a in v] if isinstance(v, list) else np.asarray(v)
        for k, v in metric.state_dict().items()
    }


def _assert_states_equal(port, jax_metric):
    want = _np_state(jax_metric)
    got = port.state_dict()
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and w.dtype == np.float32
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)


def _close(got, want, rtol=RTOL):
    np.testing.assert_allclose(
        np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=rtol, atol=0,
        equal_nan=True,
    )


# ------------------------------------------------------------------ WER family


@pytest.mark.parametrize("name", _WORD_CLASSES)
def test_word_classes_on_strings(name):
    port, ref = getattr(tm, name)(device="cpu"), getattr(jm, name)()
    assert np.isnan(float(port.compute())) and np.isnan(float(ref.compute()))
    for hyp, refs in _string_batches(1):
        port.update(hyp, refs)
        ref.update(hyp, refs)
    _assert_states_equal(port, ref)
    _close(port.compute(), ref.compute())
    assert port.compute().dtype == torch.float32


@pytest.mark.parametrize("name", _WORD_CLASSES)
def test_word_classes_on_token_ids(name):
    port, ref = getattr(tm, name)(device="cpu"), getattr(jm, name)()
    strings = getattr(jm, name)()
    it_port, it_jax = WordInterner(), JaxInterner()
    _build.reset_counts()
    for hyp, refs in _string_batches(2):
        port.update(*tokenize_pairs(hyp, refs, interner=it_port))
        ref.update(*jax_tokenize_pairs(hyp, refs, interner=it_jax))
        strings.update(hyp, refs)
    assert dict(_build.PLAIN_CALLS) == {"edit_distance_tokens": 3} and not _build.LAUNCHES
    _assert_states_equal(port, ref)
    _assert_states_equal(port, strings)  # the tokenized path counts what strings count
    _close(port.compute(), ref.compute())


@pytest.mark.parametrize("name", _WORD_CLASSES)
def test_word_classes_on_logits(name):
    port, ref = getattr(tm, name)(device="cpu"), getattr(jm, name)()
    for logits, target in _logit_batches(3):
        port.update(torch.from_numpy(logits), torch.from_numpy(target))
        ref.update(jnp.asarray(logits), jnp.asarray(target))
    _assert_states_equal(port, ref)
    _close(port.compute(), ref.compute())


@pytest.mark.parametrize("name", _WORD_FUNCS)
@pytest.mark.parametrize("flavour", ["strings", "ids", "logits"])
def test_word_functionals(name, flavour):
    if flavour == "strings":
        hyp, refs = _string_batches(4, batches=1)[0]
        got, want = getattr(tF, name)(hyp, refs), getattr(jF, name)(hyp, refs)
    elif flavour == "ids":
        hyp, refs = tokenize_pairs(*_string_batches(5, batches=1)[0])
        got = getattr(tF, name)(torch.from_numpy(hyp), torch.from_numpy(refs))
        want = getattr(jF, name)(jnp.asarray(hyp), jnp.asarray(refs))
    else:
        logits, target = _logit_batches(6, batches=1)[0]
        got = getattr(tF, name)(torch.from_numpy(logits), torch.from_numpy(target))
        want = getattr(jF, name)(jnp.asarray(logits), jnp.asarray(target))
    assert got.dtype == torch.float32 and got.shape == ()
    _close(got, want)


def test_single_string_pair_and_empty_reference():
    _close(tF.word_error_rate("a b c", "a x c d"), jF.word_error_rate("a b c", "a x c d"))
    assert np.isnan(float(tF.word_error_rate([""], [""])))
    assert np.isnan(float(jF.word_error_rate([""], [""])))


def test_word_stats_mask_and_merge():
    hyp, refs = tokenize_pairs(*_string_batches(7, batches=1, n=12)[0])
    mask = (np.arange(12) % 3 != 0).astype(np.int32)
    port, ref = tm.WordErrorRate(device="cpu"), jm.WordErrorRate()
    port.update(torch.from_numpy(hyp), torch.from_numpy(refs), mask=torch.from_numpy(mask))
    ref.update(jnp.asarray(hyp), jnp.asarray(refs), mask=jnp.asarray(mask))
    _assert_states_equal(port, ref)
    live = mask.astype(bool)
    kept = tm.WordErrorRate(device="cpu").update(
        torch.from_numpy(hyp[live]), torch.from_numpy(refs[live])
    )
    assert port.state_dict().keys() == kept.state_dict().keys()
    for k, v in kept.state_dict().items():
        assert torch.equal(port.state_dict()[k], v)
    with pytest.raises(ValueError, match="mask= requires tokenized"):
        port.update(["a"], ["a"], mask=torch.ones(1))

    parts = [tm.WordInformationLost(device="cpu") for _ in range(3)]
    jparts = [jm.WordInformationLost() for _ in range(3)]
    for p, j, (h, r) in zip(parts, jparts, _string_batches(8)):
        p.update(h, r)
        j.update(h, r)
    parts[0].merge_state(parts[1:])
    jparts[0].merge_state(jparts[1:])
    _assert_states_equal(parts[0], jparts[0])
    _close(parts[0].compute(), jparts[0].compute())


@pytest.mark.parametrize(
    "make",
    [
        lambda: (np.zeros((2, 3), np.int32), np.zeros((2, 3), np.float32)),
        lambda: (np.zeros((2, 3), np.int32), np.zeros((2, 3, 1), np.int32)),
        lambda: (np.zeros((2, 3, 4), np.int32), np.zeros((2, 3), np.int32)),
        lambda: (np.zeros((2, 4, 5), np.float32), np.zeros((2, 3), np.int32)),
        lambda: (np.zeros((2, 3), np.float32), np.zeros((2, 3), np.int32)),
        lambda: (np.zeros((3, 3), np.int32), np.zeros((2, 3), np.int32)),
        lambda: (np.zeros((3,), np.int32), np.zeros((3, 2), np.int32)),
    ],
    ids=["float target", "3-D target", "int logits", "leading dims", "float ids",
         "counts differ", "1-D input"],
)
def test_token_check_errors_match_jax(make):
    inp, target = make()
    with pytest.raises(ValueError) as jax_err:
        jm.WordErrorRate().update(jnp.asarray(inp), jnp.asarray(target))
    with pytest.raises(ValueError) as port_err:
        tm.WordErrorRate(device="cpu").update(torch.from_numpy(inp), torch.from_numpy(target))
    assert str(port_err.value) == str(jax_err.value)


def test_string_validation_errors_match_jax():
    for args in ((["a", "b"], ["a"]), (3, ["a"])):
        with pytest.raises(ValueError) as jax_err:
            jF.word_error_rate(*args)
        with pytest.raises(ValueError) as port_err:
            tF.word_error_rate(*args)
        assert str(port_err.value) == str(jax_err.value)
        with pytest.raises(ValueError) as tok_err:
            tokenize_pairs(*args)
        assert str(tok_err.value) == str(jax_err.value)


def test_argmax_tie_and_nan_rows():
    # A tie takes the first maximum and a NaN row the first NaN, in both.
    logits = np.zeros((2, 4, 5), np.float32)
    logits[0, 0, [1, 3]] = 2.0  # tie: id 1
    logits[0, 1, 2] = np.nan  # NaN beats everything: id 2
    logits[0, 1, 4] = 9.0
    logits[0, 2, [0, 4]] = np.nan  # two NaNs: id 0
    logits[1, :, 3] = 1.0
    target = np.asarray([[1, 2, 0, 4], [3, 3, -1, -1]], np.int32)
    port, ref = tm.WordErrorRate(device="cpu"), jm.WordErrorRate()
    port.update(torch.from_numpy(logits), torch.from_numpy(target))
    ref.update(jnp.asarray(logits), jnp.asarray(target))
    _assert_states_equal(port, ref)
    assert port.state_dict()["errors"].item() == 1.0  # only [0, 3]: argmax 0, target 4
    assert port.state_dict()["input_total"].item() == 6.0


# ------------------------------------------------------------------- _tokens


def test_tokenize_pairs_equals_jax_element_for_element():
    it_port, it_jax = WordInterner(), JaxInterner()
    for hyp, refs in _string_batches(9, batches=3, n=7) + [(["a " * 40], ["b"])]:
        got = tokenize_pairs(hyp, refs, interner=it_port)
        want = jax_tokenize_pairs(hyp, refs, interner=it_jax)
        for g, w in zip(got, want):
            assert isinstance(g, np.ndarray) and g.dtype == np.int32
            np.testing.assert_array_equal(g, w)
    assert len(it_port) == len(it_jax)
    hyp, refs = tokenize_pairs(["a b"], ["c"], min_tokens=4)
    assert hyp.shape == refs.shape == (1, 4) and hyp[0, 2] == PAD_ID
    assert DEFAULT_MIN_TOKENS == 16 and tokenize_pairs([], [])[0].shape == (0, 16)


# ---------------------------------------------------------------- Perplexity


@pytest.mark.parametrize("ignore_index", [None, -1, 3])
def test_perplexity_class_and_functional(ignore_index):
    port = tm.Perplexity(ignore_index=ignore_index, device="cpu")
    ref = jm.Perplexity(ignore_index=ignore_index)
    assert np.isnan(float(port.compute())) and np.isnan(float(ref.compute()))
    batches = _logit_batches(10, vocab=33)
    for logits, target in batches:
        if ignore_index != -1:
            target = np.abs(target)  # no pads unless they are ignored
        port.update(torch.from_numpy(logits), torch.from_numpy(target))
        ref.update(jnp.asarray(logits), jnp.asarray(target))
    got, want = port.state_dict(), _np_state(ref)
    np.testing.assert_array_equal(got["num_total"].numpy(), want["num_total"])
    _close(got["sum_log_probs"], want["sum_log_probs"], PPL_RTOL)
    _close(port.compute(), ref.compute(), PPL_RTOL)
    logits, target = batches[0]
    target = np.abs(target) if ignore_index != -1 else target
    _close(
        tF.perplexity(torch.from_numpy(logits), torch.from_numpy(target), ignore_index),
        jF.perplexity(jnp.asarray(logits), jnp.asarray(target), ignore_index),
        PPL_RTOL,
    )


def test_perplexity_negative_targets_mask_and_merge():
    (logits, target), (logits2, target2) = _logit_batches(11, batches=2, vocab=9)
    mask = np.asarray([1, 0, 1, 1, 0], np.int32)
    # Negative targets that are NOT ignored gather logit 0, as in JAX.
    port, ref = tm.Perplexity(device="cpu"), jm.Perplexity()
    port.update(torch.from_numpy(logits), torch.from_numpy(target), mask=torch.from_numpy(mask))
    ref.update(jnp.asarray(logits), jnp.asarray(target), mask=jnp.asarray(mask))
    assert port.state_dict()["num_total"].item() == 3 * logits.shape[1]
    other, jother = tm.Perplexity(device="cpu"), jm.Perplexity()
    other.update(torch.from_numpy(logits2), torch.from_numpy(target2))
    jother.update(jnp.asarray(logits2), jnp.asarray(target2))
    port.merge_state([other])
    ref.merge_state([jother])
    np.testing.assert_array_equal(
        port.state_dict()["num_total"].numpy(), _np_state(ref)["num_total"]
    )
    _close(port.compute(), ref.compute(), PPL_RTOL)


def test_perplexity_float64_oracle_and_bf16_logits():
    logits, target = _logit_batches(12, batches=1, vocab=40)[0]
    target = np.abs(target)
    x = logits.astype(np.float64)
    lse = np.log(np.exp(x - x.max(-1, keepdims=True)).sum(-1)) + x.max(-1)
    nll = lse - np.take_along_axis(x, target[..., None].astype(np.int64), -1)[..., 0]
    _close(tF.perplexity(torch.from_numpy(logits), torch.from_numpy(target)),
           np.exp(nll.mean()), PPL_RTOL)
    half = torch.from_numpy(logits).to(torch.bfloat16)
    _close(tF.perplexity(half, torch.from_numpy(target)),
           jF.perplexity(jnp.asarray(logits).astype(jnp.bfloat16), jnp.asarray(target)),
           PPL_RTOL)


def test_perplexity_target_past_the_vocabulary_is_nan_as_in_jax():
    logits = np.zeros((1, 2, 4), np.float32)
    target = np.asarray([[1, 4]], np.int32)
    got = tF.perplexity(torch.from_numpy(logits), torch.from_numpy(target))
    want = jF.perplexity(jnp.asarray(logits), jnp.asarray(target))
    assert np.isnan(float(got)) and np.isnan(float(want))


@pytest.mark.parametrize(
    "in_shape,t_shape", [((2, 3), (2, 3)), ((2, 3, 4), (2, 3, 1)), ((2, 3, 4), (2, 4))]
)
def test_perplexity_input_check_matches_jax(in_shape, t_shape):
    inp, target = np.zeros(in_shape, np.float32), np.zeros(t_shape, np.int32)
    with pytest.raises(ValueError) as jax_err:
        jF.perplexity(jnp.asarray(inp), jnp.asarray(target))
    with pytest.raises(ValueError) as port_err:
        tF.perplexity(torch.from_numpy(inp), torch.from_numpy(target))
    assert str(port_err.value) == str(jax_err.value)


# ---------------------------------------------------------------------- BLEU


def _bleu_batches(seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(3):
        cands = _sentences(rng, 6, lo=1, hi=14)
        refs = []
        for c in cands:
            words = c.split()
            near = [w if rng.random() < 0.8 else str(rng.choice(_WORDS)) for w in words]
            refs.append([" ".join(near), " ".join(words[: max(1, len(words) - 2)])])
        out.append((cands, refs))
    return out


@pytest.mark.parametrize("n_gram,weights", [(4, None), (2, [0.7, 0.3]), (3, None), (1, [1.0])])
def test_bleu_class_and_functional(n_gram, weights):
    port = tm.BLEUScore(n_gram=n_gram, weights=weights, device="cpu")
    ref = jm.BLEUScore(n_gram=n_gram, weights=weights)
    assert float(port.compute()) == float(ref.compute()) == 0.0
    batches = _bleu_batches(13)
    for cands, refs in batches:
        port.update(cands, refs)
        ref.update(cands, refs)
    _assert_states_equal(port, ref)
    _close(port.compute(), ref.compute())
    cands, refs = batches[0]
    got = tF.bleu_score(cands, refs, n_gram=n_gram, weights=weights)
    assert got.dtype == torch.float32
    _close(got, jF.bleu_score(cands, refs, n_gram=n_gram, weights=weights))
    others = [tm.BLEUScore(n_gram=n_gram, weights=weights, device="cpu") for _ in range(2)]
    jothers = [jm.BLEUScore(n_gram=n_gram, weights=weights) for _ in range(2)]
    for o, j, (c, r) in zip(others, jothers, batches[1:]):
        o.update(c, r)
        j.update(c, r)
    others[0].merge_state(others[1:])
    jothers[0].merge_state(jothers[1:])
    _assert_states_equal(others[0], jothers[0])
    _close(others[0].compute(), jothers[0].compute())


def test_bleu_single_strings_no_match_and_brevity():
    for cand, ref in [
        ("the cat sat on the mat", "the cat sat on the mat"),
        ("the cat", "the cat sat on the mat today"),  # brevity penalty
        ("x y z w", "a b c d"),  # no match: 0
        ("a b c", ["a b c d", "a b"]),
    ]:
        _close(tF.bleu_score(cand, ref, n_gram=2), jF.bleu_score(cand, ref, n_gram=2))
    assert float(tF.bleu_score("x y z w", "a b c d")) == 0.0


def test_bleu_param_check_order_and_warning():
    # len(weights) is checked before non-negativity, as in JAX.
    for kwargs in (
        {"n_gram": 0},
        {"n_gram": 2, "weights": [-1.0]},
        {"n_gram": 2, "weights": [-1.0, 2.0]},
        {"n_gram": 2, "weights": [0.0, 0.0]},
    ):
        with pytest.raises(ValueError) as jax_err:
            jF.bleu_score("a b", "a b", **kwargs)
        with pytest.raises(ValueError) as port_err:
            tF.bleu_score("a b", "a b", **kwargs)
        assert str(port_err.value) == str(jax_err.value)
        with pytest.raises(ValueError) as class_err:
            tm.BLEUScore(device="cpu", **kwargs)
        assert str(class_err.value) == str(jax_err.value)
    with pytest.warns(UserWarning) as jax_warned:
        want = jF.bleu_score("a b c", "a b d", n_gram=2, weights=[2.0, 2.0])
    with pytest.warns(UserWarning) as port_warned:
        got = tF.bleu_score("a b c", "a b d", n_gram=2, weights=[2.0, 2.0])
    assert str(port_warned[0].message) == str(jax_warned[0].message)
    assert port_warned[0].filename == __file__
    _close(got, want)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tF.bleu_score("a b c", "a b d", n_gram=2, weights=[0.5, 0.5])
    for args in ((["a", "b"], "a"), (["a"], ["a", "b"]), (["a"], [[]])):
        with pytest.raises(ValueError) as jax_err:
            jF.bleu_score(*args)
        with pytest.raises(ValueError) as port_err:
            tF.bleu_score(*args)
        assert str(port_err.value) == str(jax_err.value)


# ------------------------------------------------- state_dict carried across


def _fed_jax_metrics():
    strings = _string_batches(14)
    logits = _logit_batches(15)
    bleu = _bleu_batches(16)
    out = {}
    for name in _WORD_CLASSES:
        out[name] = (getattr(jm, name)(), strings, {})
    out["Perplexity"] = (jm.Perplexity(ignore_index=-1), logits, {"ignore_index": -1})
    out["BLEUScore"] = (jm.BLEUScore(n_gram=3), bleu, {"n_gram": 3})
    for metric, batches, _ in out.values():
        for a, b in batches:
            metric.update(a, b)
    return out


@pytest.mark.parametrize("name", _WORD_CLASSES + ("Perplexity", "BLEUScore"))
def test_jax_state_dict_loads_into_the_port(name):
    ref, _, kwargs = _fed_jax_metrics()[name]
    port = getattr(tm, name)(device="cpu", **kwargs)
    port.load_state_dict(state_from_jax(_np_state(ref)))
    _assert_states_equal(port, ref)
    _close(port.compute(), ref.compute(), PPL_RTOL if name == "Perplexity" else RTOL)


# ------------------------------------------------------- placement and plan


def test_numpy_input_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU: numpy input runs there")
    ids = np.zeros((2, 3), np.int32)
    logits = np.zeros((2, 3, 4), np.float32)
    for fn, args in [
        (tF.word_error_rate, (ids, ids)),
        (tF.word_information_preserved, (ids, ids)),
        (tF.word_information_lost, (logits, ids)),
        (tF.perplexity, (logits, ids)),
    ]:
        with pytest.raises(RuntimeError, match="pass CPU tensors"):
            fn(*args)
    for cls in (tm.WordErrorRate, tm.Perplexity, tm.BLEUScore):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            cls()


def test_text_members_are_left_to_their_own_update_in_both_plans(monkeypatch):
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "1")
    monkeypatch.setenv("TORCHEVAL_TPU_MEGAKERNEL", "1")
    logits, target = _logit_batches(17, batches=1)[0]

    def members(mod, **kw):
        return {
            "ppl": mod.Perplexity(**kw),
            "wer": mod.WordErrorRate(**kw),
            "wil": mod.WordInformationLost(**kw),
            "mean": mod.Mean(**kw),
            "acc": mod.MulticlassAccuracy(**kw),
        }

    port_plan = _mega_plan.plan_for(
        members(tm, device="cpu"), (torch.from_numpy(logits), torch.from_numpy(target)), {}, None
    )
    jax_plan = jax_mega_plan.plan_for(
        members(jm), (jnp.asarray(logits), jnp.asarray(target)), {}, None
    )
    assert port_plan is None and jax_plan is None  # (n, seq, vocab) is no plan's shape
    # At a shape the plans do take, the text and aggregation members stay out.
    scores = torch.from_numpy(logits[:, 0, :])
    labels = torch.from_numpy(np.abs(target[:, 0]))
    port_plan = _mega_plan.plan_for(members(tm, device="cpu"), (scores, labels), {}, None)
    jax_plan = jax_mega_plan.plan_for(
        members(jm), (jnp.asarray(scores.numpy()), jnp.asarray(labels.numpy())), {}, None
    )
    assert set(port_plan.member_names) == set(jax_plan.member_names) == {"acc"}
    assert set(port_plan.unsupported) == set(jax_plan.unsupported) == {
        "ppl", "wer", "wil", "mean"
    }


def test_collection_of_perplexity_and_wer_shares_the_logits_signature():
    col = tm.MetricCollection(
        {"ppl": tm.Perplexity(ignore_index=-1, device="cpu"), "wer": tm.WordErrorRate(device="cpu")}
    )
    jcol = jm.MetricCollection(
        {"ppl": jm.Perplexity(ignore_index=-1), "wer": jm.WordErrorRate()}, donate=False
    )
    for logits, target in _logit_batches(18):
        col.update(torch.from_numpy(logits), torch.from_numpy(target))
        jcol.update(jnp.asarray(logits), jnp.asarray(target))
    got, want = col.compute(), jcol.compute()
    _close(got["wer"], want["wer"])
    _close(got["ppl"], want["ppl"], PPL_RTOL)
    sd = {k: np.asarray(v) for k, v in jcol.state_dict().items()}
    for k in ("wer/errors", "wer/target_total", "wer/input_total", "ppl/num_total"):
        np.testing.assert_array_equal(col.state_dict()[k].numpy(), sd[k])


def test_telemetry_spans_wrap_the_new_classes(monkeypatch):
    monkeypatch.setattr(events, "ENABLED", True)
    events.clear()
    tm.WordErrorRate(device="cpu").update(["a b"], ["a c"]).compute()
    tm.BLEUScore(device="cpu").update("a b", "a b").compute()
    logits, target = _logit_batches(19, batches=1)[0]
    tm.Perplexity(device="cpu").update(torch.from_numpy(logits), torch.from_numpy(target)).compute()
    seen = [(s.name, s.phase) for s in events.events("span")]
    events.clear()
    # Perplexity's counters go through _fuse.accumulate: its dispatch span
    # ends inside the update span.
    assert seen == [
        ("WordErrorRate", "update"), ("WordErrorRate", "compute"),
        ("BLEUScore", "update"), ("BLEUScore", "compute"),
        ("_perplexity_update_kernel", "dispatch"),
        ("Perplexity", "update"), ("Perplexity", "compute"),
    ]


class TestWordErrorRateClass(MetricClassTester):
    def test_class_harness_on_a_local_world(self):
        interner = WordInterner()
        batches = [tokenize_pairs(h, r, interner=interner)
                   for h, r in _string_batches(20, batches=8, n=6)]
        want = jm.WordErrorRate()
        for hyp, refs in batches:
            want.update(jnp.asarray(hyp), jnp.asarray(refs))
        self.run_class_implementation_tests(
            tm.WordErrorRate(device="cpu"),
            {"errors", "target_total", "input_total"},
            {
                "input": [torch.from_numpy(h) for h, _ in batches],
                "target": [torch.from_numpy(r) for _, r in batches],
            },
            torch.tensor(np.asarray(want.compute())),
            rtol=RTOL,
            device="cpu",
        )
