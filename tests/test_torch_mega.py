"""The one-pass collection kernel's plain version against the JAX
package's interpret-mode ``_mega_kernel`` on the same batches and plans:
2-D scores and 1-D inputs, masks, slices 3 and 16, labels out of range,
argmax ties and scores on the thresholds.  Every count is bit-equal.

NaN is the one place the two kernels differ by design: the port counts
it as the port's per-member paths do (``torch.argmax`` picks the first
NaN; a NaN binned score counts at every threshold), so NaN inputs are
held against the port's own per-member path instead."""

import os
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torcheval_tpu.metrics as J
from torcheval_tpu.ops import _mega_plan as jax_plan
from torcheval_tpu.ops import pallas_mega
from torcheval_tpu_torch import metrics as P
from torcheval_tpu_torch.ops import _build, _mega_plan, mega

C = 7


def multiclass(lib, **dev):
    return {
        "acc_micro": lib.MulticlassAccuracy(average="micro", **dev),
        "acc_macro": lib.MulticlassAccuracy(average="macro", num_classes=C, **dev),
        "prec_micro": lib.MulticlassPrecision(num_classes=C, average="micro", **dev),
        "prec_macro": lib.MulticlassPrecision(num_classes=C, average="macro", **dev),
        "rec_none": lib.MulticlassRecall(num_classes=C, average=None, **dev),
        "f1_macro": lib.MulticlassF1Score(num_classes=C, average="macro", **dev),
        "rec_micro": lib.MulticlassRecall(num_classes=C, **dev),
        "f1_micro": lib.MulticlassF1Score(num_classes=C, **dev),
        "cm": lib.MulticlassConfusionMatrix(num_classes=C, **dev),
    }


def binary(lib, **dev):
    return {
        "bacc": lib.BinaryAccuracy(threshold=0.4, **dev),
        "bprec": lib.BinaryPrecision(**dev),
        "brec": lib.BinaryRecall(**dev),
        "bf1": lib.BinaryF1Score(threshold=0.55, **dev),
        "bcm": lib.BinaryConfusionMatrix(threshold=0.6, **dev),
        "auroc": lib.BinaryBinnedAUROC(threshold=33, **dev),
        "auprc": lib.BinaryBinnedAUPRC(threshold=17, **dev),
    }


def _plans(members, x, y, mask, slices):
    kw = {} if mask is None else {"mask": mask}
    env = {"TORCHEVAL_TPU_MEGAKERNEL": "1", "TORCHEVAL_TPU_TORCH_MEGAKERNEL": "1"}
    with mock.patch.dict(os.environ, env):
        jm, pm = members(J), members(P, device="cpu")
        jp = jax_plan.plan_for(jm, (jnp.asarray(x), jnp.asarray(y)),
                               {k: jnp.asarray(v) for k, v in kw.items()}, slices)
        pp = _mega_plan.plan_for(pm, (torch.from_numpy(x), torch.from_numpy(y)),
                                 {k: torch.from_numpy(v) for k, v in kw.items()}, slices)
    assert jp is not None and pp is not None
    return jm, pm, jp, pp


def _port_counts(pm, pp, x, y, mask, sids):
    thr = [pm[mp.name].threshold for mp in pp.members if mp.kind == "binned"]
    t = lambda v: None if v is None else torch.from_numpy(v)  # noqa: E731
    return mega._mega_counts_plain(pp, torch.from_numpy(x), torch.from_numpy(y), t(mask),
                                   t(sids), thr)


def _assert_matches_jax(members, x, y, mask=None, sids=None, slices=None):
    jm, pm, jp, pp = _plans(members, x, y, mask, slices)
    thr = [jm[mp.name].threshold for mp in jp.members if mp.kind == "binned"]
    outs = pallas_mega._dispatch(
        jp, jnp.asarray(x), jnp.asarray(y), None if mask is None else jnp.asarray(mask),
        None if sids is None else jnp.asarray(sids), thr, interpret=True,
    )
    outs = [np.asarray(o) for o in outs]
    got = _port_counts(pm, pp, x, y, mask, sids)
    a = pp.a
    oi, col = 0, 0
    mom = None
    if any(mp.moment_slots for mp in jp.members):
        mom, oi = outs[0], 1
    for mp, (moments, main) in zip(pp.members, got):
        s = len(mp.moment_slots)
        if s:
            want = mom[:, col : col + s]
            col += s
            assert moments.dtype == torch.int32
            np.testing.assert_array_equal(moments.numpy(), want.astype(np.int64), mp.name)
        c = mp.num_classes
        if mp.kind == "scatter":
            want = outs[oi][:, :c].reshape(3, a, c)
            if mp.spec == "acc_macro":
                # The JAX kernel repeats the label counts as prediction
                # counts, which macro accuracy never reads; the port skips
                # them.
                want, main = want[:2], main[:2]
        elif mp.kind == "cm":
            cp = outs[oi].shape[1]
            want = outs[oi].reshape(a, cp, cp)[:, :c, :c]
        elif mp.kind == "binned":
            want = outs[oi][:, : mp.num_thresholds].reshape(2, a, mp.num_thresholds)
        else:
            continue
        oi += 1
        assert main.dtype == torch.int32
        np.testing.assert_array_equal(main.numpy(), want.astype(np.int64), mp.name)


def _batch(seed, n, f, classes, slices=None, masked=False):
    r = np.random.default_rng(seed)
    x = (r.standard_normal((n, f)) if f else r.random(n)).astype(np.float32)
    y = r.integers(0, classes, n).astype(np.int32)
    mask = (r.random(n) < 0.75).astype(np.int32) if masked else None
    sids = r.integers(0, slices, n).astype(np.int32) if slices else None
    return x, y, mask, sids


@pytest.mark.parametrize(
    "members,f,classes,slices,masked",
    [
        (multiclass, C, C, None, False),
        (multiclass, C, C, None, True),
        (multiclass, C, C, 3, True),
        (multiclass, C, C, 16, False),
        (binary, 0, 2, None, False),
        (binary, 0, 2, None, True),
        (binary, 0, 2, 3, True),
        (binary, 0, 2, 16, True),
    ],
)
def test_plain_counts_match_jax_kernel(members, f, classes, slices, masked):
    x, y, mask, sids = _batch(classes * 100 + (slices or 0), 150, f, classes, slices, masked)
    _assert_matches_jax(members, x, y, mask, sids, slices)


def test_labels_out_of_range_wrap_and_drop_as_jax():
    r = np.random.default_rng(11)
    n = 180
    x = r.standard_normal((n, C)).astype(np.float32)
    y = r.integers(-2 * C, 2 * C, n).astype(np.int32)
    _assert_matches_jax(multiclass, x, y, sids=r.integers(0, 3, n).astype(np.int32), slices=3)
    # 1-D integer predictions out of range too
    xi = r.integers(-2 * C, 2 * C, n).astype(np.int32)
    _assert_matches_jax(multiclass, xi, y)


def test_argmax_ties_break_to_the_lowest_index():
    r = np.random.default_rng(12)
    x = r.integers(0, 3, (200, C)).astype(np.float32)  # many tied maxima
    x[:5] = 1.0  # whole rows tied
    y = r.integers(0, C, 200).astype(np.int32)
    _assert_matches_jax(multiclass, x, y)
    pm = multiclass(P, device="cpu")
    _, _, _, pp = _plans(multiclass, x, y, None, None)
    (_, cm) = _port_counts(pm, pp, x, y, None, None)[-1]
    want = np.zeros((C, C), np.int64)
    np.add.at(want, (y, np.argmax(x, axis=1)), 1)
    np.testing.assert_array_equal(cm[0].numpy(), want)


def test_scores_equal_to_thresholds():
    grid33 = np.asarray(P.BinaryBinnedAUROC(threshold=33, device="cpu").threshold)
    r = np.random.default_rng(13)
    n = 190
    x = grid33[r.integers(0, 33, n)].astype(np.float32)
    x[:4] = [0.4, 0.55, 0.6, 0.5]
    y = r.integers(0, 2, n).astype(np.int32)
    _assert_matches_jax(binary, x, y, sids=r.integers(0, 3, n).astype(np.int32), slices=3)


def _states(col):
    return {k: v.clone() for k, v in col.state_dict().items()}


def _run(members, stream, flag, **kw):
    with mock.patch.dict(os.environ, {"TORCHEVAL_TPU_TORCH_MEGAKERNEL": flag}):
        col = P.MetricCollection(members(P, device="cpu"), **kw)
        _build.reset_counts()
        for x, y, sids in stream:
            col.fused_update(x, y, **({} if sids is None else {"slice_ids": sids}))
        calls = _build.PLAIN_CALLS["mega_counts"]
    return _states(col), calls


@pytest.mark.parametrize("members,f,slices", [(multiclass, C, None), (multiclass, C, 3),
                                              (binary, 0, 16)])
def test_nan_scores_count_as_the_per_member_path(members, f, slices):
    r = np.random.default_rng(14)
    stream = []
    for n in (60, 130, 90):
        x, y, _, sids = _batch(int(r.integers(1000)), n, f, C if f else 2, slices)
        if f:
            x[:3, 2] = np.nan
            x[3, [1, 4]] = np.nan
            x[4, :] = np.nan
        else:
            x[:6] = np.nan
        stream.append((torch.from_numpy(x), torch.from_numpy(y),
                       None if sids is None else torch.from_numpy(sids)))
    want, off_calls = _run(members, stream, "0", bucket=True, slices=slices)
    got, on_calls = _run(members, stream, "1", bucket=True, slices=slices)
    assert off_calls == 0 and on_calls == len(stream)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_wrapper_checks_and_empty_batch():
    x, y, _, _ = _batch(15, 50, C, C)
    _, _, _, pp = _plans(multiclass, x, y, None, None)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    empty = mega.mega_counts(pp, xt[:0], yt[:0])
    assert all(t is None or int(t.abs().sum()) == 0 for pair in empty for t in pair)
    with pytest.raises(ValueError, match="share the batch dim"):
        mega.mega_counts(pp, xt[:10], yt)
    with pytest.raises(ValueError, match="input"):
        mega.mega_counts(pp, xt[:, :3], yt)
    with pytest.raises(ValueError, match="mask must have shape"):
        mega.mega_counts(pp, xt, yt, mask=torch.ones(10, dtype=torch.int32))
    with pytest.raises(ValueError, match="slice ids must have shape"):
        mega.mega_counts(pp, xt, yt, sids=torch.zeros(10, dtype=torch.int32))
    _, _, _, bp = _plans(binary, x[:, 0].copy(), (y % 2).astype(np.int32), None, None)
    with pytest.raises(ValueError, match="threshold grid"):
        mega.mega_counts(bp, xt[:, 0], yt % 2, thresholds=[])
    with pytest.raises(ValueError, match="cuda or cpu"):
        mega.mega_counts(pp, xt.to("meta"), yt.to("meta"))
