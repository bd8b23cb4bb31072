"""The one-pass collection kernel's plain version against the JAX
package's interpret-mode ``_mega_kernel`` on the same batches and plans:
2-D scores and 1-D inputs, masks, slices 3 and 16, labels out of range,
argmax ties and scores on the thresholds.  Every count is bit-equal.

The kernel's launch plan (``mega.launch_plans``) is held here too: every
counter owned by one block column (member group), shared memory within
the H100's 227 KB, and a model of the kernel's work split (each block's
members over its warps' tiles, counted apart and summed) bit-equal to the
plain version and to the JAX kernel.

NaN is the one place the two kernels differ by design: the port counts
it as the port's per-member paths do (``torch.argmax`` picks the first
NaN; a NaN binned score counts at every threshold), so NaN inputs are
held against the port's own per-member path instead."""

import dataclasses
import os
import re
from pathlib import Path
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


def five(c):
    """The collection workload's five members at ``c`` classes."""

    def members(lib, **dev):
        return {
            "acc": lib.MulticlassAccuracy(num_classes=c, average="macro", **dev),
            "f1": lib.MulticlassF1Score(num_classes=c, average="macro", **dev),
            "cm": lib.MulticlassConfusionMatrix(num_classes=c, **dev),
            "prec": lib.MulticlassPrecision(num_classes=c, average="macro", **dev),
            "rec": lib.MulticlassRecall(num_classes=c, average="macro", **dev),
        }

    return members


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


def _assert_matches_jax(members, x, y, mask=None, sids=None, slices=None, counts=None):
    """The port's counts (the plain version, or ``counts(pm, pp, ...)``)
    against the JAX kernel's."""
    jm, pm, jp, pp = _plans(members, x, y, mask, slices)
    thr = [jm[mp.name].threshold for mp in jp.members if mp.kind == "binned"]
    outs = pallas_mega._dispatch(
        jp, jnp.asarray(x), jnp.asarray(y), None if mask is None else jnp.asarray(mask),
        None if sids is None else jnp.asarray(sids), thr, interpret=True,
    )
    outs = [np.asarray(o) for o in outs]
    got = (counts or _port_counts)(pm, pp, x, y, mask, sids)
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


# ------------------------------------------------------- the launch plan


def _regions(mp, a):
    """A member's (part, ints) regions, as ``mega._layout`` lays them."""
    moment = a * len(mp.moment_slots)
    main = _mega_plan.counters(mp, a) - moment
    return [(part, size) for part, size in (("moment", moment), ("main", main)) if size]


def _launches(pp, n, sms=132):
    for begin in range(0, len(pp.members), mega._MAX_MEMBERS):
        members = pp.members[begin : begin + mega._MAX_MEMBERS]
        yield begin, members, *mega._launch(n, pp.features, members, pp.a, True, sms)


def _block_counts(sms):
    """The kernel's work split as a counts function for
    ``_assert_matches_jax``: block b counts group b // sample_blocks's
    members over the tiles its warps walk (warp w of sample block sb:
    tiles sb * warps + w, then every sample_blocks * warps), each block apart
    with the plain version, the blocks' counts summed."""

    def counts(pm, pp, x, y, mask, sids):
        n = y.shape[0]
        total = [[None, None] for _ in pp.members]
        for begin, members, launch, _, _ in _launches(pp, n, sms):
            tiles = -(-n // 32)
            step = launch.sample_blocks * launch.warps
            for b in range(launch.blocks):
                g, sb = divmod(b, launch.sample_blocks)
                group = members[g * launch.group_members : (g + 1) * launch.group_members]
                rows = [
                    r
                    for w in range(launch.warps)
                    for tile in range(sb * launch.warps + w, tiles, step)
                    for r in range(32 * tile, min(32 * tile + 32, n))
                ]
                if not rows:
                    continue
                sub = dataclasses.replace(pp, members=tuple(group))
                pick = lambda v: None if v is None else v[rows]  # noqa: E731
                part = _port_counts(pm, sub, x[rows], y[rows], pick(mask), pick(sids))
                for j, pair in enumerate(part):
                    slot = total[begin + g * launch.group_members + j]
                    for k, t in enumerate(pair):
                        if t is not None:
                            slot[k] = t if slot[k] is None else slot[k] + t
        return [tuple(pair) for pair in total]

    return counts


def _assert_counts_equal(got, want):
    assert len(got) == len(want)
    for pair_got, pair_want in zip(got, want):
        for g, w in zip(pair_got, pair_want):
            assert (g is None) == (w is None)
            if g is not None:
                assert g.dtype == torch.int32 and torch.equal(g, w)


@pytest.mark.parametrize(
    "members,f,classes,n,slices,masked,sms",
    [
        (five(20), 20, 20, 313, 16, True, 132),  # a sliced-stream batch
        (five(20), 20, 20, 33, 16, True, 132),  # a tile and one sample
        (five(7), 7, 7, 4200, None, False, 3),  # a narrow collection update, image
        (binary, 0, 2, 4500, 3, True, 2),  # 1-D input, image
    ],
)
def test_block_partial_counts_sum_to_the_plain_version_and_jax(
    members, f, classes, n, slices, masked, sms
):
    x, y, mask, sids = _batch(n + classes, n, f, classes, slices, masked)
    _, pm, _, pp = _plans(members, x, y, mask, slices)
    model = _block_counts(sms)
    _assert_counts_equal(model(pm, pp, x, y, mask, sids), _port_counts(pm, pp, x, y, mask, sids))
    _assert_matches_jax(members, x, y, mask, sids, slices, counts=model)


def _many(lib, **dev):
    """70 members: a plan past the kernel's 64, launched twice."""
    return {f"acc{i}": lib.MulticlassAccuracy(num_classes=5, average="macro", **dev)
            for i in range(70)}


@pytest.mark.parametrize(
    "members,f,classes,n,slices",
    [
        (five(20), 20, 20, 1, 16),
        (five(20), 20, 20, 31, 16),
        (five(20), 20, 20, 512, 16),
        (five(20), 20, 20, 513, 16),
        (five(100), 100, 100, 65536, None),  # the collection update
        (five(256), 256, 256, 70_001, 3),  # the plan bounds F = C = 256
        (binary, 0, 2, 100_003, 16),
        (_many, 5, 5, 300, None),
        (_many, 5, 5, 9000, 2),
    ],
)
def test_launch_plan_owns_every_counter_once(members, f, classes, n, slices):
    x, y, _, _ = _batch(1, 64, f, classes, slices)
    with mock.patch.dict(os.environ, {"TORCHEVAL_TPU_TORCH_MEGAKERNEL": "1"}):
        pm = members(P, device="cpu")
        pp = _mega_plan.plan_for(pm, (torch.from_numpy(x), torch.from_numpy(y)), {}, slices)
    assert len(pp.members) == len(pm)
    launches = list(_launches(pp, n))
    assert len(launches) == -(-len(pp.members) // 64)
    assert [lp.describe() for lp in mega.launch_plans(pp, n)] == [
        lp.describe() for _, _, lp, _, _ in launches]
    for _, members_, launch, offsets, total in launches:
        assert launch.smem_bytes <= 232_448 and 1 <= launch.warps <= 16
        assert launch.groups * launch.group_members >= len(members_)
        assert launch.image == (n > mega._GLOBAL_MAX_SAMPLES)
        if launch.image:
            assert launch.groups == 1 and launch.image_ints > 0
        else:
            assert launch.group_members == 1 and launch.image_ints == 0
            assert launch.sample_blocks * launch.warps * 32 >= n
        if f:
            assert launch.smem_bytes == (
                mega._stage_offset(launch.image_ints) * 4 + launch.warps * 32 * 4 * f)
        owner = np.full(total, -1)
        for q, mp in enumerate(members_):
            for part, size in _regions(mp, pp.a):
                o = offsets[(q, part)]
                assert (owner[o : o + size] == -1).all()
                owner[o : o + size] = q // launch.group_members
                # the image holds whole regions only
                assert o + size <= launch.image_ints or o >= launch.image_ints
        assert (owner >= 0).all()


def test_plans_at_the_main_path_shapes():
    x, y, _, _ = _batch(2, 64, 100, 100)
    _, _, _, pp = _plans(five(100), x, y, None, None)
    (col,) = mega.launch_plans(pp, 65536)
    assert col.image and col.blocks == 132 and col.warps == 9 and col.copy == "16 B"
    assert col.image_ints == sum(size for mp in pp.members for _, size in _regions(mp, 1))
    x, y, mask, sids = _batch(3, 64, 20, 20, 16, True)
    _, _, _, sp = _plans(five(20), x, y, mask, 16)
    for n in (128, 313, 512):
        (sl,) = mega.launch_plans(sp, n)
        assert not sl.image and sl.groups == 5 and sl.sample_blocks == 1
        assert sl.warps == -(-n // 32)


def test_plan_constants_match_the_kernel_source():
    """The wrapper's copies of ``mega.cu``'s limits and ``Plan`` layout."""
    src = (Path(mega.__file__).parent / "csrc" / "mega.cu").read_text()
    const = dict(re.findall(r"constexpr int (k\w+) = ([^;]+);", src))
    assert int(const["kMaxWarps"]) == mega._MAX_WARPS
    assert int(const["kMaxMembers"]) == mega._MAX_MEMBERS
    assert int(const["kMaxSharedBytes"]) == mega._BLOCK_SMEM
    assert int(const["kMaxFeatures"]) == _mega_plan._MAX_FEATURES
    plan = src[src.index("struct Plan {") :]
    plan = plan[: plan.index("};")]
    assert len(re.findall(r"^  int \w+;", plan, re.M)) == mega._HEADER_WORDS
    desc = src[src.index("struct MemberDesc {") :]
    desc = desc[: desc.index("};")]
    assert len(re.findall(r"^  int \w+;", desc, re.M)) == mega._DESC_WORDS
    assert "(smem_ints + 3) & ~3" in src
    assert mega._stage_offset(5) == 8 and mega._stage_offset(8) == 8
