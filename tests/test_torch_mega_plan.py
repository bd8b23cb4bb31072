"""The port's collection-kernel plan against the JAX package's: the same
members, specs, moment slots, thresholds and widths, and the same
unsupported list, for the multiclass set, the binary + binned set and a
mixed set; and the port's own engage rules (auto mode on the GPU with two
supported members, forced on or off)."""

import jax
import jax.numpy as jnp
import pytest
import torch

import torcheval_tpu.metrics as J
from torcheval_tpu.ops import _mega_plan as jax_plan
from torcheval_tpu_torch import metrics as P
from torcheval_tpu_torch.ops import _mega_plan

C = 7


def multiclass(lib, **dev):
    return {
        "acc_micro": lib.MulticlassAccuracy(average="micro", **dev),
        "acc_macro": lib.MulticlassAccuracy(average="macro", num_classes=C, **dev),
        "prec_micro": lib.MulticlassPrecision(num_classes=C, average="micro", **dev),
        "prec_macro": lib.MulticlassPrecision(num_classes=C, average="macro", **dev),
        "rec_none": lib.MulticlassRecall(num_classes=C, average=None, **dev),
        "f1_macro": lib.MulticlassF1Score(num_classes=C, average="macro", **dev),
        "f1_micro": lib.MulticlassF1Score(num_classes=C, **dev),
        "rec_micro": lib.MulticlassRecall(num_classes=C, **dev),
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
        "tasks2": lib.BinaryBinnedAUROC(num_tasks=2, threshold=5, **dev),
    }


def mixed(lib, **dev):
    d = multiclass(lib, **dev)
    d["topk"] = lib.MulticlassAccuracy(average="micro", num_classes=C, k=2, **dev)
    d["wide"] = lib.MulticlassAccuracy(average="macro", num_classes=300, **dev)
    d["auroc"] = lib.MulticlassAUROC(num_classes=C, **dev)
    d["bacc"] = lib.BinaryAccuracy(**dev)
    return d


def _summary(plan):
    assert plan is not None
    return (
        [
            (mp.name, mp.kind, mp.spec, mp.threshold, mp.num_classes, mp.num_thresholds,
             tuple(mp.moment_slots))
            for mp in plan.members
        ],
        tuple(plan.unsupported),
        plan.features, plan.a, plan.slices, plan.needs_scores, plan.needs_pred,
    )


@pytest.mark.parametrize(
    "members,shape,idtype,slices",
    [
        (multiclass, (64, C), "float32", None),
        (multiclass, (64, C), "bfloat16", 16),
        (multiclass, (64,), "int32", 3),
        (binary, (64,), "float32", None),
        (binary, (64,), "int32", 16),
        (mixed, (64, C), "float32", None),
        (mixed, (64,), "int32", None),
    ],
)
def test_plan_matches_jax(monkeypatch, members, shape, idtype, slices):
    monkeypatch.setenv("TORCHEVAL_TPU_MEGAKERNEL", "1")
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "1")
    want = jax_plan.plan_for(
        members(J),
        (jax.ShapeDtypeStruct(shape, getattr(jnp, idtype)),
         jax.ShapeDtypeStruct((64,), jnp.int32)),
        {"mask": jax.ShapeDtypeStruct((64,), jnp.int32)},
        slices,
    )
    got = _mega_plan.plan_for(
        members(P, device="cpu"),
        (torch.zeros(shape, dtype=getattr(torch, idtype)), torch.zeros(64, dtype=torch.int32)),
        {"mask": torch.ones(64, dtype=torch.int32)},
        slices,
    )
    assert _summary(got) == _summary(want)
    assert got.n == want.n == 64
    assert got.member_names == want.member_names


def _plan(members, x, slices=None, **kw):
    return _mega_plan.plan_for(members, (x, torch.zeros(x.shape[0], dtype=torch.int32)), kw,
                               slices)


def test_auto_mode_needs_the_gpu_and_two_members(monkeypatch):
    monkeypatch.delenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", raising=False)
    x = torch.zeros(64, C)
    two = {k: v for k, v in multiclass(P, device="cpu").items() if k in ("acc_macro", "cm")}
    one = {"cm": P.MulticlassConfusionMatrix(num_classes=C, device="cpu")}
    assert _plan(two, x) is None  # the states live on the CPU
    monkeypatch.setattr(_mega_plan, "_same_device", lambda metrics: torch.device("cuda"))
    assert _plan(two, x).member_names == {"acc_macro", "cm"}
    assert _plan(one, x) is None  # one supported member is not enough
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "1")
    assert _plan(one, x).member_names == {"cm"}


def test_forced_off_and_unsupported_calls_decline(monkeypatch):
    members = multiclass(P, device="cpu")
    x = torch.zeros(64, C)
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "0")
    assert _plan(members, x) is None
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "on")
    assert _plan(members, x) is not None
    # a width that matches no member's class count declines each of them
    only_counts = {k: members[k] for k in ("acc_macro", "cm", "f1_macro")}
    assert _plan(only_counts, torch.zeros(64, C + 1)) is None
    # float targets, empty batches, a mask of another length, extra kwargs
    assert _mega_plan.plan_for(members, (x, torch.zeros(64)), {}, None) is None
    assert _plan(members, torch.zeros(0, C)) is None
    assert _plan(members, x, mask=torch.ones(63)) is None
    assert _plan(members, x, weight=torch.ones(64)) is None
    # members on two devices
    split = dict(members, other=P.MulticlassConfusionMatrix(num_classes=C, device="meta"))
    assert _plan(split, x) is None


def test_counters_bound(monkeypatch):
    monkeypatch.setenv("TORCHEVAL_TPU_TORCH_MEGAKERNEL", "1")
    cm = {"cm": P.MulticlassConfusionMatrix(num_classes=256, device="cpu")}
    x = torch.zeros(64, 256)
    assert _plan(cm, x, slices=30000) is not None  # 30001 * 256^2 < 2^31
    assert _plan(cm, x, slices=40000) is None
