r"""State plan of the one-pass collection kernel (the port of
``torcheval_tpu/ops/_mega_plan.py``).

:func:`plan_for` walks a :class:`~torcheval_tpu_torch.metrics.collection
.MetricCollection`'s members and classifies each one's state update into
one of four accumulation shapes that ``ops/mega.py`` counts in ONE pass
over the batch:

* **moment**: masked scalar sums (micro accuracy / precision / recall /
  F1, the binary counter families);
* **scatter**: the per-class marginal trio of macro accuracy and of the
  macro / weighted / per-class precision, recall and F1, with the
  members' own wrap-then-drop treatment of out-of-range labels;
* **cm**: the (C, C) confusion-matrix slab (``_wrap_labels`` semantics);
* **binned**: the binary binned-AUC threshold counts (``pred = score >=
  t``), and a sketch-mode ``BinaryAUROC`` / ``BinaryAUPRC``
  (``metrics/_rank_state.py``), whose states are the same edges and four
  count arrays.

Classification is exact-type (``type(m) is``), the payload specs, the
moment slots and the member order are the JAX package's, so the two
packages plan the same members for the same collection.  Anything else
(top-k, multilabel, float targets, buffer states) is listed in
``plan.unsupported`` and keeps its per-member path.

The counts are int32 (``N < 2^31``); every fold is ``state + delta`` with
the member's own promotion (``ops/mega.py``), so the states are bit-equal
to the per-member path's.

Left out of the JAX module, each for a reason:

* ``_pick_tile``, ``_VMEM_BUDGET``, ``_TILES`` and ``_LANE``: the TPU
  kernel's VMEM tiling.  The CUDA kernel keeps counters in shared memory
  where they fit and in global memory (L2) where they do not, so no plan
  is infeasible for want of on-chip memory.
* the wavefront mode, the Pallas switch and the backend in
  :func:`route_token`: the port has no such switches, and its graphs are
  keyed by device already.

The bounds, re-derived for the H100 (``PERF.md``): ``_MAX_SAMPLES`` is
2^31 because the counts are int32 (the JAX package's 2^24 came from its
f32 accumulators).  ``_MAX_FEATURES``, ``_MAX_CLASSES`` and
``_MAX_THRESHOLDS`` were sized for VMEM; the CUDA kernel takes larger
widths (its argmax loops over any row, and counters that do not fit in
shared memory go to global memory), but the bounds stay where the JAX
package has them so that both packages plan the same members.  One bound
is the port's own: a plan's counters must have int32 offsets
(``_MAX_COUNTERS``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, FrozenSet, Optional, Tuple

import torch

from torcheval_tpu_torch.ops import _flags as _oflags

_MAX_SAMPLES = 1 << 31
_MAX_FEATURES = 256
_MAX_CLASSES = 256
_MAX_THRESHOLDS = 512
_MAX_COUNTERS = 1 << 31

# Score dtypes the kernel reads as f32 without changing what the members
# compare (bf16 / f16 widen exactly; integer scores promote to f32 in the
# members' threshold compares too).
_SCORE_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


@dataclasses.dataclass(frozen=True)
class MemberPlan:
    """One supported member's accumulation recipe.

    ``moment_slots`` maps state names to payload ids (``ops/mega.py``);
    scatter / cm / binned members carry their widths instead.
    ``threshold`` is the binary decision threshold (``None`` for
    label-prediction members)."""

    name: str
    kind: str  # "moment" | "scatter" | "cm" | "binned"
    spec: str
    threshold: Optional[float] = None
    num_classes: int = 0
    num_thresholds: int = 0
    moment_slots: Tuple[Tuple[str, str], ...] = ()


@dataclasses.dataclass(frozen=True)
class MegaPlan:
    """The kernel's work for one (collection, batch shape) pair:
    supported members in iteration order and the batch geometry."""

    members: Tuple[MemberPlan, ...]
    member_names: FrozenSet[str]
    unsupported: Tuple[str, ...]
    n: int
    features: int  # input columns for 2-D scores, 0 for 1-D input
    a: int  # accumulation rows: 1 global (+ one per slice clone)
    slices: int  # 0 for an unsliced collection
    needs_scores: bool
    needs_pred: bool


def _dtype_of(x) -> Optional[torch.dtype]:
    d = getattr(x, "dtype", None)
    return d if isinstance(d, torch.dtype) else None


def _int_like(dt: Optional[torch.dtype]) -> bool:
    return dt is not None and not dt.is_floating_point and not dt.is_complex


def _score_like(dt: Optional[torch.dtype]) -> bool:
    return dt is not None and (dt in _SCORE_DTYPES or _int_like(dt))


# (state name, payload id) in the members' own accumulate order.  A state
# missing here receives a bitwise no-op on the per-member path (micro
# precision adds a literal 0.0 to num_label) and is skipped.
_MICRO_SLOTS = {
    "acc_micro": (("num_correct", "eq"), ("num_total", "ones")),
    "precision_micro": (("num_tp", "eq"), ("num_fp", "neq")),
    "recall_micro": (
        ("num_tp", "eq"),
        ("num_labels", "ones"),
        ("num_predictions", "ones"),
    ),
    "f1_micro": (
        ("num_tp", "eq"),
        ("num_label", "ones"),
        ("num_prediction", "ones"),
    ),
    "binary_acc": (("num_correct", "beq"), ("num_total", "ones")),
    "binary_precision": (("num_tp", "pb_t1"), ("num_fp", "pb_t0")),
    "binary_recall": (("num_tp", "pb_t1"), ("num_true_labels", "t1")),
    "binary_f1": (
        ("num_tp", "pb_traw"),
        ("num_label", "traw"),
        ("num_prediction", "pb"),
    ),
}

# Specs whose payloads need integer predictions (the 1-D integer input,
# or the argmax of 2-D scores).
_PRED_SPECS = frozenset(
    {
        "acc_micro",
        "precision_micro",
        "recall_micro",
        "f1_micro",
        "acc_macro",
        "precision",
        "recall",
        "f1",
        "cm",
    }
)


def _label_input_ok(f: int, idt, num_classes: Optional[int]) -> bool:
    """1-D integer labels, or a 2-D score block whose width matches the
    member's class count (a mismatch declines the member, so its own
    update raises its own error)."""
    if f == 0:
        return _int_like(idt)
    return num_classes is None or f == num_classes


def _classify(name: str, m, f: int, idt) -> Optional[MemberPlan]:
    from torcheval_tpu_torch.metrics.classification import (
        BinaryAccuracy,
        BinaryAUPRC,
        BinaryAUROC,
        BinaryBinnedAUPRC,
        BinaryBinnedAUROC,
        BinaryConfusionMatrix,
        BinaryF1Score,
        BinaryPrecision,
        BinaryRecall,
        MulticlassAccuracy,
        MulticlassConfusionMatrix,
        MulticlassF1Score,
        MulticlassPrecision,
        MulticlassRecall,
    )

    t = type(m)
    binaryish = f == 0  # binary members need 1-D scores

    if t is MulticlassAccuracy:
        if m.k != 1 or not _label_input_ok(f, idt, m.num_classes):
            return None
        if m.average == "micro":
            return MemberPlan(
                name, "moment", "acc_micro", moment_slots=_MICRO_SLOTS["acc_micro"]
            )
        c = m.num_classes or 0
        if 0 < c <= _MAX_CLASSES:
            return MemberPlan(name, "scatter", "acc_macro", num_classes=c)
        return None
    if t is BinaryAccuracy:
        if not binaryish:
            return None
        return MemberPlan(
            name, "moment", "binary_acc", threshold=float(m.threshold),
            moment_slots=_MICRO_SLOTS["binary_acc"],
        )
    for cls, micro_spec, macro_spec in (
        (MulticlassPrecision, "precision_micro", "precision"),
        (MulticlassRecall, "recall_micro", "recall"),
        (MulticlassF1Score, "f1_micro", "f1"),
    ):
        if t is cls:
            if not _label_input_ok(f, idt, m.num_classes):
                return None
            if m.average == "micro":
                return MemberPlan(
                    name, "moment", micro_spec, moment_slots=_MICRO_SLOTS[micro_spec]
                )
            c = m.num_classes or 0
            if 0 < c <= _MAX_CLASSES:
                return MemberPlan(name, "scatter", macro_spec, num_classes=c)
            return None
    for cls, spec in (
        (BinaryPrecision, "binary_precision"),
        (BinaryRecall, "binary_recall"),
        (BinaryF1Score, "binary_f1"),
    ):
        if t is cls:
            if not binaryish:
                return None
            return MemberPlan(
                name, "moment", spec, threshold=float(m.threshold),
                moment_slots=_MICRO_SLOTS[spec],
            )
    if t is MulticlassConfusionMatrix:
        c = m.num_classes
        if c <= _MAX_CLASSES and _label_input_ok(f, idt, c):
            return MemberPlan(name, "cm", "cm", num_classes=c)
        return None
    if t is BinaryConfusionMatrix:
        if not binaryish:
            return None
        return MemberPlan(
            name, "cm", "binary_cm", threshold=float(m.threshold), num_classes=2
        )
    if t in (BinaryBinnedAUROC, BinaryBinnedAUPRC) or (
        t in (BinaryAUROC, BinaryAUPRC) and getattr(m, "_sketch_mode", False)
    ):
        # A sketch-mode exact-rank member carries the binned family's state
        # layout (threshold edges and the four count arrays), so the one
        # binned accumulation shape covers both.
        if not binaryish or m.num_tasks != 1:
            return None
        thr = getattr(m, "threshold", None)
        if not isinstance(thr, torch.Tensor) or thr.dim() != 1:
            return None
        nt = thr.shape[0]
        if not 0 < nt <= _MAX_THRESHOLDS:
            return None
        return MemberPlan(
            name, "binned", "binned", num_thresholds=nt,
            moment_slots=(("num_pos", "hit1"), ("num_total", "ones")),
        )
    return None


def counters(mp: MemberPlan, a: int) -> int:
    """How many int32 counters the kernel keeps for ``mp`` over ``a``
    accumulation rows."""
    size = a * len(mp.moment_slots)
    if mp.kind == "scatter":
        size += 3 * a * mp.num_classes
    elif mp.kind == "cm":
        size += a * mp.num_classes * mp.num_classes
    elif mp.kind == "binned":
        size += 2 * a * (mp.num_thresholds + 1)
    return size


def route_token() -> Tuple[Any, ...]:
    """The call-time flags the collection's routes depend on (the
    collection kernel's mode, the matmul confusion-matrix row chunk, the
    rank-sum switch and the rank-sketch state layout).  The engine keys
    its captured graphs under it, so a flag flipped mid-stream captures
    anew instead of replaying a stale route.  While the measured-cost
    layer is on, the store's epoch rides along: a new measurement
    recaptures through the same key, with no rebuild rule of its own;
    off, the token is exactly the static tuple."""
    token = (
        _oflags.megakernel_mode(),
        _oflags.cm_row_chunk(),
        _oflags.ustat_disabled(),
        _oflags.rank_sketch_mode(),
    )
    from torcheval_tpu_torch import routing_autotune as _autotune

    if _autotune.ENABLED:
        return token + (_autotune.EPOCH,)
    return token


def plan_signature(args: Tuple[Any, ...], members) -> str:
    """The measured-cost store's key of the collection-kernel decision:
    the batch's shapes and dtypes (``routing_autotune.batch_signature``)
    plus the supported members' accumulation specs.  The JAX package keys
    this decision on the batch alone, so two collections of different
    members share one row when their batches have the same shapes (a
    C = 64 and a C = 200 confusion matrix on the same labels); the port
    keeps them apart."""
    import hashlib

    from torcheval_tpu_torch import routing_autotune as _autotune

    specs = "|".join(
        f"{mp.spec}:{mp.num_classes}:{mp.num_thresholds}:{mp.threshold}" for mp in members
    )
    return f"{_autotune.batch_signature(args)}-{hashlib.sha256(specs.encode()).hexdigest()[:8]}"


def _same_device(metrics: Dict[str, Any]) -> Optional[torch.device]:
    devices = {m.device for m in metrics.values()}
    return devices.pop() if len(devices) == 1 else None


def plan_for(
    metrics: Dict[str, Any],
    args: Tuple[Any, ...],
    kwargs: Dict[str, Any],
    slices: Optional[int],
) -> Optional[MegaPlan]:
    """The kernel plan for one update call, or ``None`` when the route
    must not engage: the flag is off, the call shape is not supported,
    too few members are supported, or the members do not share one
    device.

    Auto mode (the flag unset) engages when the states live on a GPU and
    at least two members are supported, unless the measured-cost layer
    (``routing_autotune``) is on and holds a measured pick for this batch
    signature; forced on, one supported member on any device is enough
    (on the CPU the kernel's plain version runs).  Reads shapes and
    dtypes only."""
    mode = _oflags.megakernel_mode()
    if mode is False:
        return None
    if len(args) != 2 or set(kwargs) - {"mask", "slice_ids"}:
        return None
    inp, target = args
    idt, tdt = _dtype_of(inp), _dtype_of(target)
    if idt is None or tdt is None or target.dim() != 1 or not _int_like(tdt):
        return None
    n = target.shape[0]
    if not 1 <= n < _MAX_SAMPLES:
        return None
    if inp.dim() not in (1, 2) or inp.shape[0] != n:
        return None
    if inp.dim() == 2:
        f = inp.shape[1]
        if not 1 <= f <= _MAX_FEATURES or idt not in _SCORE_DTYPES:
            return None
    else:
        f = 0
        if not _score_like(idt):
            return None
    mask = kwargs.get("mask")
    if mask is not None and tuple(getattr(mask, "shape", ())) != (n,):
        return None
    device = _same_device(metrics)
    if device is None:
        return None

    supported, unsupported = [], []
    for name, m in metrics.items():
        mp = _classify(name, m, f, idt)
        if mp is None:
            unsupported.append(name)
        else:
            supported.append(mp)
    if not supported:
        return None
    if mode is None:
        declines = len(supported) < 2 or device.type != "cuda"
        from torcheval_tpu_torch import routing_autotune as _autotune

        if _autotune.ENABLED:
            # A measured pick for this shape bucket and these members may
            # overrule the auto heuristic either way (decide() keeps the
            # heuristic's choice without one); either choice launches
            # kernels on a GPU.
            default = "fused" if declines else "mega"
            if _autotune.decide("megakernel", plan_signature(args, supported), default) != "mega":
                return None
        elif declines:
            return None

    a = 1 + (slices or 0)
    if sum(counters(mp, a) for mp in supported) >= _MAX_COUNTERS:
        return None
    return MegaPlan(
        members=tuple(supported),
        member_names=frozenset(mp.name for mp in supported),
        unsupported=tuple(unsupported),
        n=n,
        features=f,
        a=a,
        slices=slices or 0,
        needs_scores=f > 0
        or any(mp.threshold is not None or mp.kind == "binned" for mp in supported),
        needs_pred=f == 0 and any(mp.spec in _PRED_SPECS for mp in supported),
    )
