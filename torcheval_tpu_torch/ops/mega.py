"""The one-pass collection kernel: every supported member's counts from
ONE read of the batch (the port of ``torcheval_tpu/ops/pallas_mega.py``).

:func:`mega_counts` takes a :class:`~torcheval_tpu_torch.ops._mega_plan
.MegaPlan` and one batch (input, labels, an optional validity mask and
slice ids) and returns, per planned member, its int32 counts over the
``A = 1 + slices`` accumulation rows: row 0 the global member, row
``k + 1`` slice clone ``k``.  For tensors on the GPU it launches the CUDA
kernel ``csrc/mega.cu``; for tensors on the CPU it runs
:func:`_mega_counts_plain`.  Both count integers, so they agree bit for
bit.  :func:`run_plan` turns the counts into each member's state deltas,
and :func:`apply_folds` adds them.

What each member's counts are (``MemberPlan.kind``):

* ``moment``: ``(A, S)`` sums of the member's payloads (``_PAYLOADS``);
* ``scatter``: ``(3, A, C)``: correct, label and prediction counts per
  class;
* ``cm``: ``(A, C, C)``: the confusion slab, rows true class;
* ``binned``: ``(2, A, T)``: per threshold, the samples with ``score >=
  t`` and the hits among them, beside its ``(A, 2)`` moments
  (``num_pos``, ``num_total``).

NaN is counted as the port's per-member paths count it, not as the JAX
kernel does: a NaN score row's prediction is ``torch.argmax``'s (the
first NaN), and a NaN binned score counts at every threshold.  A binary
member's ``score < threshold`` compares in the input's dtype, as its own
update does, so the threshold is rounded to that dtype first.  The mask
is a per-row integer weight, as in the JAX kernel (0/1 in every
collection call).
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from torcheval_tpu_torch.ops import _build
from torcheval_tpu_torch.ops._mega_plan import MegaPlan, MemberPlan, counters

# Numbers shared with csrc/mega.cu (its Kind, Spec and Payload enums).
_KINDS = {"moment": 0, "scatter": 1, "cm": 2, "binned": 3}
_SPECS = {"acc_macro": 1, "binary_cm": 2}  # every other spec: 0
_PAYLOADS = {
    "ones": 0, "eq": 1, "neq": 2, "beq": 3, "pb": 4, "t1": 5, "pb_t1": 6,
    "pb_t0": 7, "traw": 8, "pb_traw": 9, "hit1": 10,
}

# csrc/mega.cu's Plan: 4 header words, kMaxMembers descriptors of 10
# words, kMaxSlots slot words.
_MAX_MEMBERS = 64
_DESC_WORDS = 10
_PLAN_WORDS = 4 + _MAX_MEMBERS * _DESC_WORDS + 3 * _MAX_MEMBERS
# Counters a block keeps in shared memory: the H100's 227 KB opt-in.
_SMEM_INTS = 232448 // 4

MemberCounts = Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]


def _layout(members: Sequence[MemberPlan], a: int) -> Tuple[Dict, int, int]:
    """Offsets of each member's moment block and main region in one int32
    buffer: the regions sorted by size, the smallest first, so the longest
    prefix that fits in shared memory is the kernel's private image.
    Returns ``({(member index, part): offset}, image ints, total ints)``."""
    regions = []
    for q, mp in enumerate(members):
        if mp.moment_slots:
            regions.append((a * len(mp.moment_slots), q, "moment"))
        main = counters(mp, a) - a * len(mp.moment_slots)
        if main:
            regions.append((main, q, "main"))
    regions.sort(key=lambda r: r[0])
    offsets, total, image = {}, 0, 0
    for size, q, part in regions:
        offsets[(q, part)] = total
        total += size
        if total <= _SMEM_INTS and image == total - size:
            image = total
    return offsets, image, total


def _threshold_for(threshold: float, dtype: torch.dtype) -> float:
    """The decision threshold as a member's own ``input < threshold``
    compares it: in the input's floating dtype, f32 for integer input."""
    dt = dtype if dtype.is_floating_point else torch.float32
    return float(torch.tensor(threshold, dtype=dt).to(torch.float32))


def _inputs(plan: MegaPlan, inp, target, mask, sids, thresholds):
    """The kernel's operands, shared by the kernel and its plain version:
    f32 scores, int32 predictions, labels, weights and slice ids (each
    contiguous, or ``None`` when the plan does not read it), the binned
    grids in one f32 vector, and each member's rounded threshold."""
    n = target.shape[0]
    if inp.shape[0] != n or target.dim() != 1:
        raise ValueError(
            f"input and target must share the batch dim, got {tuple(inp.shape)} "
            f"and {tuple(target.shape)}."
        )
    if inp.dim() != (2 if plan.features else 1) or (
        plan.features and inp.shape[1] != plan.features
    ):
        raise ValueError(
            f"the plan reads {'(N, %d)' % plan.features if plan.features else '(N,)'} "
            f"input, got {tuple(inp.shape)}."
        )
    if n >= 2**31:
        raise ValueError(f"{n} samples; the int32 counts need N < 2^31.")
    for name, x in (("mask", mask), ("slice ids", sids)):
        if x is not None and tuple(x.shape) != (n,):
            raise ValueError(f"the {name} must have shape ({n},), got {tuple(x.shape)}.")
    binned = [mp for mp in plan.members if mp.kind == "binned"]
    if len(thresholds) != len(binned) or any(
        tuple(t.shape) != (mp.num_thresholds,) for t, mp in zip(thresholds, binned)
    ):
        raise ValueError("one (T,) threshold grid per binned member is required.")
    device = target.device
    for x in (inp, mask, sids, *thresholds):
        if x is not None and x.device != device:
            raise ValueError("every operand must be on the labels' device.")
    scores = inp.to(torch.float32).contiguous() if plan.needs_scores else None
    pred = inp.to(torch.int32).contiguous() if plan.needs_pred else None
    i32 = lambda x: None if x is None else x.to(torch.int32).contiguous()  # noqa: E731
    grids = (
        torch.cat([t.to(torch.float32) for t in thresholds]).contiguous()
        if thresholds
        else None
    )
    thr = [
        _threshold_for(mp.threshold, inp.dtype) if mp.threshold is not None else 0.0
        for mp in plan.members
    ]
    return scores, pred, i32(target), i32(mask), i32(sids), grids, thr


def _unpack(
    members: Sequence[MemberPlan], a: int, offsets: Dict, out: torch.Tensor
) -> List[MemberCounts]:
    """Each member's ``(moments, main)`` views of the counter buffer;
    binned histograms become per-threshold counts by one suffix sum
    (slot ``k`` holds the scores with ``k`` thresholds at or below them,
    so threshold ``j`` counts slots ``j + 1`` and up)."""
    result = []
    for q, mp in enumerate(members):
        moments = main = None
        if mp.moment_slots:
            s = len(mp.moment_slots)
            o = offsets[(q, "moment")]
            moments = out[o : o + a * s].view(a, s)
        o = offsets.get((q, "main"))
        c = mp.num_classes
        if mp.kind == "scatter":
            main = out[o : o + 3 * a * c].view(3, a, c)
        elif mp.kind == "cm":
            main = out[o : o + a * c * c].view(a, c, c)
        elif mp.kind == "binned":
            t = mp.num_thresholds
            hist = out[o : o + 2 * a * (t + 1)].view(2, a, t + 1)
            cum = torch.cumsum(hist.flip(-1), dim=-1, dtype=torch.int32).flip(-1)
            main = cum[..., 1:]
        result.append((moments, main))
    return result


def mega_counts(
    plan: MegaPlan,
    inp: torch.Tensor,
    target: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    sids: Optional[torch.Tensor] = None,
    thresholds: Sequence[torch.Tensor] = (),
) -> List[MemberCounts]:
    """Every planned member's int32 counts from one pass over the batch:
    ``(moments, main)`` per member, in ``plan.members`` order (module
    docstring).  ``thresholds`` holds one ascending ``(T,)`` grid per
    binned member.  Requires ``N < 2^31``."""
    if target.device.type == "cpu":
        return _mega_counts_plain(plan, inp, target, mask, sids, thresholds)
    if target.device.type != "cuda":
        raise ValueError(f"mega_counts runs on cuda or cpu, not {target.device}.")
    scores, pred, tgt, weight, sid, grids, thr = _inputs(
        plan, inp, target, mask, sids, thresholds
    )
    n = tgt.shape[0]
    a = plan.a
    result: List[MemberCounts] = []
    thr_off = 0
    # A plan of more than 64 members launches once per 64 (the kernel's
    # plan is a parameter of fixed size).
    for begin in range(0, len(plan.members), _MAX_MEMBERS):
        members = plan.members[begin : begin + _MAX_MEMBERS]
        offsets, image, total = _layout(members, a)
        out = torch.zeros(total, dtype=torch.int32, device=target.device)
        if n:
            words = _desc(plan, members, thr[begin : begin + _MAX_MEMBERS], offsets,
                          image, thr_off)
            _launch(scores, pred, tgt, weight, sid, n, grids, words, out)
        thr_off += sum(mp.num_thresholds for mp in members if mp.kind == "binned")
        result.extend(_unpack(members, a, offsets, out))
    return result


def _desc(plan, members, thr, offsets, image, thr_off) -> np.ndarray:
    """csrc/mega.cu's ``Plan`` as int32 words."""
    words = np.zeros(_PLAN_WORDS, dtype=np.int32)
    words[:4] = (len(members), plan.slices, plan.features, image)
    slot = 0
    for q, mp in enumerate(members):
        d = 4 + q * _DESC_WORDS
        words[d : d + _DESC_WORDS] = (
            _KINDS[mp.kind],
            _SPECS.get(mp.spec, 0),
            mp.num_thresholds if mp.kind == "binned" else mp.num_classes,
            offsets.get((q, "main"), 0),
            offsets.get((q, "moment"), 0),
            slot,
            len(mp.moment_slots),
            np.float32(thr[q]).view(np.int32),
            thr_off,
            0,
        )
        for _, pid in mp.moment_slots:
            words[4 + _MAX_MEMBERS * _DESC_WORDS + slot] = _PAYLOADS[pid]
            slot += 1
        if mp.kind == "binned":
            thr_off += mp.num_thresholds
    return words


def _launch(scores, pred, target, weight, sids, n, grids, words, out) -> None:
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    lib = _build.library()
    with torch.cuda.device(target.device):
        err = lib.mega_counts_launch(
            ptr(scores),
            ptr(pred),
            target.data_ptr(),
            ptr(weight),
            ptr(sids),
            n,
            ptr(grids),
            words.ctypes.data_as(ctypes.c_void_p),
            words.nbytes,
            out.data_ptr(),
            _build.stream_handle(target.device),
        )
    _build.check_launch("mega", err)
    _build.count_launch("mega_counts")


# The payloads of csrc/mega.cu, of (prediction, label, score >= threshold).
_PLAIN_PAYLOADS = {
    "ones": lambda p, t, pb: torch.ones_like(t),
    "eq": lambda p, t, pb: p == t,
    "neq": lambda p, t, pb: p != t,
    "beq": lambda p, t, pb: pb == t,
    "pb": lambda p, t, pb: pb,
    "t1": lambda p, t, pb: t != 0,
    "pb_t1": lambda p, t, pb: pb * (t != 0),
    "pb_t0": lambda p, t, pb: pb * (t == 0),
    "traw": lambda p, t, pb: t,
    "pb_traw": lambda p, t, pb: pb * t,
    "hit1": lambda p, t, pb: t == 1,
}


def _mega_counts_plain(
    plan: MegaPlan,
    inp: torch.Tensor,
    target: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    sids: Optional[torch.Tensor] = None,
    thresholds: Sequence[torch.Tensor] = (),
) -> List[MemberCounts]:
    """The kernel's counts in plain PyTorch: ``torch.argmax`` for 2-D
    scores, ``bucketize`` for the binned slots (NaN set to ``T``), and one
    ``index_add_`` per counter family into one buffer laid out as the
    kernel's, whose extra last slot takes the dropped samples."""
    _build.count_plain("mega_counts")
    scores, pred, tgt, weight, sid, grids, thr = _inputs(
        plan, inp, target, mask, sids, thresholds
    )
    a = plan.a
    offsets, _, total = _layout(plan.members, a)
    device = tgt.device
    out = torch.zeros(total + 1, dtype=torch.int64, device=device)
    if plan.features:
        pred = torch.argmax(scores, dim=1)
    t = tgt.to(torch.int64)
    w = torch.ones_like(t) if weight is None else weight.to(torch.int64)
    if sid is None:
        row1 = torch.full_like(t, -1)
    else:
        k = sid.to(torch.int64)
        row1 = torch.where((k >= 0) & (k < plan.slices), k + 1, -1)
    p = None if pred is None else pred.to(torch.int64)
    s = scores

    def add(base: int, row_len: int, idx: torch.Tensor, val: torch.Tensor) -> None:
        keep = idx >= 0
        out.index_add_(0, torch.where(keep, base + idx, total), val)
        both = keep & (row1 >= 0)
        out.index_add_(0, torch.where(both, base + row1 * row_len + idx, total), val)

    def wrap_sentinel(v: torch.Tensor, c: int) -> torch.Tensor:
        v = torch.where(v < 0, v + c, v)
        return torch.where(v < 0, c, v)

    grid_off = 0
    for q, mp in enumerate(plan.members):
        pb = (
            (~(s < thr[q])).to(torch.int64)
            if mp.threshold is not None
            else None
        )
        for j, (_, pid) in enumerate(mp.moment_slots):
            val = _PLAIN_PAYLOADS[pid](p, t, pb).to(torch.int64)
            add(offsets[(q, "moment")] + j, len(mp.moment_slots),
                torch.zeros_like(t), val * w)
        c = mp.num_classes
        if mp.kind == "scatter":
            base = offsets[(q, "main")]
            if mp.spec == "acc_macro":
                ti = torch.where(t < 0, t + c, t)
                ti = torch.where((ti >= 0) & (ti < c), ti, -1)
                add(base, c, ti, (p == t) * w)
                add(base + a * c, c, ti, w)
            else:
                tw, pw = wrap_sentinel(t, c), wrap_sentinel(p, c)
                ti = torch.where(tw < c, tw, -1)
                add(base, c, ti, ((tw == pw) & (tw < c)) * w)
                add(base + a * c, c, ti, w)
                add(base + 2 * a * c, c, torch.where(pw < c, pw, -1), w)
        elif mp.kind == "cm":
            tw = wrap_sentinel(t, c)
            pw = wrap_sentinel(pb if mp.spec == "binary_cm" else p, c)
            cell = torch.where((tw < c) & (pw < c), tw * c + pw, -1)
            add(offsets[(q, "main")], c * c, cell, w)
        elif mp.kind == "binned":
            nt = mp.num_thresholds
            grid = grids[grid_off : grid_off + nt]
            grid_off += nt
            slot = torch.bucketize(s, grid, right=True)
            slot = torch.where(torch.isnan(s), nt, slot)
            base = offsets[(q, "main")]
            add(base, nt + 1, slot, w)
            add(base + a * (nt + 1), nt + 1, slot, (t == 1) * w)
    return _unpack(plan.members, a, offsets, out[:total].to(torch.int32))


# ------------------------------------------------------------------- folds

Fold = Tuple[Any, str, torch.Tensor]


def run_plan(
    plan: MegaPlan,
    metrics: Dict[str, Any],
    slice_members: Dict[str, Any],
    args: Tuple[torch.Tensor, torch.Tensor],
    mask: Optional[torch.Tensor],
    sids: Optional[torch.Tensor],
) -> List[Fold]:
    """Count one batch for every planned member and return its state
    deltas as ``(metric, state, delta)``, the global member from row 0
    and slice clone ``k`` from row ``k + 1``.  No state is written here
    (:func:`apply_folds` writes them), so a caller can compute every delta
    before it changes any state.

    Each delta has its global member's state dtype and shape, one cast a
    member: a count cast to an f32 state's dtype gives what the per-member
    path's ``f32 + int32`` gives, which converts the count the same way."""
    thresholds = [metrics[mp.name].threshold for mp in plan.members if mp.kind == "binned"]
    counts = mega_counts(plan, args[0], args[1], mask, sids, thresholds)
    folds: List[Fold] = []
    for mp, (moments, main) in zip(plan.members, counts):
        lead = metrics[mp.name]
        targets = [lead] + [slice_members[f"{mp.name}@{k}"] for k in range(plan.slices)]

        def fold(state: str, block: torch.Tensor) -> None:
            # block: (A, ...) in the state's dtype, one row per target
            shape = (plan.a,) + tuple(getattr(lead, state).shape)
            rows = block.reshape(shape).unbind(0)
            folds.extend((m, state, delta) for m, delta in zip(targets, rows))

        if mp.moment_slots:
            cast = moments.to(getattr(lead, mp.moment_slots[0][0]).dtype)
            for j, (state, _) in enumerate(mp.moment_slots):
                fold(state, cast[:, j])
        if mp.kind == "scatter":
            first = "num_correct" if mp.spec == "acc_macro" else "num_tp"
            tp, label, pred_sum = main.to(getattr(lead, first).dtype).unbind(0)
            if mp.spec == "acc_macro":
                fold("num_correct", tp)
                fold("num_total", label)
            elif mp.spec == "precision":
                # num_fp in int32 first, as the per-member path subtracts
                fold("num_tp", tp)
                fold("num_fp", (main[2] - main[0]).to(tp.dtype))
                fold("num_label", label)
            elif mp.spec == "recall":
                fold("num_tp", tp)
                fold("num_labels", label)
                fold("num_predictions", pred_sum)
            else:  # f1
                fold("num_tp", tp)
                fold("num_label", label)
                fold("num_prediction", pred_sum)
        elif mp.kind == "cm":
            fold("confusion_matrix", main.to(lead.confusion_matrix.dtype))
        elif mp.kind == "binned":
            tp = main[1].to(lead.num_tp.dtype)
            fold("num_tp", tp)
            fold("num_fp", (main[0] - main[1]).to(tp.dtype))
    return folds


def apply_folds(folds: Sequence[Fold], donate: bool) -> None:
    """``state + delta`` for every fold, in one multi-tensor add per device
    and dtype (``torch._foreach_add``): a slice of 16 clones folds ~200
    small states a batch.  ``donate`` adds in place; otherwise each state
    is rebound to a new tensor.  The two give the same bits.  A state held
    in another dtype or shape than its global member's (one loaded from a
    checkpoint so) takes the member's own promotion instead: an integer
    state takes the delta in its dtype, a float state promotes."""
    groups: Dict[Tuple[torch.device, torch.dtype], List[Tuple[Any, str, Any, Any]]] = {}
    for m, state, delta in folds:
        old = getattr(m, state)
        if old.dtype == delta.dtype and old.shape == delta.shape:
            groups.setdefault((old.device, old.dtype), []).append((m, state, old, delta))
            continue
        if not old.is_floating_point():
            delta = delta.to(old.dtype)
        if donate:
            old.add_(delta)
        else:
            setattr(m, state, old + delta)
    for items in groups.values():
        olds = [old for _, _, old, _ in items]
        deltas = [delta for _, _, _, delta in items]
        if donate:
            torch._foreach_add_(olds, deltas)
        else:
            for (m, state, _, _), new in zip(items, torch._foreach_add(olds, deltas)):
                setattr(m, state, new)


__all__ = ("apply_folds", "mega_counts", "run_plan")
