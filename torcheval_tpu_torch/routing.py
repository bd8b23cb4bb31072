"""Route diagnostics: loud downgrades and ``explain_route`` (the port of
``torcheval_tpu/routing.py``).

Several entry points pick their formulation at call time: the rank-sum
AUROC / AUPRC routes from the data (``ops/ustat.py``), the confusion
matrix and the binned counts from shapes, the collection kernel from the
members and the batch (``ops/_mega_plan.py``).  :func:`explain_route`
says which formulation a call would take and why, and names the CUDA
kernel it launches by the ``ops._build.LAUNCHES`` key the call bumps
(:func:`route_kernel` returns that key alone).  The deciders never look
at the device: a CPU tensor takes the same route through the kernel's
plain version (``ops._build.PLAIN_CALLS``, same key).

The JAX package warns when a decider sees tracers under a caller's
``jit`` and keeps the slower formulation.  The port has no tracers: its
deciders read concrete tensors on every call, so no port site raises the
warning today.  :func:`warn_route_downgrade` keeps the JAX contract (one
``RouteDowngradeWarning`` a user call site and kind, pointed at the
caller's line, and a telemetry event every time) for the sites that will.
"""

from __future__ import annotations

import os
import traceback
import warnings
from typing import Any, Dict, Optional, Set, Tuple

from torcheval_tpu_torch.telemetry import events as _telemetry

_warned_callsites: Set[Tuple[str, int, str]] = set()
_SKIP_PREFIXES: Optional[Tuple[str, ...]] = None

# The kernel behind each LAUNCHES key an explanation can name.
_KERNELS = {
    "rank_sum_counts": "ops/csrc/rank_sum.cu",
    "rank_hist_counts": "ops/csrc/rank_hist.cu",
    "auc_from_sorted": "ops/csrc/auc_scan.cu",
    "confusion_slab": "ops/csrc/cm_slab.cu",
    "binned_counts": "ops/csrc/binned_count.cu",
    "binned_weighted_counts": "ops/csrc/binned_wcount.cu",
    "mega_counts": "ops/csrc/mega.cu",
    "edit_distance_tokens": "ops/csrc/wavefront.cu",
    "token_nll": "ops/csrc/token_nll.cu",
}


class RouteDowngradeWarning(UserWarning):
    """A call-time decider fell back to a slower formulation for a reason
    the caller can fix (usually: pin the decision, e.g. ``ustat_cap=`` /
    ``max_class_count_per_shard=``)."""


def _skip_prefixes() -> Tuple[str, ...]:
    """Directory prefixes whose frames are never the user's call line:
    this package and torch (hooks fire with torch's machinery on the
    stack between the package and the user's call).  Computed once."""
    global _SKIP_PREFIXES
    if _SKIP_PREFIXES is None:
        import torch

        import torcheval_tpu_torch

        _SKIP_PREFIXES = tuple(
            os.path.dirname(os.path.abspath(mod.__file__)) + os.sep
            for mod in (torcheval_tpu_torch, torch)
        )
    return _SKIP_PREFIXES


def _user_callsite() -> Tuple[str, int]:
    """The first stack frame outside this package and torch: the user's
    call line.  When the whole stack is internal (``aot.warmup`` driving
    updates from inside the package), the outermost frame, so a warning
    or event is never unattributed."""
    stack = traceback.extract_stack(limit=40)[:-1]
    prefixes = _skip_prefixes()
    for frame in reversed(stack):
        filename = os.path.abspath(frame.filename or "")
        if any(filename.startswith(p) for p in prefixes):
            continue
        return frame.filename, frame.lineno or 0
    if stack:
        outer = stack[0]
        return outer.filename or "<unknown>", outer.lineno or 0
    return "<unknown>", 0


def warn_route_downgrade(kind: str, message: str) -> None:
    """Emit ``RouteDowngradeWarning`` once per (user call site, kind).

    ``warn_explicit`` at the user's file and line, outside Python's
    warning registry: a plain ``warnings.warn`` from here would register
    every call site under this module's line, so only the first would
    ever warn.  With the telemetry bus on, every occurrence is an event
    (the warning dedupes; the counter must not)."""
    filename, lineno = _user_callsite()
    if _telemetry.ENABLED:
        _telemetry.record_route_downgrade(kind, message, callsite=f"{filename}:{lineno}")
    key = (filename, lineno, kind)
    if key in _warned_callsites:
        return
    _warned_callsites.add(key)
    warnings.warn_explicit(message, RouteDowngradeWarning, filename, lineno)


def reset_route_warnings() -> None:
    """Forget which call sites already warned (test hook)."""
    _warned_callsites.clear()


def _measured_note(decision: str, signature: str = "*") -> str:
    """The measured-verdict sentence of :func:`explain_route`: the
    cost-store numbers that decided ``decision`` for ``signature`` (the
    store's key; ``"*"`` for a shape-less decision), or empty while the
    measured-cost layer is off."""
    from torcheval_tpu_torch import routing_autotune as _autotune

    if not _autotune.ENABLED:
        return ""
    pinned = _autotune._explicit(decision)
    if pinned is not None:
        return f"  Measured verdict: none needed, an explicit flag pins {pinned}."
    pref = _autotune.preference(decision, signature)
    if pref is None:
        return (
            "  Measured verdict: no binding cost-store rows for this shape "
            "and card yet; the static rule above decided "
            "(aot.warmup(autotune=True) races the candidates)."
        )
    return (
        f"  Measured verdict: {pref['choice']} at {pref['seconds'] * 1e3:.3f} ms vs "
        f"{pref['alt_choice']} at {pref['alt_seconds'] * 1e3:.3f} ms ({pref['kind']}, "
        f"{pref['site']} site): these numbers decided the route."
    )


def hot_path_stats() -> dict:
    """Process-wide hot-path counters in one dict:

    * ``"trace_counts"``: CUDA graphs captured, by kind (``"mega_scan"`` /
      ``"engine_scan"`` / ``"collection_update"``;
      :mod:`torcheval_tpu_torch._stats`), the port's
      counterpart of the JAX package's program builds.  In a steady
      stream this stops growing; each +1 is a capture
      (:func:`torcheval_tpu_torch.aot.warmup` moves them off the stream).
    * ``"spmd_cache"``: hits / misses / maxsize / currsize summed over the
      engine runners' and the collections' graph caches
      (``parallel/_compile_cache.py``,
      ``cache_totals``), standing in for the JAX package's sharded-program
      cache, which the port has no counterpart of (its sharded functions
      run eagerly).

    Both read live counters and work with the telemetry bus off; the
    port's ``telemetry.report()`` carries neither section."""
    from torcheval_tpu_torch import _stats
    from torcheval_tpu_torch.parallel._compile_cache import cache_totals

    info = cache_totals()
    return {
        "trace_counts": _stats.trace_counts(),
        "spmd_cache": {
            "hits": info.hits,
            "misses": info.misses,
            "maxsize": info.maxsize,
            "currsize": info.currsize,
            "peak_bytes": info.peak_bytes,
        },
    }


def _launches(key: Optional[str]) -> str:
    if key is None:
        return "  Launches no kernel."
    return (
        f"  Launches {key} ({_KERNELS[key]}) on a GPU tensor; its plain version on a "
        "CPU tensor."
    )


def explain_route(fn, *args, **kwargs) -> str:
    """Explain which formulation ``fn(*args, **kwargs)`` would run and
    why, and name the kernel it launches: the same decision the call
    makes, from the same data.

    Supported ``fn`` (the :mod:`torcheval_tpu_torch.metrics.functional`
    callables): ``multiclass_auroc``, ``multiclass_auprc``,
    ``binary_auroc``, ``binary_auprc``, ``multiclass_confusion_matrix``,
    ``multiclass_f1_score``, ``multiclass_precision``,
    ``multiclass_recall``, the binned family (every ``*_binned_auroc`` /
    ``*_binned_auprc`` / ``*_binned_precision_recall_curve``), the text
    family (``word_error_rate``, ``word_information_preserved``,
    ``word_information_lost``, ``ops.wavefront.edit_distance_tokens``,
    ``perplexity``), a
    collection's bound ``fused_update``, and the sharded functions of
    :mod:`torcheval_tpu_torch.parallel`.  Reads the data where the call's
    decider does (one read back); runs no kernel.  Returns one paragraph."""
    return _explain(fn, args, kwargs)[0]


def route_kernel(fn, *args, **kwargs) -> Optional[str]:
    """The ``ops._build.LAUNCHES`` key of the kernel ``fn(*args,
    **kwargs)`` would launch on GPU tensors (``None`` for a route that
    launches none): the key :func:`explain_route` names."""
    return _explain(fn, args, kwargs)[1]


def _as_tensor(x):
    import torch

    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x)


def _explain(fn, args, kwargs) -> Tuple[str, Optional[str]]:
    import torcheval_tpu_torch.metrics.functional as F
    from torcheval_tpu_torch.ops._flags import ustat_disabled
    from torcheval_tpu_torch.ops.wavefront import edit_distance_tokens

    name = getattr(fn, "__name__", str(fn))

    if fn in (F.multiclass_auroc, F.multiclass_auprc):
        from torcheval_tpu_torch.ops.ustat import ustat_route_cap

        scores, target = _as_tensor(args[0]), _as_tensor(args[1])
        num_classes = kwargs.get("num_classes", scores.shape[1] if scores.dim() == 2 else None)
        pinned = kwargs.get("ustat_cap")
        rank_key = "rank_sum_counts" if fn is F.multiclass_auroc else "rank_hist_counts"
        sort_key = "auc_from_sorted" if fn is F.multiclass_auroc else None
        if pinned is not None and not ustat_disabled():
            return (
                f"{name}: sort-free rank route, table cap pinned at {pinned} by "
                "ustat_cap (checked against the data unless value checks are skipped)."
                + _launches(rank_key),
                rank_key,
            )
        cap = None if pinned is not None else ustat_route_cap(scores, target, num_classes)
        if cap is not None:
            return (
                f"{name}: sort-free rank route, table cap {cap}: one-vs-rest positives "
                f"are sparse enough (largest class ≤ {cap}, N = {scores.shape[0]} ≥ 2^15, "
                f"cap ≤ N/128), decided per call from one read back of the data; pin it "
                f"with ustat_cap={cap}." + _launches(rank_key),
                rank_key,
            )
        reason = (
            "TORCHEVAL_TPU_TORCH_DISABLE_USTAT is set"
            if ustat_disabled()
            else "data outside the rank route's win region (N < 2^15, a class with "
            "more than min(512, N/128) samples, non-finite or huge scores, or "
            "targets out of range)"
        )
        tail = (
            "sort + AUC scan" if sort_key else "sort + step-sum scan in plain torch"
        )
        return f"{name}: {tail} ({reason})." + _launches(sort_key), sort_key

    if fn in (F.binary_auroc, F.binary_auprc):
        from torcheval_tpu_torch.ops.ustat import binary_ustat_route

        scores, target = _as_tensor(args[0]), _as_tensor(args[1])
        rows = scores[None] if scores.dim() == 1 else scores
        t_rows = target[None] if target.dim() == 1 else target
        auprc = fn is F.binary_auprc
        route = binary_ustat_route(rows, t_rows, need_pos=auprc)
        if route is not None:
            side, cap = route
            key = "rank_hist_counts" if auprc else "rank_sum_counts"
            return (
                f"{name}: sort-free rank route against the packed {side!r} side, cap "
                f"{cap} (decided per call from one read back)." + _launches(key),
                key,
            )
        key = None if auprc else "auc_from_sorted"
        detail = "sort + step-sum scan in plain torch" if auprc else "sort + AUC scan"
        return (
            f"{name}: {detail} (neither class is rare enough for the rank route, or "
            "the route switch is set)." + _launches(key),
            key,
        )

    if fn is F.multiclass_confusion_matrix:
        inp = args[0]
        num_classes = kwargs.get("num_classes", args[2] if len(args) > 2 else None)
        if not isinstance(num_classes, int):
            return (
                f"{name}: not routable: the call itself would fail (num_classes is "
                f"required, got {num_classes!r}).",
                None,
            )
        return _cm_explanation(name, "confusion-matrix counts", num_classes, inp.shape[0])

    if fn in (F.multiclass_f1_score, F.multiclass_precision, F.multiclass_recall):
        inp = args[0]
        average = kwargs.get("average", "micro")
        num_classes = kwargs.get("num_classes")
        if average == "micro":
            return (
                f"{name}: micro average: scalar counters in plain torch (no per-class "
                "trio, no routing)." + _launches(None),
                None,
            )
        if average not in ("macro", "weighted", None):
            return (
                f"{name}: not routable: the call itself would fail "
                f"(average={average!r} is not an allowed value).",
                None,
            )
        if not isinstance(num_classes, int) or num_classes <= 0:
            return (
                f"{name}: not routable: the call itself would fail (num_classes must be "
                f"a positive int when average={average!r}, got {num_classes!r}).",
                None,
            )
        return _cm_explanation(name, "per-class count trio", num_classes, inp.shape[0])

    binned = _binned_kinds(F)
    if fn in binned:
        from torcheval_tpu_torch.metrics.functional.classification.binned_auc import (
            _select_binned_route,
        )

        inp = args[0]
        kind, default_t = binned[fn]
        shape = tuple(inp.shape)
        if kind == "binary":
            rows, n = (shape[0] if len(shape) == 2 else 1), shape[-1]
        else:
            rows, n = (shape[1] if len(shape) == 2 else 1), shape[0]
        threshold = kwargs.get("threshold", default_t)
        t = threshold if isinstance(threshold, int) else len(threshold)
        if _select_binned_route(n) == "kernel":
            return (
                f"{name}: binned counts of {rows} row(s) of {n} samples at {t} "
                "thresholds through the binned-count kernel, decided from shapes only "
                "(N < 2^31)." + _launches("binned_counts"),
                "binned_counts",
            )
        return (
            f"{name}: binned counts by sort + searchsorted ({n} samples pass the "
            "kernel's int32 bound)." + _launches(None),
            None,
        )

    if fn in (
        F.word_error_rate,
        F.word_information_preserved,
        F.word_information_lost,
        edit_distance_tokens,
    ):
        return _text_explanation(fn, name, args, edit_distance_tokens)

    if fn is F.perplexity:
        return (
            f"{name}: each token's negative log-likelihood through the token-NLL kernel, "
            "one read of each logits row (online max and sum of exponentials in float32), "
            "then the masked sum and count; one formulation, a CUDA tensor launches the "
            "kernel or raises." + _launches("token_nll"),
            "token_nll",
        )

    parallel = _explain_parallel_route(fn, name, args, kwargs)
    if parallel is not None:
        return parallel
    return (
        f"{name}: no call-time routing (one formulation, or not a routed entry point "
        "this helper knows).",
        None,
    )


def _cm_explanation(name: str, what: str, num_classes: int, n: int) -> Tuple[str, Optional[str]]:
    from torcheval_tpu_torch.metrics.functional.classification.confusion_matrix import (
        _cm_route,
        _cm_row_chunk,
    )

    route = _cm_route(num_classes, n)
    if route == "matmul":
        return (
            f"{name}: {what} via one-hot products (torch.matmul) in row blocks of "
            f"{_cm_row_chunk()}: C = {num_classes} ≤ 64 and n·C ≤ 2^28, decided from "
            "shapes and flags only." + _measured_note("cm_row_chunk") + _launches(None),
            None,
        )
    if route == "pallas":
        return (
            f"{name}: {what} via the confusion-slab kernel: C = {num_classes} > 64 "
            "(or past the matmul's n·C bound) and the slab's window fits, decided from "
            "shapes only." + _launches("confusion_slab"),
            "confusion_slab",
        )
    return (
        f"{name}: {what} via one int32 scatter (index_add_): C = {num_classes} and "
        f"N = {n} pass the slab kernel's window or int32 bounds." + _launches(None),
        None,
    )


def _binned_kinds(F) -> Dict[Any, Tuple[str, int]]:
    """(kind, default threshold count) a binned entry point; the kind
    fixes which axis holds the rows."""
    return {
        F.binary_binned_auroc: ("binary", 200),
        F.binary_binned_auprc: ("binary", 100),
        F.multiclass_binned_auroc: ("classes", 200),
        F.multiclass_binned_auprc: ("classes", 100),
        F.multilabel_binned_auprc: ("classes", 100),
        F.binary_binned_precision_recall_curve: ("binary", 100),
        F.multiclass_binned_precision_recall_curve: ("classes", 100),
        F.multilabel_binned_precision_recall_curve: ("classes", 100),
    }


def _text_explanation(fn, name, args, edit_distance_tokens) -> Tuple[str, Optional[str]]:
    from torcheval_tpu_torch.metrics.functional.text.word_error_rate import _is_tokens
    from torcheval_tpu_torch.ops.wavefront import _strip_rows, _wavefront_plan

    if fn is not edit_distance_tokens and args and not _is_tokens(args[0]):
        return (
            f"{name}: host string path: per-batch word interning feeds the native "
            "C++ batched DP (a pure-Python version without a compiler); tokenize with "
            "metrics/text/_tokens.tokenize_pairs to reach the edit-distance kernel."
            + _launches(None),
            None,
        )
    shapes = [tuple(getattr(a, "shape", ())) for a in args[:2]]
    if len(shapes) == 2 and len(shapes[0]) >= 2 and len(shapes[1]) == 2:
        n, wa, wb = shapes[0][0], shapes[0][1], shapes[1][1]
        blocks, scratch = _wavefront_plan(int(n), int(wa), int(wb))
        geometry = (
            f"  Geometry: {n} pairs of widths {wa} x {wb}, a warp a pair, up to "
            f"{_strip_rows(min(wa, wb))} rows a lane, {blocks} blocks, "
            + (f"{scratch * 4} B of carry scratch." if scratch else "no carry scratch.")
        )
    else:
        geometry = "  Pass (n, len) id arrays for the launch geometry."
    return (
        f"{name}: edit distances through the wavefront kernel: each anti-diagonal of "
        "the DP is data-parallel across the pair.  The JAX package's three-way "
        "wavefront route has no counterpart: a CUDA tensor launches the kernel or "
        "raises." + geometry + _launches("edit_distance_tokens"),
        "edit_distance_tokens",
    )


def _explain_parallel_route(fn, name, args, kwargs) -> Optional[Tuple[str, Optional[str]]]:
    """A collection's bound ``fused_update`` and the sharded functions of
    :mod:`torcheval_tpu_torch.parallel`, or ``None`` when ``fn`` is none of
    them.  The sharded decisions that read the world's data (a cap
    autotuned from one all-reduce, the 0/1-target gate) are described, not
    taken: taking them is a collective."""
    import torcheval_tpu_torch.parallel as P
    from torcheval_tpu_torch.metrics.collection import MetricCollection

    owner = getattr(fn, "__self__", None)
    if isinstance(owner, MetricCollection) and name == "fused_update":
        return _fused_update_explanation(owner, args, kwargs)

    def call_arg(pos, kw, default=None):
        if kw in kwargs:
            return kwargs[kw]
        return args[pos] if len(args) > pos else default

    binary_ustat = {
        P.sharded_binary_auroc_ustat: "max_minority_count_per_shard",
        P.sharded_binary_auprc_ustat: "max_positive_count_per_shard",
    }
    if fn in binary_ustat:
        from torcheval_tpu_torch.parallel.exact import _choose_ustat_comm
        from torcheval_tpu_torch.parallel.mesh import _axis_size

        param = binary_ustat[fn]
        mesh, axis = call_arg(2, "mesh"), call_arg(3, "axis", "dp")
        n_local = args[0].shape[0]
        cap = kwargs.get(param)
        cap = n_local if cap is None else min(cap, n_local)
        comm = kwargs.get("comm", "auto")
        if comm == "auto":
            comm = _choose_ustat_comm(1, cap, _axis_size(mesh, axis))
        wire = (
            f"cap {cap} per shard (O(P·cap) wire)"
            if kwargs.get(param) is not None
            else f"{param} is None, so each shard packs its whole {n_local}-sample block "
            f"(O(N) wire); pass {param}= for O(P·cap)"
        )
        return (
            f"{name}: packed runs of the rare side, {wire}, over "
            f"{'one all-gather' if comm == 'gather' else 'a point-to-point ring'}; each "
            "rank counts its other side with torch.searchsorted." + _launches(None),
            None,
        )

    if fn is P.sharded_multiclass_auroc_ustat:
        num_classes = kwargs.get("num_classes")
        if not isinstance(num_classes, int):
            return (
                f"{name}: not routable: the call itself would fail (num_classes is "
                f"required, got {num_classes!r}).",
                None,
            )
        cap = kwargs.get("max_class_count_per_shard")
        cap_src = (
            f"pinned at {cap}"
            if cap is not None
            else "autotuned in the call from its one all-reduce (the largest class "
            "count of any block, rounded up to 64)"
        )
        key = None if kwargs.get("_kernel") == "searchsorted" else "rank_sum_counts"
        return (
            f"{name}: packed per-class runs, cap {cap_src}; gathered, or passed round "
            "the ring past _RING_PACK_BYTES; each rank counts with the rank-sum kernel "
            "where its gate passes (float32 scores inside ±3e38, cap_tot·N < 2^29, the "
            "route switch unset), else batched torch.searchsorted."
            + _launches(key),
            key,
        )

    if fn in (P.sharded_auroc_histogram, P.sharded_auprc_histogram):
        weights = call_arg(5, "weights")
        key = "binned_weighted_counts" if weights is not None else "binned_counts"
        return (
            f"{name}: per-rank binned counts, one all-reduce of 2×num_bins statistics: "
            f"the {'weighted ' if weights is not None else ''}binned-count kernel when "
            "the world's targets are exactly 0/1 (or assume_01_targets=True), else a "
            "scatter histogram (soft targets, or skip_value_checks)." + _launches(key),
            key,
        )

    if fn is P.sharded_multiclass_auroc_histogram:
        weights = call_arg(6, "weights")
        key = "binned_weighted_counts" if weights is not None else "binned_counts"
        return (
            f"{name}: per-rank (C, n_local) binned counts through the "
            f"{'weighted ' if weights is not None else ''}binned-count kernel, one "
            "all-reduce of C×2×num_bins statistics, decided from shapes only."
            + _launches(key),
            key,
        )

    gather_exact = (
        P.sharded_binary_auroc_exact,
        P.sharded_binary_auprc_exact,
        P.sharded_multiclass_auroc_exact,
        P.sharded_multitask_auroc_exact,
        P.sharded_multitask_auprc_exact,
    )
    if fn in gather_exact:
        return (
            f"{name}: one formulation: one all-gather of the blocks (O(N) wire), then "
            "the single-device functional on the whole, whose own route (explain "
            "that call) picks the kernel.",
            None,
        )
    return None


def _fused_update_explanation(owner, args, kwargs) -> Tuple[str, Optional[str]]:
    from torcheval_tpu_torch import _flags, _stats
    from torcheval_tpu_torch.ops import _flags as _oflags
    from torcheval_tpu_torch.ops import _mega_plan

    try:
        owner._check_fusable()
    except ValueError as exc:
        return f"fused_update: not fusable: the call itself would raise ({exc}).", None
    captures = _stats.trace_count("mega_scan") + _stats.trace_count("engine_scan")
    head = (
        "fused_update: every member's update in one call, value checks skipped; "
        f"the engine has captured {captures} block graph(s) in this process "
        "(hot_path_stats()).  "
    )
    mode = _oflags.megakernel_mode()
    if mode is False:
        return (
            head + "Collection kernel OFF (TORCHEVAL_TPU_TORCH_MEGAKERNEL is falsy): "
            "every member runs its own route.",
            None,
        )
    if len(args) < 2:
        return (
            head + "Pass sample (input, target) args for the collection kernel's verdict.",
            None,
        )
    prepared, kw = owner._prepare(tuple(args), dict(kwargs))
    plan = _mega_plan.plan_for(owner._metrics, prepared, kw, owner._slices)
    with _flags.overridden("MEGAKERNEL", "1"):
        forced = _mega_plan.plan_for(owner._metrics, prepared, kw, owner._slices)
    note = (
        _measured_note("megakernel", _mega_plan.plan_signature(prepared, forced.members))
        if forced is not None
        else ""
    )
    if plan is not None:
        members = ", ".join(mp.name for mp in plan.members)
        rest = (
            f"; unsupported member(s) {', '.join(plan.unsupported)} keep their own routes"
            if plan.unsupported
            else ""
        )
        return (
            head + f"Collection kernel ENGAGED: one pass over the batch counts "
            f"{len(plan.members)} member(s) [{members}]{rest}." + note
            + _launches("mega_counts"),
            "mega_counts",
        )
    why = (
        "auto mode engages for states on a GPU with at least two supported members"
        if mode is None
        else "no member is supported at this call shape (ops/_mega_plan.py lists the "
        "accumulation shapes)"
    )
    return head + f"Collection kernel off for this call: {why}." + note, None


__all__ = [
    "RouteDowngradeWarning",
    "explain_route",
    "hot_path_stats",
    "reset_route_warnings",
    "route_kernel",
    "warn_route_downgrade",
]
