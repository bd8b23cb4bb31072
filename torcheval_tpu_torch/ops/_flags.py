"""Call-time accessors for the kernel-route flags (the port's counterpart
of ``torcheval_tpu/ops/_flags.py``, holding only what the port reads)."""

from typing import Optional

from torcheval_tpu_torch import _flags


def ustat_disabled() -> bool:
    """True when ``TORCHEVAL_TPU_TORCH_DISABLE_USTAT`` is set truthy: the
    rank-sum (ustat) AUROC route is skipped and those rows take the sort
    path.  Read at call time, so harnesses may toggle it after import."""
    return _flags.get("DISABLE_USTAT")


def cm_row_chunk() -> int:
    """Call-time read of ``TORCHEVAL_TPU_TORCH_CM_ROW_CHUNK``: the row-tile
    height of the one-hot matmul confusion-matrix route (a power of two,
    default 4096).  Chunking never changes the counts, only the size of
    the one-hots that are live at once."""
    return _flags.get_int("CM_ROW_CHUNK")


def megakernel_mode() -> Optional[bool]:
    """Call-time read of ``TORCHEVAL_TPU_TORCH_MEGAKERNEL`` (the
    counterpart of the JAX package's ``megakernel_mode``): True forces the
    collection kernel on wherever a member is supported, on any device (on
    the CPU its plain version runs), False keeps every member on its own
    path, None is auto (see ``ops/_mega_plan.plan_for``)."""
    return _flags.get_tristate("MEGAKERNEL")


def rank_sketch_mode() -> Optional[bool]:
    """Call-time tri-state read of ``TORCHEVAL_TPU_TORCH_RANK_SKETCH`` (the
    counterpart of the JAX package's ``rank_sketch_mode``): True makes
    ``BinaryAUROC`` / ``BinaryAUPRC`` / ``MulticlassAUROC`` built without
    ``sketch=`` carry the rank-sketch count states
    (``metrics/_rank_state.py``); False or None keeps the exact sample
    buffers.  Resolved at a metric's construction; the engine keys its
    captured graphs under ``_mega_plan.route_token()``, which carries it.
    It picks a state layout only: a sketch update of a GPU tensor launches
    ``binned_count.cu`` whatever the flag says."""
    return _flags.get_tristate("RANK_SKETCH")


def rank_sketch_enabled() -> bool:
    """Construction-time resolution of :func:`rank_sketch_mode` for a metric
    built with ``sketch=None``: only an explicit truthy flag engages the
    sketch states (auto means off)."""
    return rank_sketch_mode() is True


def autotune_mode() -> Optional[bool]:
    """Call-time tri-state read of ``TORCHEVAL_TPU_TORCH_AUTOTUNE`` (the
    counterpart of the JAX package's ``autotune_mode``): True or False
    when set, None (auto: on exactly when ``..._AUTOTUNE_DIR`` names the
    store's directory) otherwise.  ``routing_autotune`` resolves it at
    import; an explicit falsy value also makes ``aot.warmup(autotune=True)``
    race nothing."""
    return _flags.get_tristate("AUTOTUNE")
