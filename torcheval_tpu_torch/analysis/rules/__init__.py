"""tpulint rule modules.  Importing this package registers every rule
with the central registry (``_core.all_rules`` does this lazily)."""

from . import (  # noqa: F401
    check_then_act,
    donation,
    dtype_stability,
    flag_registry,
    hook_guard,
    layer_order,
    lock_discipline,
    lock_order,
    mask_discipline,
    pad_neutrality,
    thread_lifecycle,
    traced,
)

__all__ = [
    "check_then_act",
    "donation",
    "dtype_stability",
    "flag_registry",
    "hook_guard",
    "layer_order",
    "lock_discipline",
    "lock_order",
    "mask_discipline",
    "pad_neutrality",
    "thread_lifecycle",
    "traced",
]
