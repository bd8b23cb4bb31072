"""Call-time accessors for the kernel-route flags (the port's counterpart
of ``torcheval_tpu/ops/_flags.py``, holding only what the port reads)."""

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
