"""Full float32 for the image metrics' matrix products and convolutions.

On a GPU, PyTorch runs float32 products and cuDNN convolutions in TF32 (a
10-bit mantissa) when the caller switches it on globally
(``torch.backends.cuda.matmul.allow_tf32`` or
``torch.set_float32_matmul_precision("high")``;
``torch.backends.cudnn.allow_tf32`` defaults to True).  SSIM and FID hold
the JAX package's full-f32 figures, so they run their products and
convolutions inside :func:`full_f32`, whatever the caller set."""

import threading
from contextlib import contextmanager

import torch

# The switches are process-wide and the port's LocalWorld ranks are threads
# of one process: the blocks open in any thread share one save of the
# caller's settings, taken by the first to enter and put back by the last
# to leave.
_LOCK = threading.Lock()
_DEPTH = 0
_SAVED = ()


@contextmanager
def full_f32():
    """Inside the block, float32 matmuls and cuDNN convolutions run in full
    float32; when the last open block (in any thread) exits, the TF32
    switches get back the values they had when the first one entered.
    Only the CUDA switches are read and written: PyTorch's generic matmul
    precision also covers oneDNN on the CPU, and writing it would change
    the caller's CPU setting."""
    global _DEPTH, _SAVED
    switches = (torch.backends.cuda.matmul, torch.backends.cudnn)
    with _LOCK:
        if _DEPTH == 0:
            _SAVED = tuple(s.allow_tf32 for s in switches)
            for s in switches:
                s.allow_tf32 = False
        _DEPTH += 1
    try:
        yield
    finally:
        with _LOCK:
            _DEPTH -= 1
            if _DEPTH == 0:
                for s, was in zip(switches, _SAVED):
                    s.allow_tf32 = was
