"""Native (C++) host-side code of the port.

The port's device kernels are CUDA C++ under ``ops/csrc``; what lives here
is host work with no device tensor in it: the batched edit distance over
tokenized sentences that the string flavour of the text metrics runs, and
that the device kernel is tested against.  The C++ compiles lazily with
the system compiler; a host without one runs a pure-Python version of the
same dynamic program, so the package never needs a build step.  This is
the port's own copy: it shares no file with ``torcheval_tpu.native``."""

from torcheval_tpu_torch.native.edit_distance import edit_distance_batch

__all__ = ["edit_distance_batch"]
