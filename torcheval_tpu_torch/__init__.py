"""torcheval_tpu_torch — the PyTorch/CUDA port of ``torcheval_tpu``.

The module layout mirrors the JAX package path for path, so each ported
module sits where its counterpart does.  The port imports ``torch`` and
numpy only: never ``jax``, never ``torcheval_tpu``.  The kernels the JAX
package wrote in Pallas for the TPU are CUDA C++ for Hopper
(``ops/csrc/*.cu``), built with ``nvcc`` at first use; every kernel has a
plain PyTorch version beside it, taken only for tensors on the CPU.

Metrics live on the GPU unless the caller asks for the CPU
(``device="cpu"``); functional metrics run where their input tensors
live and place numpy arrays and lists on the GPU.  ``flagship`` holds the
torch twin of the JAX package's flagship eval step.  The top level
exports the JAX package's layers.
"""

from torcheval_tpu_torch import aot, engine, metrics, resilience, telemetry, tools
from torcheval_tpu_torch.version import __version__

__all__ = [
    "aot",
    "engine",
    "metrics",
    "resilience",
    "telemetry",
    "tools",
    "__version__",
]
