"""TPU004 donation-safety — **out of scope in the port; not registered.**

Why the port does not run this rule: its premise does not exist under
torch.  JAX deletes a buffer handed to a ``donate_argnums`` program, and
a later read raises.  torch never deletes a tensor handed to a call.
The port's ``donate=`` (``ops/mega.py``, ``engine/scan.py``,
``telemetry/perfscope.py``) means an in-place add into the caller's
state tensors, and reading those tensors after the call is the intended
use.  Every other rule keeps JAX's code number; ``--select TPU004`` is an
unknown code (exit 2) and ``--list-rules`` says why.

JAX's rule (``torcheval_tpu/analysis/rules/donation.py``) flags a
read of a buffer after it was donated: ``jax.jit(f, donate_argnums=...)``
deletes the donated arrays, and a later host-side access raises, but
only on platforms that honour donation.
"""

# Not registered: see the module docstring.
OUT_OF_SCOPE = (
    "TPU004",
    "donation-safety",
    "out of scope in the port: torch never deletes a tensor handed to a "
    "call, and the port's donate= is an in-place add into the caller's "
    "states, read after the call on purpose",
)
