"""Token negative log-likelihood from next-token logits, the work of
``Perplexity``'s update.

:func:`token_nll` takes ``(n, seq, V)`` logits and ``(n, seq)`` integer
target ids and returns the ``(n, seq)`` float32 NLL of each token:
``logsumexp(x) - x[clamp(t, 0, V - 1)]`` over the token's row ``x`` of the
logits, NaN where ``t >= V``.  A negative id gathers ``x[0]``; the caller
masks ignored tokens.  Non-finite logits propagate as ``torch.logsumexp``
propagates them.

**Route.**  Tensors on the GPU launch ``csrc/token_nll.cu`` or raise:
bf16, f16 or f32 logits with a unit stride on the vocabulary axis are read
in place (rows may be strided); other floating types are cast to float32
first, and other strides copied, as the plain version casts.  Tensors on
the CPU run :func:`_token_nll_plain`, the plain PyTorch formula.  The two
agree to float32 rounding: the kernel sums exponentials in its own order.

The kernel replaces no TPU kernel: the JAX package leaves this function to
XLA, which fuses it into one read of the logits, and PyTorch's operators
read and write the logits about fifteen times (``csrc/token_nll.cu``).
"""

from __future__ import annotations

import torch

from torcheval_tpu_torch.ops import _build

# The kernel's element types and their codes (csrc/token_nll.cu).
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_MAX_ROWS = 2**31  # one block a row on gridDim.x, int32 row and vocabulary indices


def token_nll(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The ``(n, seq)`` float32 negative log-likelihood of each target id
    under ``(n, seq, V)`` logits."""
    if input.dim() != 3 or target.dim() != 2 or input.shape[:2] != target.shape:
        raise ValueError(
            "token_nll takes (n, seq, vocab) logits and (n, seq) ids, got "
            f"{tuple(input.shape)} and {tuple(target.shape)}."
        )
    if input.device != target.device:
        raise ValueError("logits and target ids must be on one device.")
    if input.device.type == "cpu":
        return _token_nll_plain(input, target)
    if input.device.type == "cuda":
        return _token_nll_kernel(input, target)
    raise ValueError(f"token_nll runs on cuda or cpu, not {input.device}.")


def _token_nll_kernel(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/token_nll.cu`` on GPU tensors."""
    n, seq, vocab = input.shape
    device = input.device
    out = torch.empty((n, seq), dtype=torch.float32, device=device)  # the kernel writes every row
    rows = n * seq
    if rows == 0:
        return out
    if vocab == 0 or rows >= _MAX_ROWS or vocab >= _MAX_ROWS:
        raise ValueError(
            f"token_nll: {rows} tokens of vocabulary {vocab}; the kernel takes "
            "1 <= vocab < 2^31 and fewer than 2^31 tokens."
        )
    if input.dtype not in _DTYPES:
        input = input.to(torch.float32)
    if input.stride(-1) != 1:
        input = input.contiguous()
    if target.dtype not in (torch.int32, torch.int64):
        target = target.to(torch.int64)
    target = target.contiguous()
    lib = _build.library()
    with torch.cuda.device(device):
        err = lib.token_nll_launch(
            input.data_ptr(),
            input.stride(0),
            input.stride(1),
            seq,
            rows,
            vocab,
            _DTYPES[input.dtype],
            target.data_ptr(),
            int(target.dtype == torch.int64),
            out.data_ptr(),
            _build.stream_handle(device),
        )
    _build.check_launch("token_nll", err)
    _build.count_launch("token_nll")
    return out


def _token_nll_plain(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """The kernel's function in plain PyTorch: a float32 copy of the
    logits, a gather at the clamped ids, then ``torch.logsumexp``."""
    _build.count_plain("token_nll")
    logits = input.to(torch.float32)
    vocab = logits.shape[-1]
    index = target.to(torch.int64)
    token_logit = torch.gather(logits, -1, index.clamp(0, max(vocab - 1, 0))[..., None])[..., 0]
    # An id past the vocabulary gives NaN, as the JAX gather's fill does,
    # where torch.gather alone would fault.
    token_logit = torch.where(index >= vocab, torch.full_like(token_logit, float("nan")), token_logit)
    return torch.logsumexp(logits, dim=-1) - token_logit


__all__ = ("token_nll",)
