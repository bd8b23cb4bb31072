"""Perplexity from next-token logits (the port of
``torcheval_tpu/metrics/functional/text/perplexity.py``).

Sufficient statistics: the summed token negative log-likelihood and the
token count, both mergeable by addition.  Each token's NLL comes from
:func:`torcheval_tpu_torch.ops.token_nll.token_nll`: on the GPU one read of
the logits by ``ops/csrc/token_nll.cu``, with no float32 copy of them; on
the CPU the plain formula.  The JAX package computes it outside any
hand-written kernel, in XLA."""

from typing import Optional, Tuple

import torch

from torcheval_tpu_torch.metrics.functional._host_checks import place_inputs
from torcheval_tpu_torch.ops.token_nll import token_nll
from torcheval_tpu_torch.telemetry import events as _telemetry


def perplexity(
    input,
    target,
    ignore_index: Optional[int] = None,
) -> torch.Tensor:
    """``exp(mean NLL)`` over ``(n, seq_len, vocab)`` logits and
    ``(n, seq_len)`` target token ids; ``ignore_index`` tokens are
    excluded from the mean."""
    input, target = place_inputs(input, target)
    _perplexity_input_check(input, target)
    sum_nll, count = _perplexity_update_kernel(input, target, ignore_index)
    return _perplexity_compute(sum_nll, count)


def _perplexity_update_kernel(
    input: torch.Tensor,
    target: torch.Tensor,
    ignore_index: Optional[int],
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    # Each token's NLL is the vocab-axis logsumexp minus its gathered logit:
    # the (n, seq, vocab) log-prob tensor is never formed.  Negative target
    # ids (the tokenized-text pad convention) gather through a clamped
    # index, and `valid` zeroes their term where they are the ignore_index.
    # An id past the vocabulary gives NaN, as the JAX gather's fill does.
    if _telemetry.ANNOTATE:
        with _telemetry.span("update.kernel.token_nll"):
            nll = token_nll(input, target)
    else:
        nll = token_nll(input, target)
    if ignore_index is None:
        valid = torch.ones(target.shape, dtype=torch.float32, device=nll.device)
    else:
        valid = (target != ignore_index).to(torch.float32)
    if mask is not None:
        # Padded bucket rows contribute exact zeros to both counters.
        valid = valid * mask.to(torch.float32)[:, None]
    return (nll * valid).sum(), valid.sum()


def _perplexity_compute(sum_nll: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    return torch.exp(sum_nll / count)


def _perplexity_input_check(input: torch.Tensor, target: torch.Tensor) -> None:
    if input.dim() != 3:
        raise ValueError(
            "input should have shape (num_sequences, num_tokens, vocab_size), "
            f"got {tuple(input.shape)}."
        )
    if target.dim() != 2:
        raise ValueError(
            "target should have shape (num_sequences, num_tokens), "
            f"got {tuple(target.shape)}."
        )
    if input.shape[:2] != target.shape:
        raise ValueError(
            "The leading dimensions of input and target should match, got "
            f"{tuple(input.shape)} and {tuple(target.shape)}."
        )
