"""Word error rate and word information preserved / lost (the port of
``torcheval_tpu/metrics/functional/text/word_error_rate.py``).

Two input flavours share the same sufficient statistics (edit errors,
target words, input words: scalar counters that merge by addition):

* **strings** — host work from end to end: per-batch word-to-id interning
  feeds the batched Levenshtein DP of ``torcheval_tpu_torch/native`` (C++
  through ctypes, a pure-Python version without a compiler).  No device
  runs anything, so the functional result is a tensor on the host.
* **token-id tensors** — padded ``(n, len)`` integer ids under the
  negative-trailing-pad convention (``metrics/text/_tokens``), or
  ``(n, seq, vocab)`` float logits whose greedy-argmax hypothesis is taken
  first; the distances come from ``ops/wavefront.py`` (the CUDA kernel for
  tensors on the GPU).  numpy arrays and lists go to the GPU
  (``_host_checks.place_inputs``).

WER  = edit_errors / target_words
WIP  = (target_words − errors)/target_words · (target_words − errors)/input_words
       (the Morris et al. hit proxy H ≈ N_ref − E in both numerators)
WIL  = 1 − WIP
"""

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torcheval_tpu_torch.metrics.functional._host_checks import place_inputs
from torcheval_tpu_torch.native import edit_distance_batch

TText = Union[str, Sequence[str]]


def word_error_rate(input, target) -> torch.Tensor:
    """WER over (hypothesis, reference) pairs: strings, token-id tensors,
    or logits (see the module docstring for the array contract)."""
    if _is_tokens(input):
        errors, target_total, _ = _word_stats_tokens(input, target)
        return errors / target_total
    errors, target_total, _ = _word_stats_update(input, target)
    return torch.tensor(errors / target_total if target_total else float("nan"))


def word_information_preserved(input, target) -> torch.Tensor:
    """Word information preserved over (hypothesis, reference) pairs."""
    if _is_tokens(input):
        errors, target_total, input_total = _word_stats_tokens(input, target)
        return _wip_compute(
            errors.to(torch.float32),
            target_total.to(torch.float32),
            input_total.to(torch.float32),
        )
    errors, target_total, input_total = _word_stats_update(input, target)
    return _wip_compute(
        torch.tensor(float(errors)),
        torch.tensor(float(target_total)),
        torch.tensor(float(input_total)),
    )


def word_information_lost(input, target) -> torch.Tensor:
    """Word information lost: ``1 − WIP``."""
    return 1.0 - word_information_preserved(input, target)


def _wip_compute(
    errors: torch.Tensor, target_total: torch.Tensor, input_total: torch.Tensor
) -> torch.Tensor:
    hits = target_total - errors
    return (hits / target_total) * (hits / input_total)


def _as_list(text: TText, name: str) -> List[str]:
    if isinstance(text, str):
        return [text]
    if isinstance(text, Sequence) and all(isinstance(t, str) for t in text):
        return list(text)
    raise ValueError(
        f"`{name}` should be a string or a sequence of strings, got {type(text)}."
    )


def _is_tokens(x) -> bool:
    """Array-flavoured input (token ids or logits) against the host string
    path: anything with an ``ndim`` is an array."""
    return hasattr(x, "ndim") and not isinstance(x, (str, bytes))


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex or dtype == torch.bool)


def _word_stats_tokens_check(input: torch.Tensor, target: torch.Tensor) -> None:
    if target.dim() != 2 or not _is_integer(target.dtype):
        raise ValueError(
            "target should be (num_sequences, num_tokens) integer token "
            f"ids, got shape {tuple(target.shape)} dtype {_dtype_name(target.dtype)}."
        )
    if input.dim() == 3:
        if not input.dtype.is_floating_point:
            raise ValueError(
                "3-D input should be (num_sequences, num_tokens, "
                f"vocab_size) float logits, got dtype {_dtype_name(input.dtype)}."
            )
        if input.shape[:2] != target.shape:
            raise ValueError(
                "The leading dimensions of input and target should "
                f"match, got {tuple(input.shape)} and {tuple(target.shape)}."
            )
    elif input.dim() == 2:
        if not _is_integer(input.dtype):
            raise ValueError(
                "2-D input should be (num_sequences, num_tokens) integer "
                f"token ids, got dtype {_dtype_name(input.dtype)}."
            )
        if input.shape[0] != target.shape[0]:
            raise ValueError(
                "`input` and `target` should have the same number of "
                f"sequences, got {input.shape[0]} and {target.shape[0]}."
            )
    else:
        raise ValueError(
            "input should be (n, len) token ids or (n, seq, vocab) "
            f"logits, got shape {tuple(input.shape)}."
        )


def _word_stats_device_kernel(
    input: torch.Tensor,
    target: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three counter deltas from padded token-id tensors (negative
    trailing pads), as int64 scalars: exact sums, cast to the f32 states
    once per update.

    A 3-D float ``input`` contributes its greedy-argmax hypothesis at the
    reference's live positions (the token error rate of the decoded
    stream); ``torch.argmax`` takes the first maximum and the first NaN, as
    ``jnp.argmax`` does."""
    from torcheval_tpu_torch.ops.wavefront import edit_distance_tokens, lens_from_ids

    target = target.to(torch.int32)
    if input.dim() == 3:
        hyp = torch.where(
            target >= 0,
            torch.argmax(input, dim=-1).to(torch.int32),
            torch.full_like(target, -1),
        )
    else:
        hyp = input.to(torch.int32)
    a_lens = lens_from_ids(hyp)
    b_lens = lens_from_ids(target)
    dist = edit_distance_tokens(hyp, target, a_lens, b_lens)
    if mask is not None:
        # Padded bucket rows contribute exact zeros to all three counters.
        live = mask.to(torch.int32)
        dist = dist * live
        a_lens = a_lens * live
        b_lens = b_lens * live
    return dist.sum(), b_lens.sum(), a_lens.sum()


def _word_stats_tokens(
    input, target, mask: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Place, validate and count one tokenized batch."""
    input, target = place_inputs(input, target)
    _word_stats_tokens_check(input, target)
    return _word_stats_device_kernel(input, target, mask=mask)


def _word_stats_update(input: TText, target: TText) -> Tuple[int, int, int]:
    """(edit errors, target word count, input word count) over the batch:
    the shared sufficient statistics of WER/WIP/WIL, on the host."""
    input, target = _as_list(input, "input"), _as_list(target, "target")
    if len(input) != len(target):
        raise ValueError(
            "`input` and `target` should have the same number of sequences, "
            f"got {len(input)} and {len(target)}."
        )
    vocab: dict = {}

    def ids(sentence: str) -> List[int]:
        return [vocab.setdefault(w, len(vocab)) for w in sentence.split()]

    input_ids = [ids(s) for s in input]
    target_ids = [ids(s) for s in target]
    errors = int(np.sum(edit_distance_batch(input_ids, target_ids))) if input else 0
    return (
        errors,
        sum(len(s) for s in target_ids),
        sum(len(s) for s in input_ids),
    )
