"""Host-side word-to-id interning: the bridge from string pairs to the
tokenized flavour of the text family (the port of
``torcheval_tpu/metrics/text/_tokens.py``).

Edit distance only compares tokens for *equality*, so any injective
word-to-int map preserves it exactly: interning is the one step that must
stay on the host, and everything after it (the edit-distance kernel, the
WER/WIP/WIL counter folds) runs on the device.  :func:`tokenize_pairs`
turns a (hypothesis, reference) string batch into two padded ``(n, len)``
int32 numpy arrays under the negative-pad convention the kernel consumes
(``ops.wavefront.lens_from_ids``): real tokens ``>= 0``, pads ``PAD_ID``
and strictly trailing (prefix-packed rows).

Sequence lengths are bucketed to powers of two by the same policy as batch
rows (``metrics/_bucket.py``), floored at ``DEFAULT_MIN_TOKENS``, so both
packages give a ragged sentence stream the same few shapes; the leading
dim stays raw for the collection's own ``bucket=True`` row bucketing.
"""

from typing import List, Optional, Tuple

import numpy as np

from torcheval_tpu_torch.metrics._bucket import bucket_size
from torcheval_tpu_torch.metrics.functional.text.word_error_rate import (
    TText,
    _as_list,
)

# The padding sentinel: any negative id works for the kernel (lengths
# bound every comparison); -1 keeps dumps readable.
PAD_ID = -1

# Sequence-length bucket floor: sentences up to this many words all share
# one shape.
DEFAULT_MIN_TOKENS = 16


class WordInterner:
    """A persistent word-to-id vocabulary.  Per-batch correctness never
    needs one (equality is within-pair), but a shared interner keeps ids
    stable across a stream, so pre-tokenized batches from different steps
    remain comparable and dumpable."""

    def __init__(self) -> None:
        self._vocab: dict = {}

    def __len__(self) -> int:
        return len(self._vocab)

    def ids(self, sentence: str) -> List[int]:
        vocab = self._vocab
        return [vocab.setdefault(w, len(vocab)) for w in sentence.split()]


def tokenize_pairs(
    input: TText,
    target: TText,
    *,
    interner: Optional[WordInterner] = None,
    min_tokens: int = DEFAULT_MIN_TOKENS,
) -> Tuple[np.ndarray, np.ndarray]:
    """Intern a (hypothesis, reference) string batch into padded id
    arrays: ``(hyp_ids, ref_ids)``, each ``(n, bucketed_len) int32`` with
    ``PAD_ID`` trailing pads.

    Validation matches the host path (same error strings); each array's
    width is the power-of-two bucket of its own longest sentence, so
    hypothesis and reference widths bucket independently.
    """
    hyp_s = _as_list(input, "input")
    ref_s = _as_list(target, "target")
    if len(hyp_s) != len(ref_s):
        raise ValueError(
            "`input` and `target` should have the same number of sequences, "
            f"got {len(hyp_s)} and {len(ref_s)}."
        )
    it = interner if interner is not None else WordInterner()
    hyp = [it.ids(s) for s in hyp_s]
    ref = [it.ids(s) for s in ref_s]
    return _pack(hyp, min_tokens), _pack(ref, min_tokens)


def _pack(seqs: List[List[int]], min_tokens: int) -> np.ndarray:
    width = bucket_size(
        max((len(s) for s in seqs), default=0), min_bucket=min_tokens
    )
    out = np.full((len(seqs), width), PAD_ID, np.int32)
    for row, seq in enumerate(seqs):
        out[row, : len(seq)] = seq
    return out
