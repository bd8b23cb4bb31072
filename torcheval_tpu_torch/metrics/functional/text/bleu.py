"""BLEU score (the port of
``torcheval_tpu/metrics/functional/text/bleu.py``).

Host-side n-gram counting (strings never touch a device); the sufficient
statistics are four counters that merge by addition: candidate and
reference lengths, and per-order clipped and possible n-gram match
counts.  The functional result is a tensor on the host; the class metric
keeps its counters on its device."""

import warnings
from collections import Counter
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

TBleuInput = Union[str, Sequence[str]]
TBleuTarget = Union[str, Sequence[str], Sequence[Sequence[str]]]


def bleu_score(
    input: TBleuInput,
    target: TBleuTarget,
    *,
    n_gram: int = 4,
    weights: Optional[Sequence[float]] = None,
) -> torch.Tensor:
    """Corpus BLEU of candidate sentence(s) against their reference set(s),
    with modified n-gram precision up to ``n_gram`` and the standard
    brevity penalty.  ``weights`` defaults to uniform ``1/n_gram``."""
    weights_arr = _bleu_param_check(n_gram, weights)
    input_len, target_len, matches, possible = _bleu_update(input, target, n_gram)
    return _bleu_compute(
        torch.tensor(float(input_len)),
        torch.tensor(float(target_len)),
        torch.as_tensor(matches, dtype=torch.float32),
        torch.as_tensor(possible, dtype=torch.float32),
        weights_arr,
    )


def _bleu_param_check(
    n_gram: int, weights: Optional[Sequence[float]]
) -> torch.Tensor:
    if n_gram < 1:
        raise ValueError(f"`n_gram` should be at least 1, got {n_gram}.")
    if weights is None:
        return torch.full((n_gram,), 1.0 / n_gram)
    if len(weights) != n_gram:
        raise ValueError(
            f"the length of `weights` should equal `n_gram`, got "
            f"{len(weights)} and {n_gram}."
        )
    if any(w < 0 for w in weights):
        raise ValueError(
            f"`weights` should be non-negative, got {list(weights)}."
        )
    total = float(sum(weights))
    if total <= 0:
        raise ValueError(
            f"`weights` should have a positive sum, got {list(weights)}."
        )
    if abs(total - 1.0) > 1e-6:
        # Un-normalized weights silently rescale log-BLEU by their sum;
        # normalize to what the caller almost certainly meant, loudly.
        warnings.warn(
            f"`weights` sum to {total:g}, not 1; normalizing them. Pass "
            "weights summing to 1 to silence this.",
            UserWarning,
            stacklevel=3,
        )
        weights = [w / total for w in weights]
    return torch.tensor([float(w) for w in weights], dtype=torch.float32)


def _normalize_pairs(
    input: TBleuInput, target: TBleuTarget
) -> Tuple[List[str], List[List[str]]]:
    """Canonicalize to (candidates, per-candidate reference lists)."""
    if isinstance(input, str):
        candidates = [input]
        if isinstance(target, str):
            references: List[List[str]] = [[target]]
        else:
            references = [list(target)]
    else:
        candidates = list(input)
        if isinstance(target, str):
            raise ValueError(
                "When `input` is a sequence of candidates, `target` must be "
                "a sequence of references (one str or list of str per "
                "candidate), got a bare string."
            )
        references = [[t] if isinstance(t, str) else list(t) for t in target]
    if len(candidates) != len(references):
        raise ValueError(
            "`input` and `target` should have the same number of sentences, "
            f"got {len(candidates)} and {len(references)}."
        )
    for refs in references:
        if not refs:
            raise ValueError("Every candidate needs at least one reference.")
    return candidates, references


def _ngram_counts(tokens: List[str], n_gram: int) -> List[Counter]:
    return [
        Counter(
            tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)
        )
        for n in range(1, n_gram + 1)
    ]


def _bleu_update(
    input: TBleuInput, target: TBleuTarget, n_gram: int
) -> Tuple[int, int, np.ndarray, np.ndarray]:
    """Sufficient statistics: candidate length, closest-reference length,
    clipped matches and possible matches per n-gram order."""
    candidates, references = _normalize_pairs(input, target)
    input_len = 0
    target_len = 0
    matches = np.zeros(n_gram, dtype=np.int64)
    possible = np.zeros(n_gram, dtype=np.int64)
    for cand, refs in zip(candidates, references):
        cand_tokens = cand.split()
        ref_tokens = [r.split() for r in refs]
        input_len += len(cand_tokens)
        # closest reference length; ties break toward the shorter reference
        target_len += min(
            (len(r) for r in ref_tokens),
            key=lambda L: (abs(L - len(cand_tokens)), L),
        )
        cand_counts = _ngram_counts(cand_tokens, n_gram)
        ref_counts = [_ngram_counts(r, n_gram) for r in ref_tokens]
        for n in range(n_gram):
            max_ref: Counter = Counter()
            for rc in ref_counts:
                for gram, count in rc[n].items():
                    max_ref[gram] = max(max_ref[gram], count)
            matches[n] += sum(
                min(count, max_ref[gram])
                for gram, count in cand_counts[n].items()
            )
            possible[n] += max(0, len(cand_tokens) - n)
    return input_len, target_len, matches, possible


def _bleu_compute(
    input_len: torch.Tensor,
    target_len: torch.Tensor,
    matches: torch.Tensor,
    possible: torch.Tensor,
    weights: torch.Tensor,
) -> torch.Tensor:
    """Brevity penalty × exp(Σ wₙ log pₙ), in float32 and in the JAX
    package's order of operations; 0 when any order has no match (log
    undefined: the standard corpus-BLEU convention)."""
    precisions = matches / torch.clamp(possible, min=1.0)
    log_p = torch.log(torch.clamp(precisions, min=1e-30))
    geo = torch.exp((weights * log_p).sum())
    bp = torch.where(
        input_len > target_len,
        torch.ones_like(input_len),
        torch.exp(1.0 - target_len / input_len),
    )
    zero = (matches == 0).any() | (input_len == 0)
    return torch.where(zero, torch.zeros_like(geo), bp * geo)
