"""Metric formulas in plain PyTorch, in float64.

``dtype`` is the precision the inputs are read in and every real result
is rounded to: ``torch.float64`` for the reference (the inputs are
float32, so reading them in float64 changes nothing), ``torch.bfloat16``
for the control, the reference computed one precision below the one the
configurations state.  Counts are exact integers either way.
"""

from __future__ import annotations

import torch

F64 = torch.float64


def read(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` as the computation reads it: rounded to ``dtype`` when that
    is narrower than float32, else unchanged (float32 orders exactly)."""
    if dtype in (torch.bfloat16, torch.float16) and x.is_floating_point():
        return x.to(dtype)
    return x


def result(value: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A real result, rounded to ``dtype``, as a float64 host tensor."""
    return value.detach().to(F64).to(dtype).to(F64).cpu()


def topk_correct(scores: torch.Tensor, target: torch.Tensor, k: int, dtype, rows: int = 4096) -> int:
    """Samples whose target is among the ``k`` largest scores; a tie goes
    to the lower class index (a stable descending sort, and ``argmax``)."""
    n, c = scores.shape
    idx = torch.arange(c, device=scores.device)
    hits = 0
    for i in range(0, n, rows):
        s = read(scores[i : i + rows], dtype)
        t = target[i : i + rows]
        st = s.gather(1, t[:, None])
        rank = (s > st).sum(1) + ((s == st) & (idx[None, :] < t[:, None])).sum(1)
        hits += int((rank < k).sum())
    return hits


def argmax(scores: torch.Tensor, dtype, rows: int = 4096) -> torch.Tensor:
    return torch.cat(
        [read(scores[i : i + rows], dtype).argmax(1) for i in range(0, scores.shape[0], rows)]
    )


def confusion(target: torch.Tensor, pred: torch.Tensor, c: int) -> torch.Tensor:
    """Rows are targets, columns predictions (int64, on the host)."""
    flat = target.to(torch.int64) * c + pred.to(torch.int64)
    return torch.bincount(flat, minlength=c * c).reshape(c, c).cpu()


def macro_f1(cm: torch.Tensor) -> torch.Tensor:
    """Mean F1 over the classes that occur as a target or a prediction."""
    cm = cm.to(F64)
    tp = cm.diagonal()
    label = cm.sum(1)
    pred = cm.sum(0)
    f1 = torch.nan_to_num(2 * tp / (label + pred))
    present = (label > 0) | (pred > 0)
    return f1[present].sum() / present.sum()


def auroc_rows(scores: torch.Tensor, hits: torch.Tensor, dtype) -> torch.Tensor:
    """AUROC of each row of ``scores`` (B, n) against the boolean ``hits``
    (B, n): the Mann-Whitney U of the positives over P x N, a tie
    counting one half (average ranks).  Rows are sorted along their last,
    contiguous dimension."""
    n = scores.shape[-1]
    s, order = read(scores, dtype).sort(dim=-1)
    h = hits.gather(-1, order)
    del order
    pos = torch.arange(n, device=s.device).expand_as(s)
    first = torch.ones_like(s, dtype=torch.bool)
    first[:, 1:] = s[:, 1:] != s[:, :-1]
    last = torch.ones_like(first)
    last[:, :-1] = first[:, 1:]
    del s
    start = torch.where(first, pos, 0).cummax(-1).values
    end = torch.where(last, pos, n - 1).flip(-1).cummin(-1).values.flip(-1)
    rank = (start + end).to(F64) / 2 + 1
    p = h.sum(-1).to(F64)
    u = (rank * h).sum(-1) - p * (p + 1) / 2
    return u / (p * (n - p))


def binary_auroc(scores: torch.Tensor, labels: torch.Tensor, dtype) -> torch.Tensor:
    return auroc_rows(scores[None, :], labels[None, :] > 0.5, dtype)[0]


def multiclass_auroc_macro(scores: torch.Tensor, target: torch.Tensor, dtype, rows: int = 50) -> torch.Tensor:
    """Mean one-vs-rest AUROC over the classes."""
    c = scores.shape[1]
    out = []
    for j in range(0, c, rows):
        block = scores[:, j : j + rows].T.contiguous()
        classes = torch.arange(j, j + block.shape[0], device=scores.device)
        out.append(auroc_rows(block, classes[:, None] == target[None, :], dtype))
    return torch.cat(out).mean()


def binary_stats(prob: torch.Tensor, label: torch.Tensor, dtype) -> torch.Tensor:
    """Sufficient statistics of one batch, float64: cross entropy summed,
    samples, positives, probabilities summed, and samples at or above
    0.5 whose label is 1 or below it whose label is 0."""
    p = read(prob, dtype).to(F64)
    y = label.to(F64)
    q = p.clamp(1e-12, 1 - 1e-12)
    ce = -(y * torch.log(q) + (1 - y) * torch.log1p(-q))
    correct = ((p >= 0.5).to(F64) == y).sum()
    return torch.stack([ce.sum(), torch.tensor(float(p.numel()), dtype=F64, device=p.device),
                        y.sum(), p.sum(), correct])


def normalized_entropy(stats: torch.Tensor) -> torch.Tensor:
    """Mean cross entropy over the entropy of the base positive rate."""
    ce, n, pos = stats[0], stats[1], stats[2]
    rate = (pos / n).clamp(1e-7, 1 - 1e-7)
    base = -rate * torch.log(rate) - (1 - rate) * torch.log1p(-rate)
    return (ce / n) / base


def ctr(stats: torch.Tensor) -> torch.Tensor:
    return stats[2] / stats[1]


def calibration(stats: torch.Tensor) -> torch.Tensor:
    return stats[3] / stats[2]


def accuracy(stats: torch.Tensor) -> torch.Tensor:
    return stats[4] / stats[1]
