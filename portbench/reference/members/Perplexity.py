"""Perplexity: exp of the mean negative log-likelihood of the target ids
over the tokens that are not ``ignore_index``, each token's NLL the
vocabulary's logsumexp minus its gathered logit (NaN past the
vocabulary, the logit at 0 for a negative id that is not ignored).

Computed in ``data.dtype`` throughout, in blocks of ``ROWS`` tokens (256
x 129 280 x 8 B = 265 MB a float64 block): every logsumexp, difference and
sum, the running total too, so the control (bfloat16) rounds where the
reference (float64) does not."""

import torch

from portbench.reference import formulas as f
from portbench.reference.members import whole

ROWS = 256


def reference(kw, data, position):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d = whole(data, position)
    vocab = d["input"].shape[-1]
    x = d["input"].reshape(-1, vocab)
    t = d["target"].reshape(-1)
    ignore = kw.get("ignore_index")
    total = torch.zeros((), dtype=data.dtype, device=x.device)
    count = 0
    for i in range(0, x.shape[0], ROWS):
        xb = x[i : i + ROWS].to(data.dtype)
        tb = t[i : i + ROWS]
        picked = xb.gather(1, tb.clamp(0, vocab - 1)[:, None])[:, 0]
        picked = torch.where(tb >= vocab, torch.full_like(picked, float("nan")), picked)
        nll = torch.logsumexp(xb, 1) - picked
        keep = torch.ones_like(tb, dtype=torch.bool) if ignore is None else tb != ignore
        total = total + nll[keep].sum()
        count += int(keep.sum())
    return f.result(torch.exp(total / count), data.dtype)
