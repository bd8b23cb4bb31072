"""Top-k accuracy: samples whose target is among the k largest scores."""

import torch

from portbench.reference import formulas as f
from portbench.reference.members import whole


def reference(kw, data, position):
    d = whole(data, position)
    k = int(kw.get("k", 1))
    hits = f.topk_correct(d["input"], d["target"], k, data.dtype)
    return f.result(torch.tensor(hits / data.n, dtype=f.F64), data.dtype)
