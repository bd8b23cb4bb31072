"""Exact binary AUROC over the whole set, Mann-Whitney with ties."""

from portbench.reference import formulas as f
from portbench.reference.members import whole


def reference(kw, data, position):
    d = whole(data, position)
    return f.result(f.binary_auroc(d["input"], d["target"], data.dtype), data.dtype)
