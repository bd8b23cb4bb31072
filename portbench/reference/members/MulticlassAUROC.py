"""Macro one-vs-rest AUROC, Mann-Whitney with ties."""

from portbench.reference import formulas as f
from portbench.reference.members import whole


def reference(kw, data, position):
    if kw.get("average", "macro") != "macro":
        raise ValueError("the reference has macro AUROC only")
    d = whole(data, position)
    return f.result(f.multiclass_auroc_macro(d["input"], d["target"], data.dtype), data.dtype)
