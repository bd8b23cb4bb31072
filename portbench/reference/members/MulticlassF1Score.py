"""Macro F1 from the confusion matrix."""

from portbench.reference import formulas as f
from portbench.reference.members import whole


def reference(kw, data, position):
    if kw.get("average") != "macro":
        raise ValueError("the reference has macro F1 only")
    d = whole(data, position)
    cm = f.confusion(d["target"], f.argmax(d["input"], data.dtype), int(kw["num_classes"]))
    return f.result(f.macro_f1(cm), data.dtype)
