"""The confusion matrix: rows targets, columns argmax predictions."""

from portbench.reference import formulas as f
from portbench.reference.members import whole


def reference(kw, data, position):
    d = whole(data, position)
    return f.confusion(d["target"], f.argmax(d["input"], data.dtype), int(kw["num_classes"]))
