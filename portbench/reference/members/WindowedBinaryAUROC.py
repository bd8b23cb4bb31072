"""Binary AUROC over the last ``max_num_samples`` samples of the stream."""

from portbench.reference import formulas as f


def reference(kw, data, position):
    hi = data.samples_before(position)
    d = data.sample_range(max(0, hi - int(kw["max_num_samples"])), hi)
    return f.result(f.binary_auroc(d["input"], d["target"], data.dtype), data.dtype)
