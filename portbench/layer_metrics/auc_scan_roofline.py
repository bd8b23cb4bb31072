"""Share of the least time of the binary AUC scan in the device time of
``auc_scan.cu``'s kernels, per compute.

The least time reads the n sorted float32 scores and n labels (one byte
each, the least a 0/1 label takes) once and writes one float32, at the
card's peak bandwidth.  n is every sample the AUROC member covers: its
window where it has one, else the whole evaluation set.

It reads nothing where the port counted no launch of the scan (the route
is off the path), and fails where the port counted launches that the
trace names no kernel of (a kernel renamed, or rows lost)."""

from portbench.peaks import HBM_BYTES_PER_S

KERNELS = ("auc_chunk_kernel", "auc_combine_kernel")
COUNTER = "auc_from_sorted"  # ops._build.LAUNCHES key
AUROC_CLASSES = ("BinaryAUROC", "WindowedBinaryAUROC")


def problem_bytes(n):
    return 4 * n + n + 4


def samples(trace):
    for group in trace.suite["suite"]:
        for m in group["members"].values():
            if m["class"] in AUROC_CLASSES:
                kwargs = m.get("kwargs", {})
                return int(kwargs.get("max_num_samples", trace.config["num_samples"]))
    return None


def read(trace):
    ops = trace.named(*KERNELS)
    launched = trace.launches.get(COUNTER, 0)
    if launched and not ops:
        raise RuntimeError(f"{COUNTER} launched {launched} times, and the trace names none of {KERNELS}")
    n = samples(trace)
    if not ops or not trace.computes or n is None:
        return None
    least = trace.computes * problem_bytes(n) / HBM_BYTES_PER_S
    return 100.0 * least / trace.device_seconds(ops)
