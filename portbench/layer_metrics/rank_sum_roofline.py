"""Share of the least time of the multiclass AUROC counting step in the
device time of ``rank_sum.cu``'s kernels, per compute.

The least time reads the problem once at the card's peak bandwidth: the
N x C float32 scores, the N int64 targets, and C int64 counts written.
The bytes come from the shapes of the problem, not from one kernel's
operands, so a kernel that reads more shows as a lower share.

It reads nothing where the port counted no launch of the kernel (the
route is off the path), and fails where the port counted launches that
the trace names no kernel of (a kernel renamed, or rows lost)."""

from portbench.peaks import HBM_BYTES_PER_S

KERNELS = ("rank_sum_kernel",)
COUNTER = "rank_sum_counts"  # ops._build.LAUNCHES key


def problem_bytes(n, c):
    return 4 * n * c + 8 * n + 8 * c


def read(trace):
    ops = trace.named(*KERNELS)
    launched = trace.launches.get(COUNTER, 0)
    if launched and not ops:
        raise RuntimeError(f"{COUNTER} launched {launched} times, and the trace names none of {KERNELS}")
    if not ops or not trace.computes:
        return None
    n, c = int(trace.config["num_samples"]), int(trace.config["num_classes"])
    least = trace.computes * problem_bytes(n, c) / HBM_BYTES_PER_S
    return 100.0 * least / trace.device_seconds(ops)
