"""Share of the least time of the token NLL in the device time of
``token_nll.cu``'s kernels, over the traced passes.

The least time reads every logit once, each int64 target once and writes
one float32 NLL a token, at the card's peak bandwidth.  The bytes come
from the configuration's shapes (sequences a pass, sequence length,
vocabulary, the logits' type), not from the kernel's operands, so a
kernel that reads more shows as a lower share.  They count every token's
row, those at ``ignore_index`` too (2 % in ``dsv3_lm_val``): the kernel
takes no ``ignore_index`` and reads them, though the answer needs them
not, so the share stands about two points above one counted on the
answer's tokens alone.

It reads nothing where the port counted no launch of the kernel (a
program without it), and fails where the port counted launches that the
trace names no kernel of (a kernel renamed, or rows lost)."""

import torch

from portbench.peaks import HBM_BYTES_PER_S

KERNELS = ("token_nll_kernel",)
COUNTER = "token_nll"  # ops._build.LAUNCHES key


def problem_bytes(tokens, vocab, itemsize):
    return tokens * (vocab * itemsize + 8 + 4)


def read(trace):
    ops = trace.named(*KERNELS)
    launched = trace.launches.get(COUNTER, 0)
    if launched and not ops:
        raise RuntimeError(f"{COUNTER} launched {launched} times, and the trace names none of {KERNELS}")
    if not ops or not trace.computes:
        return None
    c = trace.config
    tokens = trace.computes * int(c["num_samples"]) * int(c["seq_len"])
    itemsize = getattr(torch, c["logits_dtype"]).itemsize
    least = problem_bytes(tokens, int(c["vocab_size"]), itemsize) / HBM_BYTES_PER_S
    return 100.0 * least / trace.device_seconds(ops)
