"""Next-token logits ``(n, seq_len, vocab_size)`` in ``dtype``, standard
normal with ``margin`` added to each target's logit, and int64 target ids
uniform over the vocabulary with a seeded ``ignore_share`` of the positions
set to ``ignore_index``.

Made on the device in place, ``CHUNK`` sequences at a time: no float32
copy of the set exists (16 sequences of 4096 x 129 280 bf16 hold 16.9 GB).
"""

import torch

from portbench.inputs import generator

CHUNK = 2  # sequences a step of the margin's index arithmetic


def make(spec, n, seed, device):
    seq, vocab = int(spec["seq_len"]), int(spec["vocab_size"])
    g = generator(seed, "lm_logits", device)
    target = torch.randint(0, vocab, (n, seq), generator=g, device=device)
    ignored = torch.rand((n, seq), generator=g, device=device) < float(spec["ignore_share"])
    logits = torch.empty((n, seq, vocab), dtype=getattr(torch, spec["dtype"]), device=device)
    for i in range(0, n, CHUNK):
        rows = logits[i : i + CHUNK].view(-1, vocab)
        rows.normal_(generator=g)
        hit = torch.arange(rows.shape[0], device=device), target[i : i + CHUNK].reshape(-1)
        rows[hit] += float(spec["margin"])
    target[ignored] = int(spec["ignore_index"])
    return {"input": logits, "target": target}
