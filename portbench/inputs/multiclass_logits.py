"""f32 logits ``(n, C)``, standard normal, with ``margin`` added to the
target's logit; int64 targets, a seeded permutation of ``n / C`` of each
class."""

import torch

from portbench.inputs import generator


def make(spec, n, seed, device):
    c = int(spec["num_classes"])
    if n % c:
        raise ValueError(f"{n} samples do not split evenly over {c} classes")
    g = generator(seed, "multiclass_logits", device)
    scores = torch.randn((n, c), generator=g, device=device, dtype=torch.float32)
    order = torch.randperm(n, generator=g, device=device)
    target = torch.arange(c, device=device).repeat_interleave(n // c)[order]
    scores[torch.arange(n, device=device), target] += float(spec["margin"])
    return {"input": scores, "target": target}
