"""f32 click labels, 1 with probability ``positive_share``, and f32
probabilities ``sigmoid(z + separation * label + offset)`` with ``z``
standard normal (binormal: AUROC = Phi(separation / sqrt 2))."""

import torch

from portbench.inputs import generator


def make(spec, n, seed, device):
    g = generator(seed, "ctr_probabilities", device)
    label = (torch.rand(n, generator=g, device=device) < float(spec["positive_share"])).float()
    z = torch.randn(n, generator=g, device=device)
    prob = torch.sigmoid(z + float(spec["separation"]) * label + float(spec["offset"]))
    return {"input": prob, "target": label}
