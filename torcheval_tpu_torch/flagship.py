"""The flagship evaluation step: a classifier's forward pass whose scores
flow straight into accuracy, a confusion matrix and macro AUROC (the
counterpart of the eval step of ``__graft_entry__.entry()``, through the
port's public functional API).

    model = FlagshipMLP()                       # lives on the GPU
    model.load_state_dict(convert.params_from_jax(numpy_params))
    out = eval_step(model, x, target)

At the flagship's width (8 classes, 1024 rows) the confusion matrix takes
the one-hot matmul route and the AUROC the sort route, whose AUC scan is
the CUDA kernel ``ops/csrc/auc_scan.cu``.
"""

from typing import Dict

import torch
from torch import nn

from torcheval_tpu_torch.metrics.functional import (
    multiclass_accuracy,
    multiclass_auroc,
    multiclass_confusion_matrix,
)
from torcheval_tpu_torch.metrics.metric import DeviceLike, canonicalize_device

NUM_CLASSES = 8
FEATURES = 32
HIDDEN = 64


class FlagshipMLP(nn.Module):
    """``32 → 64 → 8`` with a ReLU between, as the JAX flagship's
    ``_forward`` computes ``relu(x @ w1 + b1) @ w2 + b2``.  Built on the
    GPU unless ``device`` says otherwise."""

    def __init__(self, *, device: DeviceLike = None) -> None:
        super().__init__()
        device = canonicalize_device(device)
        self.fc1 = nn.Linear(FEATURES, HIDDEN, device=device)
        self.fc2 = nn.Linear(HIDDEN, NUM_CLASSES, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(torch.relu(self.fc1(x)))


@torch.no_grad()
def eval_step(model: FlagshipMLP, x, target) -> Dict[str, torch.Tensor]:
    """Logits, micro accuracy, the confusion matrix of the argmax and
    macro one-vs-rest AUROC of the softmax scores, on the model's
    device (inputs are moved there)."""
    device = model.fc1.weight.device
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    target = torch.as_tensor(target, device=device)
    logits = model(x)
    scores = torch.softmax(logits, dim=-1)
    return {
        "logits": logits,
        "accuracy": multiclass_accuracy(scores, target),
        "confusion_matrix": multiclass_confusion_matrix(
            torch.argmax(scores, dim=-1), target, num_classes=NUM_CLASSES
        ),
        "auroc": multiclass_auroc(
            scores, target, num_classes=NUM_CLASSES, average="macro"
        ),
    }
