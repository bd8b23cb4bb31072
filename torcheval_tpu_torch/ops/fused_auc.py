"""Fused approximate AUC — the analog of the reference's optional
``fbgemm_gpu.metrics.auc`` kernel (reference
``torcheval/metrics/functional/classification/auroc.py:12-21,145-164``);
the port of ``torcheval_tpu/ops/fused_auc.py``.

Like fbgemm's kernel this is an *approximation*: it skips the tied-
threshold masking, so every sample is its own ROC point.  Plain PyTorch:
the JAX module holds no Pallas kernel either.
"""

import torch


def has_fused() -> bool:
    """Availability flag (the analog of the reference's ``has_fbgemm``)."""
    return True


def fused_auc(input: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Approximate AUC over the last axis; supports a leading task axis."""
    from torcheval_tpu_torch.metrics.functional.classification._sort_scan import (
        sorted_tie_cumsums,
    )

    squeeze = input.dim() == 1
    if squeeze:
        input, target = input[None], target[None]
    _, _, cum_tp, cum_fp = sorted_tie_cumsums(input.to(torch.float32), target)
    cum_tp = cum_tp.to(torch.float32)
    cum_fp = cum_fp.to(torch.float32)
    factor = cum_tp[:, -1] * cum_fp[:, -1]
    area = torch.trapezoid(cum_tp, cum_fp, dim=-1)
    auc = torch.where(factor == 0, 0.5, area / factor)
    return auc[0] if squeeze else auc
