"""Kernels of the port: CUDA C++ for Hopper under ``csrc/``, each with a
plain PyTorch version beside its wrapper.

* :mod:`.auc` — exact AUC scan over sorted scores (``csrc/auc_scan.cu``).
* :mod:`.ustat` — rank-sum counts for the sort-free exact AUROC route
  (``csrc/rank_sum.cu``) and rank histograms for the exact AUPRC route
  (``csrc/rank_hist.cu``).
* :mod:`.binned` — per-threshold counts of the binned metrics
  (``csrc/binned_count.cu``) and their weighted sums under the sharded
  histograms (``csrc/binned_wcount.cu``).
* :mod:`.cm` — the confusion-matrix count slab (``csrc/cm_slab.cu``).
* :mod:`.mega` — the one-pass collection kernel (``csrc/mega.cu``) that
  counts every supported member of a ``MetricCollection`` in one read of
  the batch, planned by :mod:`._mega_plan`.
* :mod:`.wavefront` — batched token-level edit distance by an
  anti-diagonal sweep (``csrc/wavefront.cu``), under the text metrics.
* :mod:`.token_nll` — each token's negative log-likelihood from
  next-token logits in one read of each row (``csrc/token_nll.cu``), under
  ``Perplexity``; it replaces no TPU kernel.
* :mod:`.rank_sketch` — the rank-sketch counts of ``sketch=True`` curve
  metrics (``binned_count.cu`` on the GPU, a ``bincount`` plain version on
  the CPU) and the dyadic ladder of ``monitor.StreamDigest`` (plain
  PyTorch).
* :mod:`.fused_auc` — the approximate fused AUC (plain PyTorch).
* :mod:`._build` — builds the kernels with ``nvcc`` at first use and
  counts their launches.

The package exports the names of ``torcheval_tpu.ops`` that have a
counterpart here.  ``has_pallas``, ``pallas_binary_auroc`` and
``wavefront_route`` have none: the port has no switch that sends a GPU
tensor to a kernel's plain version (no ``DISABLE_PALLAS``, no wavefront
flag), so there is no availability to ask and no route to pick; the exact
sort route is ``auc.binary_auroc_sorted_path``.
"""

from torcheval_tpu_torch.ops.auc import auc_from_sorted
from torcheval_tpu_torch.ops.fused_auc import fused_auc, has_fused
from torcheval_tpu_torch.ops.wavefront import edit_distance_tokens

__all__ = ["auc_from_sorted", "edit_distance_tokens", "fused_auc", "has_fused"]
