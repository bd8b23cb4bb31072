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
* :mod:`.fused_auc` — the approximate fused AUC (plain PyTorch).
* :mod:`._build` — builds the kernels with ``nvcc`` at first use and
  counts their launches.
"""

from torcheval_tpu_torch.ops.wavefront import edit_distance_tokens

__all__ = ["edit_distance_tokens"]
