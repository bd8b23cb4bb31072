"""Kernels of the port: CUDA C++ for Hopper under ``csrc/``, each with a
plain PyTorch version beside its wrapper.

* :mod:`.auc` — exact AUC scan over sorted scores (``csrc/auc_scan.cu``).
* :mod:`.ustat` — rank-sum counts for the sort-free exact AUROC route
  (``csrc/rank_sum.cu``) and rank histograms for the exact AUPRC route
  (``csrc/rank_hist.cu``).
* :mod:`.binned` — per-threshold counts of the binned metrics
  (``csrc/binned_count.cu``).
* :mod:`.cm` — the confusion-matrix count slab (``csrc/cm_slab.cu``).
* :mod:`.fused_auc` — the approximate fused AUC (plain PyTorch).
* :mod:`._build` — builds the kernels with ``nvcc`` at first use and
  counts their launches.
"""
