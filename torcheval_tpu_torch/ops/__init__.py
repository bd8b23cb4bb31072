"""Kernels of the port: CUDA C++ for Hopper under ``csrc/``, each with a
plain PyTorch version beside its wrapper.

* :mod:`.auc` — exact AUC scan over sorted scores (``csrc/auc_scan.cu``).
* :mod:`.ustat` — rank-sum counts for the sort-free exact AUROC route
  (``csrc/rank_sum.cu``).
* :mod:`.fused_auc` — the approximate fused AUC (plain PyTorch).
* :mod:`._build` — builds the kernels with ``nvcc`` at first use and
  counts their launches.
"""
