"""Mesh sync for metrics (the port's slice of ``torcheval_tpu/parallel``).

* :mod:`.mesh`: a :class:`~.mesh.Mesh` is a world of ranks with named axes
  (the port's idiom for a JAX device mesh: each rank calls the sharded
  functions with its own shard), ``make_mesh``, ``shard_batch``,
  ``replicate``, ``bucket_shard_batch``, ``device_count``.
* :mod:`.sync`: ``mesh_merge_states`` and ``make_synced_update`` (one
  collective merges every rank's partial states), and the O(num_bins)-wire
  binned curve metrics ``sharded_auroc_histogram``,
  ``sharded_auprc_histogram`` and ``sharded_multiclass_auroc_histogram``
  over the binned-count kernels.
* :mod:`.exact`: the exact sharded AUROC / AUPRC, the gather-exact family
  (``sharded_binary_auroc_exact``, ``sharded_binary_auprc_exact``,
  ``sharded_multitask_auroc_exact``, ``sharded_multitask_auprc_exact``,
  ``sharded_multiclass_auroc_exact``: bit for bit the single-device
  functional on the concatenated blocks) and the ustat family
  (``sharded_binary_auroc_ustat``, ``sharded_binary_auprc_ustat``,
  ``sharded_multiclass_auroc_ustat``: only the minority class or the
  positives travel; the multiclass one counts with the rank-sum kernel);
  ``eager_ustat_pin`` stays in :mod:`.exact`, as in the JAX package.

* :mod:`.fleet_merge`: the elastic hierarchical merge of a metric's state
  over a group's point-to-point channel (``fleet_merge``, tree or ring,
  exact or sketch payloads; ``MergePolicy``, ``MergeOutcome``, and
  ``PendingMerge`` for a merge that runs beside further eval work).

``spmd_cache_info`` / ``spmd_cache_clear`` (a JAX jit cache) have no
counterpart.
"""

from torcheval_tpu_torch.parallel.exact import (
    sharded_binary_auprc_exact,
    sharded_binary_auprc_ustat,
    sharded_binary_auroc_exact,
    sharded_binary_auroc_ustat,
    sharded_multiclass_auroc_exact,
    sharded_multiclass_auroc_ustat,
    sharded_multitask_auprc_exact,
    sharded_multitask_auroc_exact,
)
from torcheval_tpu_torch.parallel.fleet_merge import (
    MergeOutcome,
    MergePolicy,
    PendingMerge,
    fleet_merge,
)
from torcheval_tpu_torch.parallel.mesh import (
    Mesh,
    bucket_shard_batch,
    device_count,
    make_mesh,
    replicate,
    shard_batch,
)
from torcheval_tpu_torch.parallel.sync import (
    make_synced_update,
    mesh_merge_states,
    sharded_auprc_histogram,
    sharded_auroc_histogram,
    sharded_multiclass_auroc_histogram,
)

__all__ = [
    "MergeOutcome",
    "MergePolicy",
    "Mesh",
    "PendingMerge",
    "bucket_shard_batch",
    "device_count",
    "fleet_merge",
    "make_mesh",
    "make_synced_update",
    "mesh_merge_states",
    "replicate",
    "shard_batch",
    "sharded_auprc_histogram",
    "sharded_auroc_histogram",
    "sharded_binary_auprc_exact",
    "sharded_binary_auprc_ustat",
    "sharded_binary_auroc_exact",
    "sharded_binary_auroc_ustat",
    "sharded_multiclass_auroc_exact",
    "sharded_multiclass_auroc_histogram",
    "sharded_multiclass_auroc_ustat",
    "sharded_multitask_auprc_exact",
    "sharded_multitask_auroc_exact",
]
