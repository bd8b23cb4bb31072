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

Not ported yet: the exact sharded family (``parallel/exact.py``, ROADMAP
queue 1 item 3) and the fleet merge (``parallel/fleet_merge.py``, item 6).
"""

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
    "Mesh",
    "bucket_shard_batch",
    "device_count",
    "make_mesh",
    "make_synced_update",
    "mesh_merge_states",
    "replicate",
    "shard_batch",
    "sharded_auprc_histogram",
    "sharded_auroc_histogram",
    "sharded_multiclass_auroc_histogram",
]
