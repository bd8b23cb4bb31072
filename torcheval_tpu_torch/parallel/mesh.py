"""Meshes of ranks and batch-sharding helpers (the port of
``torcheval_tpu/parallel/mesh.py``).

**The one idiom change.**  A JAX mesh is ONE program over a global array:
``shard_batch`` places the array's blocks on the mesh's devices, and a
``shard_map``-ped function sees each device's block.  The port follows
``torch.distributed`` instead: a :class:`Mesh` is a world of ranks, a
:class:`~torcheval_tpu_torch.distributed.CollectiveGroup` with named axes
whose sizes multiply to the group's ``world_size`` (rank ``r`` sits at
the row-major coordinates of ``r`` in the mesh's shape).  Each rank runs
the sharded functions itself, with ITS OWN shard: :func:`shard_batch`
returns the block of the global array that a JAX ``NamedSharding`` puts
on device ``rank``.  With the default single-process group the mesh has
one rank, and the shard is the whole array.

A collective over ``axis`` runs in :meth:`Mesh.axis_group`: the ranks that
share this rank's coordinates on the other axes, ranked by their block
index along ``axis``.  Over every axis in mesh order that is the group
itself; over a strict sub-axis (``"dp"`` of a ``("dp", "sp")`` mesh) it is
a sub-group (:meth:`~torcheval_tpu_torch.distributed.CollectiveGroup.split`),
so each ``sp`` slice reduces over ``dp`` alone, as a JAX collective named
``"dp"`` does inside ``shard_map``.  The mesh makes the sub-groups of
every strict subset of its axes when it is built: a ``torch.distributed``
sub-group is made by every rank of the world, in the same order.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from torcheval_tpu_torch.distributed import CollectiveGroup, default_group
from torcheval_tpu_torch.metrics._bucket import DEFAULT_MIN_BUCKET, pad_to_bucket

# A sharded entry point's sample axis: one mesh-axis name, or a tuple of
# names when samples are sharded jointly over several (e.g. dp x sp).
AxisSpec = Union[str, Tuple[str, ...]]


class Mesh:
    """A world of ranks with named axes: ``group`` (whose ``world_size``
    is the product of ``shape``) and ``axis_names``.  ``mesh.shape`` maps
    each name to its size, as a JAX mesh's does."""

    def __init__(
        self, group: CollectiveGroup, shape: Sequence[int], axis_names: Sequence[str]
    ) -> None:
        shape, axis_names = tuple(int(s) for s in shape), tuple(axis_names)
        if len(shape) != len(axis_names):
            raise ValueError(f"shape {shape} does not match axis_names {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names must be distinct, got {axis_names}")
        if int(np.prod(shape)) != group.world_size:
            raise ValueError(
                f"a mesh of shape {shape} needs a world of {int(np.prod(shape))} "
                f"ranks, the group has {group.world_size}"
            )
        self.group = group
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, shape))
        self._axis_groups: Dict[Tuple[str, ...], CollectiveGroup] = {axis_names: group}
        for k in range(1, len(axis_names)):
            for names in itertools.combinations(axis_names, k):
                self._axis_groups[names] = self._split(names)

    @property
    def rank(self) -> int:
        return self.group.rank

    def coords(self) -> dict:
        """``{axis name: coordinate}`` of this rank."""
        idx = np.unravel_index(self.rank, tuple(self.shape.values()))
        return dict(zip(self.axis_names, (int(i) for i in idx)))

    def block_index(self, axis: AxisSpec) -> int:
        """The block of a dimension sharded over ``axis`` that this rank
        holds: its coordinates along ``axis``, the first name major."""
        names = _names(self, axis)
        c = self.coords()
        return int(np.ravel_multi_index(tuple(c[a] for a in names),
                                        tuple(self.shape[a] for a in names)))

    def axis_group(self, axis: AxisSpec) -> CollectiveGroup:
        """The group a collective over ``axis`` runs in: the ranks that
        share this rank's coordinates off ``axis``, ranked by
        :meth:`block_index` along it."""
        names = _names(self, axis)
        if names not in self._axis_groups:  # the names in another order
            self._axis_groups[names] = self._split(names)
        return self._axis_groups[names]

    def _split(self, names: Tuple[str, ...]) -> CollectiveGroup:
        # Ranks laid out on the mesh, the other axes first and ``names``
        # last: each row is one part, in block-index order.
        others = [a for a in self.axis_names if a not in names]
        order = [self.axis_names.index(a) for a in (*others, *names)]
        ranks = np.arange(self.group.world_size).reshape(tuple(self.shape.values()))
        parts = ranks.transpose(order).reshape(-1, _axis_size(self, names))
        return self.group.split(parts.tolist())

    def all_reduce_many(self, tensors: Sequence[torch.Tensor], ops: Sequence[str],
                        axis: AxisSpec) -> list:
        """Each tensor reduced with its op over ``axis``: the
        ``CollectiveGroup.all_reduce_many`` of :meth:`axis_group`, one
        collective for all."""
        return self.axis_group(axis).all_reduce_many(tensors, ops)

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, rank={self.rank})"


def _names(mesh: Mesh, axis: AxisSpec) -> Tuple[str, ...]:
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    unknown = [a for a in names if a not in mesh.shape]
    if unknown or len(set(names)) != len(names):
        raise ValueError(f"axis {axis!r} is not a set of the mesh's axes {mesh.axis_names}")
    return names


def _axis_size(mesh: Mesh, axis: AxisSpec) -> int:
    """Ranks along ``axis``: one mesh-axis name, or a tuple of names
    (samples sharded jointly over e.g. ``("dp", "sp")``)."""
    size = 1
    for a in _names(mesh, axis):
        size *= mesh.shape[a]
    return size


def device_count() -> int:
    """The CUDA devices this process sees (0 without a GPU).  A mesh's
    size is its group's world size, whatever the devices: the ranks of a
    :class:`~torcheval_tpu_torch.distributed.LocalWorld` share one card."""
    return torch.cuda.device_count()


def make_mesh(
    shape: Union[int, Sequence[int], None] = None,
    axis_names: Tuple[str, ...] = ("dp",),
    group: Optional[CollectiveGroup] = None,
) -> Mesh:
    """A named mesh over ``group`` (the default group: one rank).

    ``shape`` may be an int (a 1-D mesh), a tuple (a multi-D mesh), or
    ``None`` (a 1-D mesh over the whole world).  Its sizes multiply to the
    group's world size: a JAX mesh over the first few devices has no
    counterpart here, since a rank outside the mesh would need a
    sub-group.  ``group`` takes the place of JAX's ``devices=``."""
    group = default_group() if group is None else group
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError("shape is required for a multi-axis mesh")
        shape = (group.world_size,)
    if isinstance(shape, int):
        shape = (shape,)
    return Mesh(group, shape, axis_names)


def shard_batch(
    mesh: Mesh,
    *arrays: Any,
    axis: AxisSpec = "dp",
    dim: int = 0,
) -> Union[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """This rank's contiguous block of dimension ``dim`` of each array (a
    view, on the array's device), sharded over ``axis`` (a name, or a
    tuple of names to shard one dimension jointly over several axes,
    the first name major): the block a JAX ``NamedSharding`` puts on this
    rank's device.  Raises when the dimension does not divide, as
    ``shard_map`` does."""
    parts = _axis_size(mesh, axis)
    block = mesh.block_index(axis)
    out = []
    for a in arrays:
        a = torch.as_tensor(a)
        d = dim if dim >= 0 else dim + a.dim()
        if not 0 <= d < a.dim():
            raise ValueError(f"dim {dim} out of range for array of rank {a.dim()}")
        if a.shape[d] % parts:
            raise ValueError(
                f"dimension {d} of size {a.shape[d]} does not divide into {parts} "
                f"shards over axis {axis!r}"
            )
        size = a.shape[d] // parts
        out.append(a.narrow(d, block * size, size))
    return out[0] if len(out) == 1 else tuple(out)


def replicate(mesh: Mesh, tree):
    """``tree`` as every rank holds it: unchanged.  Each rank of the port's
    mesh already holds what it passes (JAX places a replicated copy on
    every device)."""
    return tree


def bucket_shard_batch(
    mesh: Mesh,
    *arrays: Any,
    axis: AxisSpec = "dp",
    min_bucket: Optional[int] = None,
    mask=None,
):
    """:func:`shard_batch` for ragged streams: pad the shared leading dim
    up to a power-of-two bucket that is also a multiple of the ranks along
    ``axis`` (so the shard divides), and return this rank's blocks with
    its block of the validity mask (1 for real rows, 0 for padding), as
    ``(sharded_arrays_tuple, mask)``."""
    padded, out_mask = pad_to_bucket(
        *arrays,
        mask=mask,
        min_bucket=DEFAULT_MIN_BUCKET if min_bucket is None else min_bucket,
        multiple_of=_axis_size(mesh, axis),
    )
    sharded = shard_batch(mesh, *padded, axis=axis)
    if len(padded) == 1:
        sharded = (sharded,)
    return sharded, shard_batch(mesh, out_mask, axis=axis)


__all__ = (
    "AxisSpec",
    "Mesh",
    "bucket_shard_batch",
    "device_count",
    "make_mesh",
    "replicate",
    "shard_batch",
)
