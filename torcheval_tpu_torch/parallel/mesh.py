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

A collective over the mesh reduces over every one of its axes (one name on
a 1-D mesh, the tuple of all names in mesh order on an n-D one).  A
reduction over a strict sub-axis needs a sub-group of the world, which
comes with the process-group slice (ROADMAP queue 1 item 6): it raises
``NotImplementedError`` and never falls back to the whole world.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

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

    def all_reduce_many(self, tensors: Sequence[torch.Tensor], ops: Sequence[str],
                        axis: AxisSpec) -> list:
        """Each tensor reduced with its op over ``axis``, which must be
        every axis of the mesh (see the module docstring): the group's
        ``CollectiveGroup.all_reduce_many``, one collective for all."""
        _check_full_axis(self, axis)
        return self.group.all_reduce_many(tensors, ops)

    def __repr__(self) -> str:
        return f"Mesh(shape={self.shape}, rank={self.rank})"


def _names(mesh: Mesh, axis: AxisSpec) -> Tuple[str, ...]:
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    unknown = [a for a in names if a not in mesh.shape]
    if unknown or len(set(names)) != len(names):
        raise ValueError(f"axis {axis!r} is not a set of the mesh's axes {mesh.axis_names}")
    return names


def _check_full_axis(mesh: Mesh, axis: AxisSpec) -> None:
    names = _names(mesh, axis)
    if names != mesh.axis_names:
        raise NotImplementedError(
            f"a reduction over {axis!r} on a mesh with axes {mesh.axis_names}: the port "
            "reduces over every axis of the mesh, in mesh order; a sub-axis needs a "
            "sub-group of the world, which comes with the process-group slice "
            "(ROADMAP queue 1 item 6)."
        )


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
