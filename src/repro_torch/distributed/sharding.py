"""Shard ids and process groups over a ``DeviceMesh``'s named dims.

The JAX package maps a mesh's axes to devices inside one controller;
here ``mesh`` is a ``torch.distributed.device_mesh.DeviceMesh``, its
``mesh_dim_names`` are the reference's axis names, and every rank runs
the same host loop (SPMD). A rank's shard id is its row-major position over
``axis_names`` (the reference's ``linear_shard_index``); the collectives
of a routed step run on the group of the ranks those dims span, whose
group-rank order must be the shard order.

Of the reference's ``distributed/sharding.py`` only ``axis_size`` serves
blocking; the logical-axis rules serve the models.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch.distributed as dist

from ..core.routing import linear_shard_index


def axis_size(mesh, ax) -> int:
    """Total rank count over a mesh dim name, a tuple of them, or None (=1)."""
    if ax is None:
        return 1
    axes = ax if isinstance(ax, tuple) else (ax,)
    n = 1
    for a in axes:
        n *= mesh.size(mesh.mesh_dim_names.index(a))
    return n


@dataclasses.dataclass(frozen=True)
class Shards:
    """This rank's place among the shards of ``axis_names``."""

    group: object     # the ProcessGroup the routed collectives run on
    shard: int        # row-major position over axis_names
    n_shards: int


def _dims(mesh, axes: Tuple[str, ...]) -> Tuple[int, ...]:
    names = tuple(mesh.mesh_dim_names or ())
    missing = [a for a in axes if a not in names]
    if missing:
        raise ValueError(f"mesh dims {names} have no {missing}")
    return tuple(names.index(a) for a in axes)


def shards(mesh, axis_names: Sequence[str]) -> Shards:
    """The group and shard id of this rank over ``axis_names``.

    ``axis_names`` is one mesh dim, or every dim of the mesh in its
    order (the reference's flat, pod and 3-axis meshes), so that group
    rank order is shard order.
    """
    axes = tuple(axis_names)
    dims = _dims(mesh, axes)
    if len(dims) == 1:
        group = mesh.get_group(dims[0])
    elif dims == tuple(range(mesh.ndim)):
        ranks = mesh.mesh.flatten().tolist()
        if ranks != list(range(dist.get_world_size())):
            raise ValueError("a multi-dim mesh must hold every rank of the "
                             "world in rank order")
        group = dist.group.WORLD
    else:
        raise ValueError(f"axis_names {axes} must be one mesh dim or all of "
                         f"{tuple(mesh.mesh_dim_names)} in order")
    shard = linear_shard_index(mesh, axes)
    if dist.get_rank(group) != shard:
        raise ValueError(f"group rank {dist.get_rank(group)} is not shard "
                         f"{shard}: the mesh's ranks must ascend row-major")
    return Shards(group, shard, axis_size(mesh, axes))
