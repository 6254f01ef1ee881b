"""Production mesh definitions (the reference's shapes).

Port of the JAX package's ``launch/mesh.py`` over ``DeviceMesh``: one
process a rank, so the mesh needs a process group of exactly its size
(``torchrun`` with 256 or 512 ranks). ``make_production_mesh`` is a
function, so importing this module touches no process group.
"""
from __future__ import annotations

import torch.distributed as dist

from ..distributed.sharding import data_axes  # noqa: F401  (the reference's name here)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 = 256 ranks single-pod ``("data", "model")``; 2x16x16 = 512
    across two pods ``("pod", "data", "model")``. Raises ``ValueError``
    unless the process group holds exactly that many ranks."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} needs a "
                         f"process group of {n} ranks; this one has {world}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def num_chips(mesh) -> int:
    return mesh.size()
