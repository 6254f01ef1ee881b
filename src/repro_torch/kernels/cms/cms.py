"""Count-Min Sketch build: the CUDA kernel's wrapper and plain version.

The kernel (``csrc/cms.cu``) replaces the TPU kernel ``cms_update_pallas``
(``src/repro/kernels/cms/cms.py:42``): ``out[d, idx[d, n]] += mask[n]``
into a zeroed (depth, width) int32 sketch. One pass over the entries
serves every row: a warp loads 16 mask bytes a lane, compacts its live
entries, and adds each live (entry, row) with a global atomic; entries of
one warp that hit the same bucket (the skew of an over-sized block) are
combined with ``__match_any_sync`` first. The counts are exact, so the
kernel and the plain per-row ``index_add_`` agree on every bit.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import Kernel, check_cuda, ptr

KERNEL = Kernel("cms_update", "cms.cu", "cms_update_launch",
                [ctypes.c_void_p] * 3
                + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong])


def cms_update_torch(indices: torch.Tensor, mask: torch.Tensor, width: int
                     ) -> torch.Tensor:
    """Plain version: one ``index_add_`` per sketch row."""
    upd = mask.to(torch.int32)
    sketch = torch.zeros((indices.shape[0], width), dtype=torch.int32,
                         device=indices.device)
    for d in range(indices.shape[0]):
        sketch[d].index_add_(0, indices[d], upd)
    return sketch


def cms_update(indices: torch.Tensor, mask: torch.Tensor, width: int
               ) -> torch.Tensor:
    """(depth, N) int32 bucket indices in [0, width) + (N,) bool mask ->
    (depth, width) int32 sketch.

    CUDA tensors (contiguous) launch the kernel; CPU tensors take the
    plain version.
    """
    if indices.dim() != 2 or mask.shape != indices.shape[1:]:
        raise ValueError(f"indices {tuple(indices.shape)} and mask "
                         f"{tuple(mask.shape)} are not (depth, N) and (N,)")
    if indices.device.type == "cpu":
        return cms_update_torch(indices, mask, width)
    check_cuda("indices", indices, torch.int32)
    check_cuda("mask", mask, torch.bool)
    depth, n = indices.shape
    sketch = torch.zeros((depth, width), dtype=torch.int32,
                         device=indices.device)
    if depth and n:
        KERNEL(ptr(indices), ptr(mask), ptr(sketch), n, depth, width)
    return sketch
