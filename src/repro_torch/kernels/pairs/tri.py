"""Triangular pair-slot decode: the CUDA kernel's wrapper and plain version.

The kernel (``csrc/tri_decode.cu``) replaces the TPU kernel
``tri_decode_pallas`` (``src/repro/kernels/pairs/pairs.py:61``). It is
memory-bound on the H100 (16 bytes a slot against ~12 integer operations
per search step): one thread per slot, coalesced loads, the whole search
in registers. The plain version repeats its uint32 arithmetic on int64
with explicit mod-2**32 masks, so the two agree on every lane, including
the garbage lanes with ``n < 2`` that callers mask.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ...core import u64
from .._build import Kernel, check_cuda, ptr

# Largest block size whose row products fit uint32 (65533*65534 < 2**32).
MAX_BLOCK_N = 65535
# ceil(log2(MAX_BLOCK_N - 1)) = 16 candidate-row halvings always suffice
MAX_SEARCH_STEPS = 16

KERNEL = Kernel("tri_decode", "tri_decode.cu", "tri_decode_launch",
                [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int])

_M32 = 0xFFFFFFFF


def search_steps_for(max_block: int) -> int:
    """Binary-search depth covering row range [0, max_block - 2]."""
    span = max(2, max_block - 1)
    return min(MAX_SEARCH_STEPS, max(1, (span - 1).bit_length()))


def tri_decode_torch(local: torch.Tensor, n: torch.Tensor,
                     steps: int = MAX_SEARCH_STEPS
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: exact uint32 binary search, emulated on int64."""
    t = local.to(torch.int64) & _M32
    n = n.to(torch.int64) & _M32
    nm1 = (n - 1) & _M32

    def cum(r):
        return ((r * nm1) - (((r * ((r - 1) & _M32)) & _M32) >> 1)) & _M32

    lo = torch.zeros_like(t)
    hi = torch.where(n >= 2, n - 2, 0)
    for _ in range(steps):
        mid = ((lo + hi + 1) & _M32) >> 1
        go_right = cum(mid) <= t
        lo = torch.where(go_right, mid, lo)
        hi = torch.where(go_right, hi, (mid - 1) & _M32)
    j = (t - cum(lo) + lo + 1) & _M32
    return u64.to_int32_bits(lo), u64.to_int32_bits(j)


def tri_decode(local: torch.Tensor, n: torch.Tensor,
               steps: int = MAX_SEARCH_STEPS
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int32 local slot + block size -> (i, j) int32, any 1-D length.

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if local.device.type == "cpu":
        return tri_decode_torch(local, n, steps)
    check_cuda("local", local, torch.int32)
    check_cuda("n", n, torch.int32)
    if local.shape != n.shape or local.dim() != 1:
        raise ValueError(f"local {tuple(local.shape)} and n {tuple(n.shape)} "
                         "must be equal 1-D shapes")
    if not 1 <= steps <= MAX_SEARCH_STEPS:
        raise ValueError(f"steps {steps} outside [1, {MAX_SEARCH_STEPS}]")
    i = torch.empty_like(local)
    j = torch.empty_like(local)
    KERNEL(ptr(local), ptr(n), ptr(i), ptr(j), local.numel(), steps)
    return i, j
