"""Bulk u64 mixing and combining: the CUDA kernels' wrappers and plain versions.

The kernels (``csrc/hash64.cu``) replace the TPU kernels ``mix64_pallas``
and ``combine64_pallas`` (``src/repro/kernels/hash64/hash64.py:62`` and
``:55``). Both are elementwise and memory-bound on the H100 (16 and 24
bytes a key): one thread per key in a grid-stride loop, the splitmix64
chain in ``uint64_t`` registers. The plain versions run the same chain
on int64 bit patterns (``core/u64.py``); the two agree on every bit.
"""
from __future__ import annotations

import ctypes

import torch

from ...core import u64
from .._build import Kernel, check_cuda, ptr

# splitmix64 constants (the JAX package's core/hashing.py)
GAMMA = 0x9E3779B97F4A7C15
M1 = 0xBF58476D1CE4E5B9
M2 = 0x94D049BB133111EB
_GAMMA_S = u64.signed(GAMMA)
_M1_S = u64.signed(M1)
_M2_S = u64.signed(M2)

MIX_KERNEL = Kernel("mix64", "hash64.cu", "mix64_launch",
                    [ctypes.c_void_p] * 2 + [ctypes.c_longlong])
COMBINE_KERNEL = Kernel("combine64", "hash64.cu", "combine64_launch",
                        [ctypes.c_void_p] * 3 + [ctypes.c_longlong])


def mix64_torch(x: torch.Tensor) -> torch.Tensor:
    """Plain version: the splitmix64 finalizer, any shape or layout."""
    x = x ^ u64.shr(x, 30)
    x = x * _M1_S
    x = x ^ u64.shr(x, 27)
    x = x * _M2_S
    return x ^ u64.shr(x, 31)


def combine64_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version: ``lo = min_u64(a, b)``, ``hi`` the other key, then
    ``mix64((mix64(lo) ^ rotl(hi, 29)) + GAMMA)``."""
    lo = u64.minimum(a, b)
    hi = torch.where(lo == a, b, a)
    return mix64_torch((mix64_torch(lo) ^ u64.rotl(hi, 29)) + _GAMMA_S)


def mix64_bulk(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer over an int64 u64 array of any shape.

    CUDA tensors (contiguous) launch the kernel; CPU tensors take the
    plain version.
    """
    if x.device.type == "cpu":
        return mix64_torch(x)
    check_cuda("x", x, torch.int64)
    out = torch.empty_like(x)
    if x.numel():
        MIX_KERNEL(ptr(x), ptr(out), x.numel())
    return out


def combine64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Order-canonical combine of two int64 u64 arrays of one shape.

    CUDA tensors (contiguous) launch the kernel; CPU tensors take the
    plain version.
    """
    if a.shape != b.shape:
        raise ValueError(f"a {tuple(a.shape)} and b {tuple(b.shape)} differ")
    if a.device.type == "cpu":
        return combine64_torch(a, b)
    check_cuda("a", a, torch.int64)
    check_cuda("b", b, torch.int64)
    out = torch.empty_like(a)
    if a.numel():
        COMBINE_KERNEL(ptr(a), ptr(b), ptr(out), a.numel())
    return out
