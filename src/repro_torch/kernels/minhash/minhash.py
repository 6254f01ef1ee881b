"""MinHash over padded token sets: the CUDA kernel's wrapper and plain version.

The kernel (``csrc/minhash.cu``) replaces the TPU kernel ``minhash_pallas``
(``src/repro/kernels/minhash/minhash.py:65``). It is integer-ALU work on
the H100 (the splitmix64 chain): a thread owns one row and eight of its
hashes, with the addends and minima in registers; a masked slot hashes the
row's first valid token instead, so the token loop has no branch. The
plain version is the JAX package's ``core/minhash.minhash_tokens`` loop on
int64 bit patterns; the two agree on every bit.
"""
from __future__ import annotations

import ctypes

import torch

from ...core import u64
from .._build import Kernel, check_cuda, ptr
from ..hash64.hash64 import GAMMA, mix64_torch

MH_SEED = 0x3141

KERNEL = Kernel("minhash", "minhash.cu", "minhash_launch",
                [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_uint64,
                 ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                 ctypes.c_int])


def hash_addends(num_hashes: int, seed: int = MH_SEED):
    """Per-hash u64 addends ``(seed + 977 i + 1) * GAMMA mod 2**64``,
    as int64 bit patterns (``minhash.py:75`` of the JAX package)."""
    return [u64.signed((seed + 977 * i + 1) * GAMMA) for i in range(num_hashes)]


def minhash_torch(tokens: torch.Tensor, mask: torch.Tensor, num_hashes: int,
                  seed: int = MH_SEED) -> torch.Tensor:
    """Plain version: one (R, T) hash chain and row minimum per hash."""
    x = u64.from_u32(tokens)
    out = torch.empty((tokens.shape[0], num_hashes), dtype=torch.int64,
                      device=tokens.device)
    for i, add in enumerate(hash_addends(num_hashes, seed)):
        lo = u64.lo32(mix64_torch(x + add))
        lo = torch.where(mask, lo, u64.MASK32)
        out[:, i] = lo.amin(dim=1) if lo.shape[1] else u64.MASK32
    return out


def minhash(tokens: torch.Tensor, mask: torch.Tensor, num_hashes: int,
            seed: int = MH_SEED) -> torch.Tensor:
    """(R, T) uint32 tokens (held in int64) + (R, T) bool mask -> (R, M)
    MinHash values (uint32 held in int64); rows without a valid token,
    and every row when T == 0, give 0xFFFFFFFF.

    CUDA tensors (contiguous) launch the kernel; CPU tensors take the
    plain version.
    """
    if tokens.dim() != 2 or mask.shape != tokens.shape:
        raise ValueError(f"tokens {tuple(tokens.shape)} and mask "
                         f"{tuple(mask.shape)} are not equal (R, T) shapes")
    if tokens.device.type == "cpu":
        return minhash_torch(tokens, mask, num_hashes, seed)
    check_cuda("tokens", tokens, torch.int64)
    check_cuda("mask", mask, torch.bool)
    if num_hashes < 1:
        raise ValueError(f"num_hashes {num_hashes} is not positive")
    rows, width = tokens.shape
    out = torch.empty((rows, num_hashes), dtype=torch.int64,
                      device=tokens.device)
    if rows:
        # the kernel computes hash_addends(num_hashes, seed) itself
        KERNEL(ptr(tokens), ptr(mask), seed & u64.MASK64, ptr(out), rows,
               width, num_hashes)
    return out
