"""One LSB radix digit pass: the CUDA kernel's wrapper and plain version.

The kernel (``csrc/radix_pass.cu``) replaces the TPU kernel
``radix_pass_pallas`` (``src/repro/kernels/sort/sort.py:71``): for 4-bit
digit ``p`` of each u64 word (int64 bit pattern), the stable rank among
same-digit words earlier in its 1024-word tile, and each tile's 16-bin
histogram. It is memory-bound on the H100 (12 bytes a word); the stable
rank comes from warp match masks and ``__popc``, never from atomics.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .._build import Kernel, check_cuda, ptr

RADIX_BITS = 4
RADIX = 1 << RADIX_BITS
MAX_PASSES = 64 // RADIX_BITS
# words a tile: the TPU kernel's (8, 128) tile flattened row-major
TILE = 1024

KERNEL = Kernel("radix_pass", "radix_pass.cu", "radix_pass_launch",
                [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int])


def digit_of(words: torch.Tensor, p: int) -> torch.Tensor:
    """Digit ``p`` (little-endian) of each u64 word, as int64 in [0, 16).

    The mask after the arithmetic shift keeps exactly the digit's four
    bits, so the sentinel ``-1`` gives 0xF in every digit.
    """
    return (words >> (p * RADIX_BITS)) & (RADIX - 1)


def radix_pass_torch(words: torch.Tensor, p: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: per-tile one-hot cumsum."""
    d = digit_of(words, p).reshape(-1, TILE)
    incl = torch.nn.functional.one_hot(d, RADIX).cumsum(dim=1)
    rank = incl.gather(2, d.unsqueeze(2)).squeeze(2) - 1
    return rank.reshape(-1).to(torch.int32), incl[:, -1, :].to(torch.int32)


def radix_pass(words: torch.Tensor, p: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(n_tiles * 1024,) int64 words -> (rank int32, hist (n_tiles, 16) int32).

    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if words.numel() % TILE:
        raise ValueError(f"{words.numel()} words is not a multiple of {TILE}")
    if not 0 <= p < MAX_PASSES:
        raise ValueError(f"digit {p} outside [0, {MAX_PASSES})")
    if words.device.type == "cpu":
        return radix_pass_torch(words, p)
    check_cuda("words", words, torch.int64)
    n_tiles = words.numel() // TILE
    rank = torch.empty(words.shape, dtype=torch.int32, device=words.device)
    hist = torch.empty((n_tiles, RADIX), dtype=torch.int32, device=words.device)
    KERNEL(ptr(words), ptr(rank), ptr(hist), n_tiles, p * RADIX_BITS)
    return rank, hist
