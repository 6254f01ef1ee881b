"""splitmix64 hash mixing on int64 bit patterns (see ``core/u64.py``).

Same functions, seeds and constants as the JAX package's
``core/hashing.py``; the numpy mirrors below are this package's own copy
(host-side tokenization and test oracles). ``mix64`` runs the hash64
mix kernel on a CUDA tensor and its plain version on a CPU tensor.
"""
from __future__ import annotations

import numpy as np
import torch

from ..kernels.hash64 import ops as hash64_ops
from ..kernels.hash64.hash64 import GAMMA as _GAMMA, M1 as _M1, M2 as _M2
from . import u64

_GAMMA_S = u64.signed(_GAMMA)


def mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64 finalizer: full-avalanche bijective mixer on u64.

    Callers pass views (``grouped[:, :, k]``); the kernel takes them
    contiguous.
    """
    return hash64_ops.mix64_bulk(x.contiguous())


def hash_u64(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Seeded hash of a u64 value: mix(x + (seed+1)*gamma)."""
    return mix64(x + u64.signed((seed + 1) * _GAMMA))


def hash_u32(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """Seeded 64-bit hash of 32-bit values."""
    return hash_u64(u64.from_u32(x), seed)


def combine(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Order-sensitive combine of two keys (HDB Alg. 2 line 7).

    Callers canonicalize the order (a < b unsigned).
    """
    h = mix64(a) ^ u64.rotl(b, 29)
    return mix64(h + _GAMMA_S)


def fingerprint_rid(rid: torch.Tensor) -> torch.Tensor:
    """64-bit membership fingerprint of a record id (XOR-accumulated)."""
    return hash_u32(rid, seed=0xB10C)


# ---------------------------------------------------------------------------
# numpy mirror (host-side tokenization / test oracles)
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def np_mix64_vec(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer on a uint64 array."""
    x = x.astype(np.uint64)
    x = x ^ (x >> np.uint64(30))
    x = (x * np.uint64(_M1)) & np.uint64(_MASK64)
    x = x ^ (x >> np.uint64(27))
    x = (x * np.uint64(_M2)) & np.uint64(_MASK64)
    x = x ^ (x >> np.uint64(31))
    return x


def np_hash_u64_vec(x: np.ndarray, seed: int = 0) -> np.ndarray:
    """Vectorized seeded hash of a uint64 array (mirrors hash_u64)."""
    gamma = ((seed + 1) * _GAMMA) & _MASK64
    return np_mix64_vec(x.astype(np.uint64) + np.uint64(gamma))


def np_fingerprint_rid(rid: np.ndarray) -> np.ndarray:
    """Vectorized uint64 mirror of fingerprint_rid (same 0xB10C seed)."""
    rid32 = rid.astype(np.uint32).astype(np.uint64)
    return np_hash_u64_vec(rid32, seed=0xB10C)


def np_mix64(x: int) -> int:
    x &= _MASK64
    x ^= x >> 30
    x = (x * _M1) & _MASK64
    x ^= x >> 27
    x = (x * _M2) & _MASK64
    x ^= x >> 31
    return x


def np_hash_u64(x: int, seed: int = 0) -> int:
    return np_mix64((x + (seed + 1) * _GAMMA) & _MASK64)


def np_rotl64(x: int, n: int) -> int:
    x &= _MASK64
    return ((x << n) | (x >> (64 - n))) & _MASK64


def np_combine(a: int, b: int) -> int:
    """Python mirror of combine() (canonical order is the caller's job)."""
    h = (np_mix64(a) ^ np_rotl64(b, 29)) & _MASK64
    h = (h + _GAMMA) & _MASK64
    return np_mix64(h)
