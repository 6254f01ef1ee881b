"""64-bit unsigned integers held as the bit pattern of one ``torch.int64``.

The JAX package keeps every u64 as a ``(hi, lo)`` uint32 limb pair because
TPUs have no 64-bit lanes. PyTorch has native int64 on both the CPU and
CUDA, and int64 ``+``, ``-`` and ``*`` wrap mod 2**64 exactly like u64
arithmetic. ``torch.uint64`` is not usable instead: it lacks ``+``, ``>>``,
``<`` and ``minimum``, and ``torch.uint32`` lacks ``+``.

Three hazards of the signed representation are handled here and nowhere
else:

- ``>>`` on int64 is arithmetic, so ``shr`` masks off the sign-extended
  bits (and ``rotl`` builds on it);
- unsigned order is signed order after flipping the sign bit, so every
  compare and sort goes through ``flip``;
- the all-ones sentinel is ``-1``: a signed compare would put it FIRST.

Converters move data between the JAX limb layout, numpy uint64 and
int64 tensors, so tests feed both packages the same bits.
"""
from __future__ import annotations

import numpy as np
import torch

MASK64 = (1 << 64) - 1
MASK32 = 0xFFFFFFFF
SIGN_BIT = -(1 << 63)       # int64 with only bit 63 set
SENTINEL = -1               # all-ones u64: sorts after every real key


def signed(value: int) -> int:
    """Python int (taken mod 2**64) -> the int64 with the same bits."""
    value &= MASK64
    return value - (1 << 64) if value >> 63 else value


def full(shape, value: int, device=None) -> torch.Tensor:
    return torch.full(shape, signed(value), dtype=torch.int64, device=device)


def from_u32(x: torch.Tensor) -> torch.Tensor:
    """Zero-extend 32-bit values (int32 bit patterns or int64) to u64."""
    return x.to(torch.int64) & MASK32


def hi32(x: torch.Tensor) -> torch.Tensor:
    return (x >> 32) & MASK32


def lo32(x: torch.Tensor) -> torch.Tensor:
    return x & MASK32


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """Low 32 bits as an int32 bit pattern (equality-preserving)."""
    low = x.to(torch.int64) & MASK32
    return (low - ((low >> 31) << 32)).to(torch.int32)


def shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift by a static 0 <= n < 64."""
    if n == 0:
        return x
    return (x >> n) & ((1 << (64 - n)) - 1)


def shl(x: torch.Tensor, n: int) -> torch.Tensor:
    """Left shift by a static 0 <= n < 64 (mod 2**64)."""
    if n == 0:
        return x
    # mask first so the shift never moves a set bit through the sign bit
    return (x & ((1 << (64 - n)) - 1)) << n


def rotl(x: torch.Tensor, n: int) -> torch.Tensor:
    n %= 64
    if n == 0:
        return x
    return shl(x, n) | shr(x, 64 - n)


def flip(x: torch.Tensor) -> torch.Tensor:
    """Map u64 order onto int64 order (an involution)."""
    return x ^ SIGN_BIT


def lt(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return flip(a) < flip(b)


def le(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return flip(a) <= flip(b)


def minimum(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.where(lt(a, b), a, b)


def is_sentinel(x: torch.Tensor) -> torch.Tensor:
    return x == SENTINEL


def sort(x: torch.Tensor, dim: int = -1, stable: bool = True):
    """Unsigned sort: returns (sorted values, indices)."""
    s, idx = torch.sort(flip(x), dim=dim, stable=stable)
    return flip(s), idx


def searchsorted(table: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Lower-bound positions of ``query`` in the u64-sorted ``table``."""
    return torch.searchsorted(flip(table), flip(query), side="left")


# ---------------------------------------------------------------------------
# converters (host numpy <-> int64 tensors)
# ---------------------------------------------------------------------------


def from_numpy_u64(arr: np.ndarray, device=None) -> torch.Tensor:
    """numpy uint64 -> int64 tensor with the same bits."""
    a = np.ascontiguousarray(np.asarray(arr, np.uint64)).view(np.int64)
    return torch.from_numpy(a.copy()).to(device)  # repro: noqa[R001] the converter's job


def to_numpy_u64(x: torch.Tensor) -> np.ndarray:
    """int64 tensor -> numpy uint64 with the same bits."""
    return x.detach().cpu().numpy().astype(np.int64).view(np.uint64)  # repro: noqa[R001] the converter's job


def from_limbs(limbs: np.ndarray, device=None) -> torch.Tensor:
    """JAX storage form: ``(..., 2)`` uint32 ``(hi, lo)`` -> int64 tensor."""
    limbs = np.asarray(limbs, np.uint32)
    w = (limbs[..., 0].astype(np.uint64) << np.uint64(32)) | limbs[..., 1].astype(np.uint64)
    return from_numpy_u64(w, device)


def to_limbs(x: torch.Tensor) -> np.ndarray:
    """int64 tensor -> JAX storage form ``(..., 2)`` uint32 ``(hi, lo)``."""
    w = to_numpy_u64(x)
    hi = (w >> np.uint64(32)).astype(np.uint32)
    lo = (w & np.uint64(MASK32)).astype(np.uint32)
    return np.stack([hi, lo], axis=-1)
