"""MinHash + LSH(b, w) banding (paper §2.1).

Same seeds and op order as the JAX package's ``core/minhash.py``. Token
hashes are uint32 values held in int64; MinHash values likewise. The
MinHash matrix is the minhash kernel (``kernels/minhash``) on a CUDA
tensor and its plain version on a CPU tensor.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..kernels.minhash import ops as minhash_ops
from ..kernels.minhash.minhash import MH_SEED as _MH_SEED
from . import hashing, u64

_GAMMA = 0x9E3779B97F4A7C15


def minhash_tokens(tokens: torch.Tensor, mask: torch.Tensor, num_hashes: int,
                   seed: int = _MH_SEED) -> torch.Tensor:
    """(R, T) uint32 tokens + bool mask -> (R, m) MinHash values.

    Each value is the min over valid tokens of
    ``lo32(mix64(token + (seed + 977*i + 1) * gamma))``; rows with no valid
    token get 0xFFFFFFFF. The minhash kernel on the card.
    """
    return minhash_ops.minhash(tokens.contiguous(), mask.contiguous(),
                               num_hashes, seed)


def band_keys(minhashes: torch.Tensor, bands: int, rows_per_band: int,
              column_seed: int = 0) -> torch.Tensor:
    """Hash each band of ``rows_per_band`` MinHashes into one u64 key."""
    r, m = minhashes.shape
    if m != bands * rows_per_band:
        raise ValueError(f"{m} minhashes != {bands} bands x {rows_per_band}")
    grouped = minhashes.reshape(r, bands, rows_per_band)
    h = hashing.hash_u64(u64.full((r, bands), 0, minhashes.device),
                         seed=0x15A4 + column_seed)
    gamma = u64.signed(_GAMMA)
    for k in range(rows_per_band):  # sponge over the band
        h = hashing.mix64((h ^ u64.from_u32(grouped[:, :, k])) + gamma)
    band_idx = torch.arange(bands, dtype=torch.int64, device=minhashes.device)
    return hashing.mix64(h ^ band_idx[None, :])


def lsh_keys(tokens: torch.Tensor, mask: torch.Tensor, bands: int,
             rows_per_band: int, column_seed: int = 0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LSH blocking keys + validity for a padded token-set column.

    Rows with zero valid tokens emit no keys (valid=False).
    """
    mh = minhash_tokens(tokens, mask, bands * rows_per_band)
    keys = band_keys(mh, bands, rows_per_band, column_seed)
    valid = mask.any(dim=1, keepdim=True).expand(keys.shape)
    return keys, valid


def _integer_pow(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x ** n`` for an int ``n >= 0`` by binary exponentiation: the
    float32 products, in order, of XLA's ``integer_pow``."""
    acc = None
    while n > 0:
        if n & 1:
            acc = x if acc is None else acc * x
        n >>= 1
        if n > 0:
            x = x * x
    return torch.ones_like(x) if acc is None else acc


def lsh_probability(bands: int, rows_per_band: int, jaccard,
                    device: DeviceLike = None) -> torch.Tensor:
    """Analytic LSH(b, w, j) = 1 - (1 - j^w)^b (paper Fig. 1a), float32,
    bit-equal to the reference; on ``jaccard``'s device if it is a
    tensor, else on ``device``."""
    if not isinstance(jaccard, torch.Tensor):
        jaccard = torch.as_tensor(jaccard, device=resolve_device(device))
    j = jaccard.to(torch.float32)
    return 1.0 - _integer_pow(1.0 - _integer_pow(j, rows_per_band), bands)
