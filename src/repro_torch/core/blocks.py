"""Top-level block building (paper §2): Identity / Token / LSH builders.

Port of the JAX package's ``core/blocks.py``. A column is a padded token
matrix ``(N, T)`` of uint32 values held in int64 plus a bool mask; keys
are u64 bit patterns in int64 (``core/u64.py``), sentinel ``-1``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from . import hashing, minhash, u64

_GAMMA_S = u64.signed(0x9E3779B97F4A7C15)


@dataclasses.dataclass(frozen=True)
class TokenColumn:
    """Padded token-hash matrix for one attribute."""

    tokens: torch.Tensor  # (N, T) int64, uint32 values
    mask: torch.Tensor    # (N, T) bool


@dataclasses.dataclass(frozen=True)
class ColumnBlocking:
    """How to build blocking keys for one column."""

    kind: str  # "identity" | "token" | "lsh"
    bands: int = 0
    rows_per_band: int = 0

    @staticmethod
    def identity() -> "ColumnBlocking":
        return ColumnBlocking("identity")

    @staticmethod
    def token() -> "ColumnBlocking":
        return ColumnBlocking("token")

    @staticmethod
    def lsh(bands: int, rows_per_band: int) -> "ColumnBlocking":
        return ColumnBlocking("lsh", bands=bands, rows_per_band=rows_per_band)

    def num_keys(self, column_width: int) -> int:
        if self.kind == "identity":
            return 1
        if self.kind == "token":
            return column_width
        if self.kind == "lsh":
            return self.bands
        raise ValueError(self.kind)


def identity_keys(col: TokenColumn, column_seed: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One key per record: sponge over the column's (ordered) tokens."""
    n, t = col.tokens.shape
    h = hashing.hash_u64(u64.full((n,), t, col.tokens.device),
                         seed=0x1DE0 + column_seed)
    for k in range(t):
        m = col.mask[:, k]
        tok = torch.where(m, u64.from_u32(col.tokens[:, k]), 0)
        # include the mask bit so "padding" differs from a real 0 token
        tok = tok + (m.to(torch.int64) << 31)
        h = hashing.mix64((h ^ tok) + _GAMMA_S)
    valid = col.mask.any(dim=1)
    return h[:, None], valid[:, None]


def token_keys(col: TokenColumn, _: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One key per token, shared across columns (schema-agnostic)."""
    return hashing.hash_u32(col.tokens, seed=0x70CE), col.mask


def build_keys(columns: Dict[str, TokenColumn],
               blocking: Dict[str, ColumnBlocking],
               max_width: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense per-record top-level key matrix.

    Returns ``keys`` (N, K) int64 u64 bit patterns (sentinel-padded; the
    JAX ``(N, K, 2)`` limb form is ``u64.to_limbs(keys)``) and ``valid``
    (N, K) bool. Columns are taken in sorted-name order.
    """
    all_keys, all_valid = [], []
    for seed, name in enumerate(sorted(columns)):
        col = columns[name]
        spec = blocking[name]
        if spec.kind == "identity":
            k, v = identity_keys(col, seed)
        elif spec.kind == "token":
            k, v = token_keys(col, seed)
        elif spec.kind == "lsh":
            k, v = minhash.lsh_keys(col.tokens, col.mask, spec.bands,
                                    spec.rows_per_band, column_seed=seed)
        else:
            raise ValueError(spec.kind)
        all_keys.append(k)
        all_valid.append(v)
    keys = torch.cat(all_keys, dim=1)
    valid = torch.cat(all_valid, dim=1)
    if max_width is not None and keys.shape[1] > max_width:
        keys, valid = keys[:, :max_width], valid[:, :max_width]
    return dedupe_row_keys(keys, valid)


def dedupe_row_keys(keys: torch.Tensor, valid: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-record set semantics: sort each row (invalid -> sentinel ->
    tail) and mask repeats. Row order is not meaningful afterwards."""
    keys = torch.where(valid, keys, u64.SENTINEL)
    keys, _ = u64.sort(keys, dim=1)
    same_as_prev = torch.zeros_like(valid)
    same_as_prev[:, 1:] = keys[:, 1:] == keys[:, :-1]
    return keys, ~same_as_prev & ~u64.is_sentinel(keys)
