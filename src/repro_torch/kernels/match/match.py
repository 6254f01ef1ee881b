"""Fused pair matching: the CUDA kernel's wrapper and plain version.

The kernel (``csrc/match.cu``) replaces the TPU kernel
``match_score_pallas`` (``src/repro/kernels/match/match.py:83``): per
candidate pair the weighted per-column Jaccard score, ``valid & score >=
threshold``, the exclusive rank among the matched pairs of its 128-pair
tile, and each tile's matched count. One call packs every record into a
16-byte-aligned row (tokens plus a 64-bit valid-slot bitmask), stages
each tile's 2 x 128 rows in shared memory and compares from there, with a
column's a-slots in registers. The float32 op order is that of
``score_lanes``, with no FMA contraction, so the kernel and the plain
version agree bit for bit.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .._build import Kernel, check_cuda, ptr

LANES = 128
# token slots a record: the packed row keeps their valid bits in 64
MAX_SLOTS = 64

KERNEL = Kernel(
    "match", "match.cu", "match_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
     ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_longlong])


def packed_stride(t_total: int) -> int:
    """int32 words of a packed record row: the tokens and two mask words,
    rounded up to 16 bytes."""
    return -(-(t_total + 2) // 4) * 4


def pair_jaccard(tok: torch.Tensor, mask: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(jaccard f32, present) of padded token sets for pairs (a, b)."""
    ta, ma = tok[a], mask[a]
    tb, mb = tok[b], mask[b]
    eq = (ta[:, :, None] == tb[:, None, :]) & ma[:, :, None] & mb[:, None, :]
    inter = eq.any(dim=2).sum(dim=1)
    na = ma.sum(dim=1)
    nb = mb.sum(dim=1)
    union = na + nb - inter
    both = (na > 0) & (nb > 0)
    jac = inter.to(torch.float32) / union.clamp(min=1).to(torch.float32)
    return torch.where(both, jac, torch.zeros_like(jac)), both


def score_lanes(tokens: Sequence[torch.Tensor], masks: Sequence[torch.Tensor],
                weights: Sequence[float], a: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Weighted multi-column score in float32.

    The op sequence (f32 true divide, ``total + w * jac`` in weight order,
    ``total / max(norm, 1e-6)``) defines the bit-exact contract shared
    with the reference and the CUDA kernel. Scalars are float32 tensors
    so no step runs in another precision.
    """
    dev = a.device
    total = torch.zeros(a.shape, dtype=torch.float32, device=dev)
    norm = torch.zeros(a.shape, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for tok, mask, w in zip(tokens, masks, weights):
        j, present = pair_jaccard(tok, mask, a, b)
        w32 = torch.tensor(w, dtype=torch.float32, device=dev)  # repro: noqa[R001] plain version, the CPU path
        total = total + w32 * j
        norm = norm + torch.where(present, w32, zero)
    eps = torch.tensor(1e-6, dtype=torch.float32, device=dev)  # repro: noqa[R001] plain version, the CPU path
    return torch.where(norm > 0, total / torch.maximum(norm, eps), zero)


def match_tiles_torch(tok: torch.Tensor, msk: torch.Tensor,
                      col_off: Sequence[int], weights: Sequence[float],
                      aa: torch.Tensor, bb: torch.Tensor, valid: torch.Tensor,
                      threshold: float
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version: ``score_lanes`` over the column slices."""
    cols = range(len(weights))
    tokens = [tok[:, col_off[c]:col_off[c + 1]] for c in cols]
    masks = [msk[:, col_off[c]:col_off[c + 1]].bool() for c in cols]
    score = score_lanes(tokens, masks, weights, aa.long(), bb.long())
    thr = torch.tensor(threshold, dtype=torch.float32, device=score.device)  # repro: noqa[R001] plain version, the CPU path
    m = (valid.bool() & (score >= thr)).to(torch.int32).reshape(-1, LANES)
    rank = torch.cumsum(m, dim=1, dtype=torch.int32) - m
    return m.reshape(-1), rank.reshape(-1), m.sum(dim=1, dtype=torch.int32)


def match_tiles(tok: torch.Tensor, msk: torch.Tensor, col_off: Sequence[int],
                weights: Sequence[float], aa: torch.Tensor, bb: torch.Tensor,
                valid: torch.Tensor, threshold: float
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Score + threshold + in-tile rank for a padded pair list.

    ``tok`` (N, T_total) int32 token bits and ``msk`` (N, T_total) uint8,
    column ``c`` in ``[col_off[c], col_off[c+1])``; ``aa``/``bb`` int32
    record ids and ``valid`` uint8 over a multiple of 128 lanes. Returns
    int32 ``(matched, rank, counts)``, counts one per 128-lane tile.
    CUDA tensors launch the kernel; CPU tensors take the plain version.
    """
    if aa.numel() % LANES:
        raise ValueError(f"{aa.numel()} lanes is not a multiple of {LANES}")
    if len(col_off) != len(weights) + 1:
        raise ValueError("col_off needs one more entry than weights")
    if tok.device.type == "cpu":
        return match_tiles_torch(tok, msk, col_off, weights, aa, bb, valid,
                                 threshold)
    for name, t, dtype in (("tok", tok, torch.int32), ("msk", msk, torch.uint8),
                           ("aa", aa, torch.int32), ("bb", bb, torch.int32),
                           ("valid", valid, torch.uint8)):
        check_cuda(name, t, dtype)
    if tok.shape != msk.shape or tok.shape[1] != col_off[-1]:
        raise ValueError(f"tok {tuple(tok.shape)} / msk {tuple(msk.shape)} do "
                         f"not match {col_off[-1]} token columns")
    if tok.shape[1] > MAX_SLOTS:
        raise ValueError(f"{tok.shape[1]} token slots exceed {MAX_SLOTS}")
    if not aa.shape == bb.shape == valid.shape:
        raise ValueError("aa, bb and valid must have one shape")
    dev = tok.device
    off_d = torch.tensor(list(col_off), dtype=torch.int32, device=dev)  # repro: noqa[R001] column offsets, one upload
    w_d = torch.tensor(list(weights), dtype=torch.float32, device=dev)  # repro: noqa[R001] column weights, one upload
    n = aa.numel()
    matched = torch.empty(n, dtype=torch.int32, device=dev)
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.empty(n // LANES, dtype=torch.int32, device=dev)
    t_total = tok.shape[1]
    stride = packed_stride(t_total)
    rows = torch.empty((tok.shape[0], stride), dtype=torch.int32, device=dev)
    KERNEL(ptr(tok), ptr(msk), t_total, tok.shape[0], ptr(rows), stride,
           ptr(off_d), ptr(w_d), len(weights), ptr(aa), ptr(bb), ptr(valid),
           ctypes.c_float(threshold), ptr(matched), ptr(rank), ptr(counts),
           n // LANES)
    return matched, rank, counts
