"""Fused match drivers: plain scoring, chunk gather, device compaction.

Port of the JAX package's ``kernels/match/ops.py``:

- ``pair_jaccard`` / ``score_lanes``: the single-source scoring math; the
  host matcher (``data/matcher.py``) and the kernel's plain version both
  call it, and the CUDA kernel follows its float32 op order.
- ``fused_match_pairs``: gathers each pair lane (clamped), runs
  ``match.match_tiles`` (score + threshold + in-tile rank), then ONE
  prefix-sum scatter (``compact_matched``) into the packed matched-pair
  buffer, whose tail is (0, 0) no-op edges.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .match import LANES as _LANES
from .match import match_tiles, pair_jaccard, score_lanes  # noqa: F401


def _round_up(x: int, q: int) -> int:
    return ((x + q - 1) // q) * q


def compact_matched(aa: torch.Tensor, bb: torch.Tensor, matched: torch.Tensor,
                    rank: torch.Tensor, counts: torch.Tensor):
    """Prefix-sum scatter of the matched lanes into a packed pair buffer.

    ``base[tile] + rank`` is each matched lane's slot; unmatched lanes aim
    at the dump slot ``n`` of an (n+1)-long zero buffer that is cropped
    back to ``n``, so the tail beyond ``count`` stays (0, 0).
    """
    n = aa.shape[0]
    counts = counts.to(torch.int64)
    base = torch.cumsum(counts, 0) - counts
    tile = torch.arange(n, device=aa.device) // _LANES
    pos = torch.where(matched.bool(), base[tile] + rank, n)
    ca = torch.zeros(n + 1, dtype=torch.int32, device=aa.device)
    cb = torch.zeros(n + 1, dtype=torch.int32, device=aa.device)
    ca[pos] = aa
    cb[pos] = bb
    return ca[:n], cb[:n], counts.sum().to(torch.int32)


def _match_chunk(tok, msk, col_off, weights, a, b, length: int, threshold: float):
    """Score ``length`` lanes of the pair list (lanes past its end repeat a
    clamped in-range pair and are forced unmatched through ``valid``).
    Returns per-lane ``(aa, bb, matched, rank)`` and per-tile ``counts``."""
    n = a.shape[0]
    offsets = torch.arange(length, device=a.device)
    idx = offsets.clamp(max=n - 1)
    aa = a[idx].to(torch.int32)
    bb = b[idx].to(torch.int32)
    valid = (offsets < n).to(torch.uint8)
    matched, rank, counts = match_tiles(tok, msk, col_off, weights, aa, bb,
                                        valid, threshold)
    return aa, bb, matched, rank, counts


def fused_match_pairs(tok: torch.Tensor, msk: torch.Tensor,
                      col_off: Sequence[int], weights: Sequence[float],
                      a: torch.Tensor, b: torch.Tensor, *, threshold: float):
    """Fused match over a device pair list -> compacted device buffers.

    ``tok``/``msk`` are the concatenated int32/uint8 token matrices (see
    ``match.match_tiles``). One launch scores the whole list, padded to a
    whole 128-lane tile. Returns ``(ca, cb, count)``: the first ``count``
    lanes are the matched pairs in candidate order, the tail is zeros.
    """
    n = int(a.shape[0])
    dev = a.device
    if n == 0:
        z = torch.zeros(0, dtype=torch.int32, device=dev)
        return z, z, torch.zeros((), dtype=torch.int32, device=dev)
    parts = _match_chunk(tok, msk, col_off, weights, a, b, _round_up(n, _LANES),
                         threshold)
    return compact_matched(*parts)


def packed_host(ca: torch.Tensor, cb: torch.Tensor, count: int) -> np.ndarray:
    """Host uint64 ledger words ``a<<32|b`` from compacted device limbs."""
    hi = ca[:count].cpu().numpy().astype(np.uint64)  # repro: noqa[R001] packed_host's job
    lo = cb[:count].cpu().numpy().astype(np.uint64)  # repro: noqa[R001] packed_host's job
    return (hi << np.uint64(32)) | lo
