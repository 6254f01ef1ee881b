"""Sorting u64 sort words (int64 bit patterns): the one dedupe sort.

- ``backend="radix"``: LSB radix sort, ``RADIX_BITS`` a pass. Each pass
  runs ``radix.radix_pass`` (the CUDA kernel on the card, its plain
  version on the CPU) for the in-tile ranks and tile histograms; the
  digit-major base scan and the scatter are plain PyTorch, as they were
  XLA in the reference.
- ``backend="comparator"``: one stable ``torch.sort`` in unsigned order.

The pass count is caller-bounded (``kernels.pairs.radix_passes_for``).
Sentinel safety under truncated passes: the sentinel's every digit is
0xF and a valid word never matches it across the low 16 size bits, so
sentinels sort strictly last whenever ``n_passes >= MIN_PASSES``.
"""
from __future__ import annotations

import torch

from ...core import u64
from .radix import MAX_PASSES, RADIX, RADIX_BITS, TILE, digit_of, radix_pass

SORT_BACKENDS = ("comparator", "radix")
# below this, sentinels can interleave with valid words (see module doc)
MIN_PASSES = 16 // RADIX_BITS


def _radix_sort(words: torch.Tensor, n_passes: int) -> torch.Tensor:
    n = words.shape[0]
    # pad lanes are sentinels, identical to real invalid words: the stable
    # sort keeps every sentinel at the tail, so the first n are the answer
    pad = (-n) % TILE
    w = torch.cat([words, words.new_full((pad,), u64.SENTINEL)])
    n_tiles = w.shape[0] // TILE
    tile = torch.arange(w.shape[0], device=w.device) // TILE
    for p in range(n_passes):
        rank, hist = radix_pass(w, p)
        flat = hist.t().reshape(-1)                     # digit-major
        base = (torch.cumsum(flat, 0) - flat).reshape(RADIX, n_tiles)
        pos = base[digit_of(w, p), tile] + rank
        out = torch.empty_like(w)
        out[pos] = w
        w = out
    return w[:n]


def sort_words(words: torch.Tensor, *, backend: str = "comparator",
               n_passes: int = MAX_PASSES) -> torch.Tensor:
    """Sort u64 words ascending (unsigned)."""
    if backend not in SORT_BACKENDS:
        raise ValueError(
            f"sort backend must be one of {SORT_BACKENDS}, got {backend!r}")
    if backend == "comparator":
        return u64.sort(words)[0]
    if not MIN_PASSES <= int(n_passes) <= MAX_PASSES:
        raise ValueError(f"n_passes {n_passes} outside "
                         f"[{MIN_PASSES}, {MAX_PASSES}]")
    if words.shape[0] == 0:
        return words
    return _radix_sort(words, int(n_passes))
