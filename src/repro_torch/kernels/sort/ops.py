"""Sorting u64 sort words (int64 bit patterns): the one dedupe sort.

- ``backend="radix"``: LSB radix sort over 8-bit digits. One
  ``radix.digit_counts`` gives every pass its digit totals, then each
  pass is one ``radix.sort_pass`` (the CUDA kernels on the card, their
  plain versions on the CPU).
- ``backend="comparator"``: one stable ``torch.sort`` in unsigned order.

The pass count is caller-bounded (``kernels.pairs.radix_passes_for``) and
counts 4-bit digits, as in the reference: the sort covers the low
``4 * n_passes`` bits. Sentinel safety under truncated passes: the
sentinel's every digit is all ones and a valid word never matches it
across the low 16 size bits, so sentinels sort strictly last whenever
``n_passes >= MIN_PASSES``.
"""
from __future__ import annotations

import torch

from ...core import u64
from .radix import MAX_PASSES, RADIX_BITS, digit_bits, digit_counts, sort_pass

SORT_BACKENDS = ("comparator", "radix")
# below this, sentinels can interleave with valid words (see module doc)
MIN_PASSES = 16 // RADIX_BITS


def _radix_sort(words: torch.Tensor, n_passes: int) -> torch.Tensor:
    bits = digit_bits(n_passes)
    totals = digit_counts(words, len(bits), bits[-1])
    w = words
    for q, b in enumerate(bits):
        # each pass allocates its output; the caching allocator hands the
        # buffer of two passes back to the next, so two buffers ping-pong
        w = sort_pass(w, q, b, totals[q])
    return w


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
