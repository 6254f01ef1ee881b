"""Host numpy helpers of the pair engine (this package's own copy).

The canonical pair-slot enumeration: blocks in CSR order, and within a
block of size ``n`` the strictly-upper-triangular pairs in row-major
order, so local slot ``t`` maps to ``(i, j)`` with
``cum(i) = i*(n-1) - i*(i-1)/2 <= t`` maximal and ``j = t - cum(i) + i + 1``.
The decoder here is a float64 closed form with an integer fix-up, a
different algorithm from the device binary search.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def cum_pair_counts(size: np.ndarray) -> np.ndarray:
    """Exclusive prefix sum of per-block C(n, 2), length B+1, int64."""
    size = np.asarray(size, np.int64)
    per = size * (size - 1) // 2
    return np.concatenate([[0], np.cumsum(per)])


def tri_decode_ref(local: np.ndarray, n: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Local triangular slot index -> (i, j), i < j < n. Vectorized."""
    t = np.asarray(local, np.int64)
    n = np.asarray(n, np.int64)
    m = 2 * n - 1
    disc = np.maximum(m * m - 8 * t, 0).astype(np.float64)
    i = ((m - np.sqrt(disc)) // 2).astype(np.int64)
    i = np.clip(i, 0, np.maximum(n - 2, 0))

    def cum(r):
        return r * (n - 1) - r * (r - 1) // 2

    for _ in range(2):  # fix-up: float sqrt can be off by at most 1 per pass
        i = np.where((i + 1 <= n - 2) & (cum(i + 1) <= t), i + 1, i)
        i = np.where((i > 0) & (cum(i) > t), i - 1, i)
    j = t - cum(i) + i + 1
    return i, j


def decode_slots_ref(start: np.ndarray, size: np.ndarray, members: np.ndarray,
                     slots: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Global pair-slot indices -> (a, b, block_size), a < b."""
    start = np.asarray(start, np.int64)
    size = np.asarray(size, np.int64)
    slots = np.asarray(slots, np.int64)
    cum = cum_pair_counts(size)
    block = np.searchsorted(cum, slots, side="right") - 1
    local = slots - cum[block]
    n = size[block]
    i, j = tri_decode_ref(local, n)
    a = members[start[block] + i]
    b = members[start[block] + j]
    return np.minimum(a, b), np.maximum(a, b), n


def dedupe_ref(a: np.ndarray, b: np.ndarray, src_size: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Distinct (a, b) sorted ascending, keeping the LARGEST source block."""
    if len(a) == 0:
        z = np.zeros((0,), np.int64)
        return z, z, z
    a = np.asarray(a, np.int64)
    b = np.asarray(b, np.int64)
    s = np.asarray(src_size, np.int64)
    order = np.lexsort((-s, b, a))
    a, b, s = a[order], b[order], s[order]
    first = np.concatenate([[True], (a[1:] != a[:-1]) | (b[1:] != b[:-1])])
    return a[first], b[first], s[first]
