"""Sort by u64 key + segmented reductions (HDB Alg. 4's exact counting).

Port of the JAX package's ``core/segments.py``. Keys are int64 u64 bit
patterns, sorted in unsigned order (``u64.sort``), so sentinel (``-1``)
entries sort to the tail. ``sort_by_key`` is not required to be stable:
compare only results that do not depend on order within a segment.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from . import u64


def sort_by_key(key: torch.Tensor, payloads: Sequence[torch.Tensor]
                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """Sort a flat u64 key array, carrying payloads along."""
    skey, order = u64.sort(key, stable=False)
    return skey, [p[order] for p in payloads]


def segment_starts(key: torch.Tensor) -> torch.Tensor:
    """Bool mask of the first element of each equal-key run (sorted input)."""
    starts = torch.ones_like(key, dtype=torch.bool)
    starts[1:] = key[1:] != key[:-1]
    return starts


def segment_ids(starts: torch.Tensor) -> torch.Tensor:
    """Monotone segment id per element from a start mask."""
    return torch.cumsum(starts.to(torch.int64), dim=0) - 1


def _start_positions(key: torch.Tensor):
    starts = segment_starts(key)
    seg = segment_ids(starts)
    first = torch.nonzero(starts).flatten()
    return seg, first


def segment_counts(key: torch.Tensor) -> torch.Tensor:
    """Per-ELEMENT size (int64) of the segment it belongs to."""
    n = key.shape[0]
    seg, first = _start_positions(key)
    ends = torch.cat([first[1:], first.new_tensor([n])])
    return (ends - first)[seg]


def _prefix_xor(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix XOR (Hillis-Steele doubling; torch has no cumxor)."""
    y = x
    k = 1
    while k < y.shape[0]:
        y = torch.cat([y[:k], y[k:] ^ y[:-k]])
        k *= 2
    return y


def segment_xor(key: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """Per-ELEMENT XOR of ``value`` over its segment (sorted input).

    Prefix-XOR trick: segment XOR over [s, e] = c[e] ^ c[s-1], c[-1] = 0.
    """
    n = key.shape[0]
    if n == 0:
        return value.clone()
    seg, first = _start_positions(key)
    last = torch.cat([first[1:], first.new_tensor([n])]) - 1
    c = _prefix_xor(value)
    before = torch.where(first > 0, c[(first - 1).clamp(min=0)], 0)
    return (c[last] ^ before)[seg]


def searchsorted_u64(table: torch.Tensor, query: torch.Tensor) -> torch.Tensor:
    """Lower-bound index of u64 queries in a u64-sorted table."""
    return u64.searchsorted(table, query)


def lookup_u64(table: torch.Tensor, values: torch.Tensor, query: torch.Tensor,
               default) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sorted-table lookup: returns (found_mask, value_or_default)."""
    n = table.shape[0]
    if n == 0:
        return (torch.zeros(query.shape, dtype=torch.bool, device=query.device),
                torch.full(query.shape, default, dtype=values.dtype,
                           device=query.device))
    idx = searchsorted_u64(table, query)
    idx_c = idx.clamp(0, n - 1)
    hit = (idx < n) & (table[idx_c] == query)
    val = torch.where(hit, values[idx_c], torch.full_like(values[idx_c], default))
    return hit, val
