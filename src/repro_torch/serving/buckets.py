"""Padded-bucket batching: a power-of-two shape ladder for probe batches.

Port of the JAX package's ``serving/buckets.py``. Every shape the query
walk sees is a distinct device program there (a jit compile) and here a
distinct set of kernel launch shapes and allocator block sizes; raw
collated batch sizes would make that set unbounded under mixed traffic.
Padding every batch up to the next ladder rung bounds it at
O(log max_batch), and the walk is row-local (every per-row decision in
``rough_classify`` / ``intersect_keys`` / the probe survivor dedupe
depends only on that row), so sentinel-key, all-invalid padding rows
cannot change a real row's result.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from ..streaming.delta import host_bool, host_u64
from ..streaming.store import SENTINEL_U64


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """Power-of-two batch-row buckets starting at ``min_bucket``."""

    min_bucket: int = 8

    def bucket(self, n: int) -> int:
        """Smallest rung >= max(n, min_bucket)."""
        p = max(int(self.min_bucket), 1)
        while p < n:
            p *= 2
        return p

    def rungs(self, max_rows: int) -> List[int]:
        """Every rung the ladder can emit for batches up to ``max_rows``."""
        out = [self.bucket(0)]
        while out[-1] < max_rows:
            out.append(out[-1] * 2)
        return out


def pad_probe_rows(keys, valid, rows: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad an (q, K) u64 probe key matrix to ``rows`` rows.

    ``keys`` is what ``blocks.build_keys`` gives (an int64 tensor of u64
    bit patterns) or a numpy uint64/int64 array; the result is numpy
    uint64. Padding rows are all-sentinel keys with ``valid=False``, the
    dead-row encoding of ``blocks.dedupe_row_keys`` and the DeltaBlocker,
    so they match nothing and survive nothing in the walk.
    """
    keys = host_u64(keys)
    valid = host_bool(valid)
    q, k = valid.shape
    if rows < q:
        raise ValueError(f"bucket {rows} smaller than batch {q}")
    if rows == q:
        return keys, valid
    out_k = np.full((rows, k), SENTINEL_U64, np.uint64)
    out_v = np.zeros((rows, k), bool)
    out_k[:q] = keys
    out_v[:q] = valid
    return out_k, out_v
