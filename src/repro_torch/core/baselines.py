"""Blocking baselines from the paper's §5 evaluation.

Port of the JAX package's ``core/baselines.py``:

- Threshold Blocking (THR): block on the same top-level keys, but discard
  any block larger than the threshold. One exact count, no iterations.
- Naive blocking: keep every block regardless of size; only its pair
  count is reported (the paper's Table 3 "Naive" column).
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from . import segments, u64
from .hdb import BlockingResult, IterationStats


def _exact_sizes(keys: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Exact per-entry block sizes (int32, 0 on invalid entries) via one
    sort of the (N*K,) keys, invalid entries as the sentinel."""
    n, k = valid.shape
    flat = torch.where(valid.reshape(-1), keys.reshape(-1), u64.SENTINEL)
    orig = torch.arange(n * k, device=keys.device)
    skey, (sorig,) = segments.sort_by_key(flat, [orig])
    live = ~u64.is_sentinel(skey)
    sizes = torch.where(live, segments.segment_counts(skey), 0)
    out = torch.zeros(n * k, dtype=torch.int32, device=keys.device)
    out[sorig] = sizes.to(torch.int32)
    return out.reshape(n, k)


def threshold_blocking(keys: torch.Tensor, valid: torch.Tensor,
                       max_block_size: int = 500,
                       device: DeviceLike = None) -> BlockingResult:
    """THR baseline: accept blocks with 2 <= size <= max_block_size.

    ``keys`` (N, K) int64 u64 keys and ``valid`` (N, K) bool from
    ``blocks.build_keys``; ``device=None`` means CUDA. Accepted entries
    come in row-major order, as ``np.nonzero`` gives them.
    """
    dev = resolve_device(device)
    keys, valid = keys.to(dev), valid.to(dev)
    sizes = _exact_sizes(keys, valid)
    accepted = valid & (sizes <= max_block_size) & (sizes >= 2)
    ridx, kidx = torch.nonzero(accepted, as_tuple=True)  # repro: noqa[R001] accepted entries to the host BlockingResult
    key64 = u64.to_numpy_u64(keys[ridx, kidx])
    stats = IterationStats(
        iteration=0, n_live_keys=int(valid.sum()), n_right_cms=0,  # repro: noqa[R001] IterationStats fields are host ints
        n_right_exact=ridx.shape[0], n_dropped_similarity=0,
        n_dropped_max_keys=0, n_duplicate_blocks=0, n_surviving_oversized=0,
        n_surviving_entries=0, rep_overflow=0)
    return BlockingResult(
        rids=ridx.cpu().numpy().astype(np.int64),  # repro: noqa[R001] BlockingResult is host numpy
        key_hi=(key64 >> np.uint64(32)).astype(np.uint32),
        key_lo=(key64 & np.uint64(u64.MASK32)).astype(np.uint32),
        stats=[stats],
        num_records=valid.shape[0],
    )


def naive_pair_count(keys: torch.Tensor, valid: torch.Tensor,
                     device: DeviceLike = None) -> int:
    """Sum of C(n, 2) over ALL top-level blocks (paper Table 3 "Naive")."""
    dev = resolve_device(device)
    skey, _ = segments.sort_by_key(keys.to(dev)[valid.to(dev)], [])
    first = segments.segment_starts(skey) & ~u64.is_sentinel(skey)
    size = segments.segment_counts(skey)[first]
    return int((size * (size - 1) // 2).sum())
