"""Parallel Meta-blocking baseline (paper §4.2 / §5, Efthymiou et al. [11]).

Port of the JAX package's ``core/metablocking.py``. Meta-blocking builds a
graph whose nodes are records and whose edges are record pairs that share
at least one block, weights the edges and prunes the weak ones:

  1. Block purging: discard blocks above a size cap.
  2. Block filtering: each record keeps only its ``filter_ratio``
     smallest blocks.
  3. Edge weighting: CBS (common blocks scheme) = number of shared blocks.
  4. Weighted Edge Pruning (WEP): keep edges with weight >= global mean.

Its cost is linear in the input comparison count (the paper's criticism
of it), so an explicit edge budget bounds it and raises beyond it, as PMB
fails outright on the paper's 50M+ datasets. Stages 1, 2 and 4 are host
numpy, as in the reference; stage 3's candidate edges are enumerated by
the port's pair engine (``pairs.enumerate_pairs``, the tri-decode kernel
on the card).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from . import pairs as pairs_lib
from . import u64
from .hdb import BlockingResult, IterationStats
from ..device import DeviceLike

# stage 3's enumeration engines (the reference's "jax" and "pallas" are
# one device path here: "auto")
PAIRS_BACKENDS = ("auto", "numpy")


class MetaBlockingBudgetError(RuntimeError):
    """Raised when the candidate-edge count exceeds the budget (the analog
    of PMB's OOM failures on the paper's large datasets)."""


@dataclasses.dataclass(frozen=True)
class MetaBlockingConfig:
    purge_block_size: int = 2_000      # stage 1
    filter_ratio: float = 0.8          # stage 2 (keep smallest 80% of a record's blocks)
    edge_budget: int = 60_000_000      # candidate edges (with multiplicity)
    min_block_size: int = 2
    pairs_backend: str = "auto"        # stage 3 enumeration engine

    def __post_init__(self):
        if self.pairs_backend not in PAIRS_BACKENDS:
            raise ValueError(f"pairs_backend must be one of {PAIRS_BACKENDS}, "
                             f"got {self.pairs_backend!r}")


def _blocks_from_keys(keys: torch.Tensor, valid: torch.Tensor):
    """(N, K) u64 keys + (N, K) valid -> flat (key64, rid) sorted by key."""
    valid_np = valid.cpu().numpy()
    n, k = valid_np.shape
    rid = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None], (n, k))[valid_np]
    key64 = u64.to_numpy_u64(keys)[valid_np]
    order = np.lexsort((rid, key64))
    return key64[order], rid[order]


def meta_blocking(keys: torch.Tensor, valid: torch.Tensor,
                  cfg: MetaBlockingConfig = MetaBlockingConfig(),
                  device: DeviceLike = None) -> Tuple[np.ndarray, np.ndarray]:
    """Pruned candidate pairs (a, b), a < b, from ``blocks.build_keys``'
    (N, K) keys; stage 3 runs on ``device`` (``None`` means CUDA)."""
    key64, rid = _blocks_from_keys(keys, valid)
    if len(key64) == 0:
        z = np.zeros((0,), np.int64)
        return z, z
    starts = np.flatnonzero(np.concatenate([[True], key64[1:] != key64[:-1]]))
    sizes = np.diff(np.concatenate([starts, [len(key64)]]))

    # --- stage 1: block purging ---
    keep_block = (sizes >= cfg.min_block_size) & (sizes <= cfg.purge_block_size)

    # --- stage 2: block filtering (keep each record's smallest blocks) ---
    block_id = np.repeat(np.arange(len(starts)), sizes)
    entry_keep = np.repeat(keep_block, sizes)
    ent_rid = rid[entry_keep]
    ent_block = block_id[entry_keep]
    ent_bsize = np.repeat(sizes, sizes)[entry_keep]
    # per record: sort by (rid, block size) and keep ceil(ratio * deg)
    order = np.lexsort((ent_bsize, ent_rid))
    ent_rid, ent_block, ent_bsize = ent_rid[order], ent_block[order], ent_bsize[order]
    r_starts = np.flatnonzero(np.concatenate([[True], ent_rid[1:] != ent_rid[:-1]]))
    r_sizes = np.diff(np.concatenate([r_starts, [len(ent_rid)]]))
    rank = np.arange(len(ent_rid)) - np.repeat(r_starts, r_sizes)
    keep_n = np.ceil(cfg.filter_ratio * r_sizes).astype(np.int64)
    entry_ok = rank < np.repeat(keep_n, r_sizes)
    ent_rid, ent_block = ent_rid[entry_ok], ent_block[entry_ok]

    # --- stage 3: candidate edges with CBS multiplicity ---
    order = np.lexsort((ent_rid, ent_block))
    b_sorted = ent_block[order]
    r_sorted = ent_rid[order]
    b_starts = np.flatnonzero(np.concatenate([[True], b_sorted[1:] != b_sorted[:-1]]))
    b_sizes = np.diff(np.concatenate([b_starts, [len(b_sorted)]]))
    total_edges = int(np.sum(b_sizes * (b_sizes - 1) // 2))
    if total_edges > cfg.edge_budget:
        raise MetaBlockingBudgetError(
            f"meta-blocking needs {total_edges:.3g} candidate edges "
            f"(> budget {cfg.edge_budget:.3g}); linear-in-comparisons cost "
            "is the paper's §4.2 criticism")
    edge_blocks = pairs_lib.Blocks(
        key_hi=np.zeros(len(b_starts), np.uint32),
        key_lo=np.zeros(len(b_starts), np.uint32),
        start=b_starts.astype(np.int64),
        size=b_sizes.astype(np.int64),
        members=r_sorted.astype(np.int64),
    )
    chunks = list(pairs_lib.enumerate_pairs(edge_blocks, backend=cfg.pairs_backend,
                                            device=device))
    if not chunks:
        z = np.zeros((0,), np.int64)
        return z, z
    ea = np.concatenate([c[0] for c in chunks])
    eb = np.concatenate([c[1] for c in chunks])
    lo, hi = np.minimum(ea, eb), np.maximum(ea, eb)
    # CBS weight = multiplicity of (lo, hi)
    order = np.lexsort((hi, lo))
    lo, hi = lo[order], hi[order]
    first = np.concatenate([[True], (lo[1:] != lo[:-1]) | (hi[1:] != hi[:-1])])
    e_starts = np.flatnonzero(first)
    weights = np.diff(np.concatenate([e_starts, [len(lo)]]))
    ulo, uhi = lo[e_starts], hi[e_starts]

    # --- stage 4: WEP (keep weight >= mean) ---
    keep = weights >= weights.mean()
    return ulo[keep], uhi[keep]


def meta_blocking_result(keys: torch.Tensor, valid: torch.Tensor,
                         cfg: MetaBlockingConfig = MetaBlockingConfig(),
                         device: DeviceLike = None) -> BlockingResult:
    """PMB's pairs as a BlockingResult (each pair a 2-block under its own
    synthetic key), so the shared metrics path applies."""
    a, b = meta_blocking(keys, valid, cfg, device)
    pair_id = np.arange(len(a), dtype=np.uint64)
    key_hi = (pair_id >> np.uint64(32)).astype(np.uint32) | np.uint32(0x80000000)
    key_lo = (pair_id & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    stats = IterationStats(
        iteration=0, n_live_keys=int(valid.sum()), n_right_cms=0,
        n_right_exact=2 * len(a), n_dropped_similarity=0, n_dropped_max_keys=0,
        n_duplicate_blocks=0, n_surviving_oversized=0, n_surviving_entries=0,
        rep_overflow=0)
    return BlockingResult(
        rids=np.concatenate([a, b]),
        key_hi=np.concatenate([key_hi, key_hi]),
        key_lo=np.concatenate([key_lo, key_lo]),
        stats=[stats],
        num_records=valid.shape[0],
    )
