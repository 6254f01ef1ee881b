"""Hashed Dynamic Blocking — Algorithms 1–4 of the paper, in PyTorch.

Port of the JAX package's ``core/hdb.py``. The iteration state is the
dense per-record key matrix ``(N, K)`` of int64 u64 bit patterns (see
``core/u64.py``); each host-level iteration runs

  1. ROUGH OVER-SIZE DETECTION (Alg. 3): a Count-Min Sketch over all live
     (record, key) entries gives approximate block sizes;
  2. EXACTLY COUNT AND DEDUPE (Alg. 4): a sort of the surviving entries
     by key gives exact sizes and XOR-of-fingerprint membership hashes;
     over-sized blocks with equal (membership, size) are duplicates and
     the smallest key survives;
  3. INTERSECT KEYS (Alg. 2): each record combines pairs of its
     ``max_oversize_keys`` smallest surviving over-sized keys.

Where JAX needs fixed shapes, this port compacts instead (the entries the
CMS kept, the ``rep_capacity`` representatives actually present); the
padding lanes it drops are inert in the reference, so results are equal.
Multi-key sorts are chains of stable single-key sorts, least significant
key first.
"""
from __future__ import annotations

import dataclasses
import logging
import warnings
from typing import List

import numpy as np
import torch
from torch.profiler import record_function

from . import hashing, segments, sketches, u64
from ..device import DeviceLike, resolve_device
from ..kernels.hash64 import ops as hash64_ops

INT32_MAX = 2**31 - 1
logger = logging.getLogger(__name__)


class RepCapacityWarning(RuntimeWarning):
    """Fixed-capacity representative buffers overflowed; some blocks were
    dropped. Raise the relevant capacity config."""


@dataclasses.dataclass(frozen=True)
class HDBConfig:
    """Hyper-parameters (paper §5 defaults)."""

    max_block_size: int = 500
    max_keys: int = 80            # Alg. 2 line 2: per-record key cap
    max_similarity: float = 0.9   # progress heuristic (Alg. 3 line 11)
    max_oversize_keys: int = 16   # keys carried into intersection
    max_iterations: int = 8
    cms_depth: int = 4
    cms_width: int = 1 << 20
    rep_capacity: int = 1 << 20   # capacity for over-sized block representatives

    @property
    def cms(self) -> sketches.CMSConfig:
        return sketches.CMSConfig(self.cms_depth, self.cms_width)

    @property
    def intersect_width(self) -> int:
        ko = self.max_oversize_keys
        return ko * (ko - 1) // 2


@dataclasses.dataclass
class IterationStats:
    iteration: int
    n_live_keys: int
    n_right_cms: int        # accepted by CMS bound
    n_right_exact: int      # recovered from CMS over-count
    n_dropped_similarity: int
    n_dropped_max_keys: int
    n_duplicate_blocks: int
    n_surviving_oversized: int  # unique over-sized blocks after dedupe
    n_surviving_entries: int
    rep_overflow: int


@dataclasses.dataclass
class BlockingResult:
    """Accepted (record, key) assignments across all iterations (host)."""

    rids: np.ndarray        # (M,) int64 record ids
    key_hi: np.ndarray      # (M,) uint32
    key_lo: np.ndarray      # (M,) uint32
    stats: List[IterationStats]
    num_records: int

    @property
    def rep_overflow_total(self) -> int:
        """Representatives dropped by ``rep_capacity``, over all iterations."""
        return sum(st.rep_overflow for st in self.stats)


def _f32(value: float, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def rough_classify(cfg: HDBConfig, s: torch.Tensor, valid: torch.Tensor,
                   psize: torch.Tensor):
    """Algorithm 3 decision rule, given CMS estimates ``s``.

    The progress comparison is float32, as in the reference.
    Returns (right_mask, keep_mask, dropped_similarity_mask).
    """
    right = valid & (s <= cfg.max_block_size)
    progress = (s.to(torch.float32)
                <= _f32(cfg.max_similarity, s.device) * psize.to(torch.float32))
    keep = valid & ~right & progress
    dropped_sim = valid & ~right & ~progress
    return right, keep, dropped_sim


def rough_oversize_detection(cfg: HDBConfig, key: torch.Tensor,
                             valid: torch.Tensor, psize: torch.Tensor):
    """Algorithm 3. Returns (right_mask, keep_mask, dropped_mask, approx_counts)."""
    # one hash chain per iteration: the build and the query share indices
    idx = sketches.cms_indices(cfg.cms, key.reshape(-1))
    cms = sketches.cms_build_indices(cfg.cms, idx, valid.reshape(-1))
    s = sketches.cms_query_indices(cms, idx).reshape(valid.shape)
    right, keep, dropped_sim = rough_classify(cfg, s, valid, psize)
    return right, keep, dropped_sim, s


def dedupe_oversized_reps(r_x: torch.Tensor, r_sz: torch.Tensor,
                          r_k: torch.Tensor):
    """Deduplicate over-sized block representatives (Alg. 4 lines 6-9).

    One representative per over-sized block: membership fingerprint
    ``r_x``, exact size ``r_sz`` and block key ``r_k``; sentinel keys mark
    invalid lanes. Blocks with equal (fingerprint, size) are duplicates
    and the smallest key of each group survives. Returns
    ``((t_k, t_sz), n_dup, survivor_in)`` with the survivor table sorted
    by key and ``survivor_in`` aligned with the input lanes.
    """
    # 5-key lexicographic sort (x, size, key) as stable sorts, least
    # significant key first
    order = u64.sort(r_k)[1]
    order = order[torch.sort(r_sz[order], stable=True)[1]]
    order = order[u64.sort(r_x[order])[1]]
    x, sz, k = r_x[order], r_sz[order], r_k[order]
    same_prev = torch.zeros_like(k, dtype=torch.bool)
    same_prev[1:] = (x[1:] == x[:-1]) & (sz[1:] == sz[:-1])
    rep_valid = ~u64.is_sentinel(k)
    survivor = rep_valid & ~same_prev
    n_dup = (rep_valid & same_prev).sum()
    t_k, t_order = u64.sort(torch.where(survivor, k, u64.SENTINEL))
    t_sz = torch.where(survivor, sz, 0)[t_order]
    survivor_in = torch.zeros_like(survivor)
    survivor_in[order] = survivor
    return (t_k, t_sz), n_dup, survivor_in


def exactly_count_and_dedupe(cfg: HDBConfig, key: torch.Tensor,
                             keep: torch.Tensor):
    """Algorithm 4 (single device).

    Returns dense (same shape as ``keep``) ``right_exact`` (entries whose
    block the CMS over-counted), ``survive`` (entries on surviving deduped
    over-sized blocks) and ``size`` (exact block size, int32), plus the
    survivor table, duplicate count, survivor count and rep overflow.
    """
    n, k = keep.shape
    nk = n * k
    idx = torch.nonzero(keep.reshape(-1)).flatten()
    skey, (srid, sidx) = segments.sort_by_key(key.reshape(-1)[idx],
                                              [idx // max(k, 1), idx])
    live = ~u64.is_sentinel(skey)
    sizes = segments.segment_counts(skey)
    fp = torch.where(live, hashing.fingerprint_rid(srid), 0)
    xors = segments.segment_xor(skey, fp)

    over = live & (sizes > cfg.max_block_size)
    right_exact_sorted = live & ~over

    rep_pos = torch.nonzero(segments.segment_starts(skey) & over).flatten()
    rep_overflow = max(rep_pos.shape[0] - cfg.rep_capacity, 0)
    rep_pos = rep_pos[:cfg.rep_capacity]
    table, n_dup, survivor = dedupe_oversized_reps(
        xors[rep_pos], sizes[rep_pos], skey[rep_pos])
    t_k, t_sz = table
    # over-sized entries survive iff their key is in the survivor table
    hit, _ = segments.lookup_u64(t_k, t_sz, skey, 0)
    survive_sorted = over & hit

    def unsort(x_sorted, dtype):
        out = torch.zeros(nk, dtype=dtype, device=key.device)
        out[sidx] = x_sorted.to(dtype)
        return out.reshape(n, k)

    right_exact = unsort(right_exact_sorted, torch.bool)
    survive = unsort(survive_sorted, torch.bool)
    size = unsort(torch.where(live, sizes, 0), torch.int32)
    n_survivors = survivor.sum()
    return right_exact, survive, size, table, n_dup, n_survivors, rep_overflow


def intersect_keys(cfg: HDBConfig, key: torch.Tensor, survive: torch.Tensor,
                   size: torch.Tensor):
    """Algorithm 2: pairwise-intersect each record's over-sized keys.

    Keeps the ``max_oversize_keys`` smallest surviving blocks per record
    (key value breaks ties) and emits all pairwise combinations with
    ``psize = min(parent sizes)``.
    """
    n, k = survive.shape
    ko = min(cfg.max_oversize_keys, k)
    row_dead = survive.sum(dim=1) > cfg.max_keys  # Alg. 2 line 2
    sort_sz = torch.where(survive, size, INT32_MAX)
    # row sort by (size, key): stable sorts, least significant key first
    order = u64.sort(key, dim=1)[1]
    order = order.gather(1, torch.sort(sort_sz.gather(1, order), dim=1,
                                       stable=True)[1])
    order = order[:, :ko]
    k_s = key.gather(1, order)
    sz_s = sort_sz.gather(1, order)
    ok = survive.gather(1, order) & ~row_dead[:, None]

    ii, jj = np.triu_indices(ko, 1)
    ii = torch.from_numpy(ii).to(key.device)
    jj = torch.from_numpy(jj).to(key.device)
    # order-canonical combine (the hash64 combine kernel on the card)
    new_key = hash64_ops.combine64(k_s[:, ii], k_s[:, jj])
    new_psize = torch.minimum(sz_s[:, ii], sz_s[:, jj])
    new_valid = ok[:, ii] & ok[:, jj]
    # per-record set semantics: one row-sort carrying psize, mask repeats
    s_k, order2 = u64.sort(torch.where(new_valid, new_key, u64.SENTINEL), dim=1)
    s_psize = new_psize.gather(1, order2)
    s_valid = new_valid.gather(1, order2)
    same_prev = torch.zeros_like(s_valid)
    same_prev[:, 1:] = s_k[:, 1:] == s_k[:, :-1]
    return s_k, s_valid & ~same_prev, s_psize, row_dead.sum()


def hdb_iteration(cfg: HDBConfig, keys: torch.Tensor, valid: torch.Tensor,
                  psize: torch.Tensor):
    """One full HDB iteration. Returns (accepted_mask, new_state, stats)."""
    with record_function("hdb.rough"):
        right_cms, keep, dropped_sim, _ = rough_oversize_detection(
            cfg, keys, valid, psize)
    with record_function("hdb.exact"):
        (right_exact, survive, size, _table, n_dup, n_survivors,
         rep_overflow) = exactly_count_and_dedupe(cfg, keys, keep)
    accepted = right_cms | right_exact
    with record_function("hdb.intersect"):
        new_key, new_valid, new_psize, n_dropped_mk = intersect_keys(
            cfg, keys, survive, size)
    stats = {
        "n_live_keys": valid.sum(),
        "n_right_cms": right_cms.sum(),
        "n_right_exact": right_exact.sum(),
        "n_dropped_similarity": dropped_sim.sum(),
        "n_dropped_max_keys": n_dropped_mk,
        "n_duplicate_blocks": n_dup,
        "n_surviving_oversized": n_survivors,
        "n_surviving_entries": survive.sum(),
    }
    stats = dict(zip(stats, torch.stack(list(stats.values())).tolist()))
    stats["rep_overflow"] = rep_overflow
    return accepted, (new_key, new_valid, new_psize), stats


def hashed_dynamic_blocking(keys: torch.Tensor, valid: torch.Tensor,
                            cfg: HDBConfig = HDBConfig(),
                            verbose: bool = False,
                            device: DeviceLike = None) -> BlockingResult:
    """Run HDB to convergence over a dense top-level key matrix.

    Args:
      keys: (N, K) int64 u64 keys from ``blocks.build_keys``.
      valid: (N, K) bool.
      device: where to run; ``None`` means CUDA.
    """
    dev = resolve_device(device)
    keys = keys.to(dev)
    valid = valid.to(dev)
    n = valid.shape[0]
    psize = torch.full(valid.shape, INT32_MAX, dtype=torch.int32, device=dev)
    acc_rid: List[np.ndarray] = []
    acc_key: List[np.ndarray] = []
    all_stats: List[IterationStats] = []
    for it in range(cfg.max_iterations):
        accepted, (new_keys, new_valid, new_psize), stats = hdb_iteration(
            cfg, keys, valid, psize)
        with record_function("hdb.accept"):
            ridx, kidx = torch.nonzero(accepted, as_tuple=True)
            acc_rid.append(ridx.cpu().numpy().astype(np.int64))
            acc_key.append(u64.to_numpy_u64(keys[ridx, kidx]))
        st = IterationStats(iteration=it, **stats)
        all_stats.append(st)
        logger.log(logging.INFO if verbose else logging.DEBUG,
                   "[hdb] iter=%d %s", it, st)
        if st.rep_overflow:
            warnings.warn(
                f"[hdb] representative capacity overflow ({st.rep_overflow} "
                "blocks dropped); raise HDBConfig.rep_capacity",
                RepCapacityWarning, stacklevel=2)
        keys, valid, psize = new_keys, new_valid, new_psize
        if st.n_surviving_entries == 0:
            break
    else:
        leftover = int(valid.sum())
        if leftover:
            logger.info("[hdb] max_iterations reached with %d live keys dropped",
                        leftover)
    key64 = np.concatenate(acc_key) if acc_key else np.zeros((0,), np.uint64)
    return BlockingResult(
        rids=np.concatenate(acc_rid) if acc_rid else np.zeros((0,), np.int64),
        key_hi=(key64 >> np.uint64(32)).astype(np.uint32),
        key_lo=(key64 & np.uint64(u64.MASK32)).astype(np.uint32),
        stats=all_stats,
        num_records=n,
    )
