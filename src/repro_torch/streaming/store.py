"""BlockStore: the persistent blocking state between ingests.

Port of the JAX package's ``streaming/store.py``. One store holds, for
every HDB iteration level ``i``:

- the per-record iteration state exactly as the batch driver would hold
  it at iteration ``i`` on the union of everything ingested so far: dense
  ``(R_i, W_i)`` key/valid/psize arrays over live rows, the cached
  decision bits (right/keep/accept/survive) and per-entry exact sizes,
- the level's key space (``LevelKeys``): the Count-Min Sketch over its
  live (record, key) entries, kept current by linear fold-in/fold-out
  (``sketches.cms_fold`` / ``cms_subtract``), and the key table (sorted
  u64 keys -> exact keep-entry count, XOR membership fingerprint,
  survivor flag),

and globally:

- the accepted-blocks CSR (``BlockCsr``: sorted block keys -> member rid
  runs), i.e. ``pairs.build_blocks(min_size=1)`` of the union's accepted
  assignments, spliced only where membership changed,
- the candidate-pair ledger (``PairLedger``: packed ``a << 32 | b`` u64
  keys -> size of the largest source block), i.e. ``pairs.dedupe_pairs``
  of the CSR, kept from per-ingest pair deltas.

Keys are numpy uint64 here (the JAX package also keeps ``(R, W, 2)``
uint32 limbs; this store holds the packed form only). The key table, CSR,
ledger and row state are host numpy; the level's sketch is an int32
tensor on the store's device, built from a delta's entries by the cms
kernel and folded in or out there. Arrays cross to the device through
``u64.from_numpy_u64`` and come back through ``u64.to_numpy_u64``, so
every ``searchsorted`` here runs in unsigned order.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import hdb as hdb_mod
from ..core import pairs as pairs_mod
from ..core import sketches
from ..device import DeviceLike, resolve_device

INT32_MAX = np.iinfo(np.int32).max
SENTINEL_U64 = np.uint64(0xFFFFFFFFFFFFFFFF)


def pack_key64(keys: np.ndarray) -> np.ndarray:
    """(..., 2) uint32 ``(hi, lo)`` limbs -> uint64."""
    k = np.asarray(keys, np.uint32)
    return (k[..., 0].astype(np.uint64) << np.uint64(32)) | k[..., 1]


def unpack_key64(key64: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    key64 = np.asarray(key64, np.uint64)
    return ((key64 >> np.uint64(32)).astype(np.uint32),
            (key64 & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def pack_pair(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Canonical (a < b) rid pair -> sortable uint64."""
    return (np.asarray(a, np.uint64) << np.uint64(32)) | np.asarray(b, np.uint64)


def unpack_pair(p: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    p = np.asarray(p, np.uint64)
    return ((p >> np.uint64(32)).astype(np.int64),
            (p & np.uint64(0xFFFFFFFF)).astype(np.int64))


def gather_segments(starts: np.ndarray, sizes: np.ndarray,
                    pool: np.ndarray) -> np.ndarray:
    """Concatenate ``pool[start : start + size]`` runs (vectorized)."""
    total = int(sizes.sum())
    offs = (np.arange(total, dtype=np.int64)
            - np.repeat(np.cumsum(sizes) - sizes, sizes))
    return pool[np.repeat(starts, sizes) + offs]


def blocks_from_segments(key64: np.ndarray, sizes: np.ndarray,
                         members: np.ndarray) -> pairs_mod.Blocks:
    """Compact (key, size, concatenated members) runs into a Blocks CSR."""
    hi, lo = unpack_key64(key64)
    start = np.concatenate([[0], np.cumsum(sizes)])[:-1].astype(np.int64)
    return pairs_mod.Blocks(hi, lo, start, sizes.astype(np.int64),
                            members.astype(np.int64))


def merge_blocks(parts: Sequence[pairs_mod.Blocks]) -> pairs_mod.Blocks:
    """Merge CSR slices with disjoint keys into one key-sorted CSR."""
    parts = [b for b in parts if b.num_blocks]
    if not parts:
        z64 = np.zeros((0,), np.uint64)
        return blocks_from_segments(z64, np.zeros((0,), np.int64),
                                    np.zeros((0,), np.int64))
    key64 = np.concatenate([
        (b.key_hi.astype(np.uint64) << np.uint64(32))
        | b.key_lo.astype(np.uint64) for b in parts])
    sizes = np.concatenate([b.size for b in parts]).astype(np.int64)
    offs = np.cumsum([0] + [len(b.members) for b in parts])[:-1]
    starts = np.concatenate([b.start + off
                             for b, off in zip(parts, offs)]).astype(np.int64)
    pool = np.concatenate([b.members for b in parts])
    order = np.argsort(key64)
    members = gather_segments(starts[order], sizes[order], pool)
    return blocks_from_segments(key64[order], sizes[order], members)


def searchsorted_mask(sorted_arr: np.ndarray, queries: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(positions, found_mask) of ``queries`` in a sorted array."""
    pos = np.searchsorted(sorted_arr, queries)
    safe = np.minimum(pos, max(len(sorted_arr) - 1, 0))
    found = ((pos < len(sorted_arr)) & (sorted_arr[safe] == queries)
             if len(sorted_arr) else np.zeros(len(queries), bool))
    return pos, found


def set_subtract_pairs(cand_k: np.ndarray, cand_r: np.ndarray,
                       ret_k: np.ndarray, ret_r: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Sorted set difference on (key64, rid) pairs.

    ``cand`` holds distinct pairs; every ``ret`` pair occurs in ``cand``.
    Returns the surviving pairs sorted by (key, rid): one stable lexsort
    with a source flag puts each retract right after its candidate.
    """
    if len(ret_k) == 0:
        order = np.lexsort((cand_r, cand_k))
        return cand_k[order], cand_r[order]
    allk = np.concatenate([cand_k, ret_k])
    allr = np.concatenate([cand_r, ret_r])
    src = np.concatenate([np.zeros(len(cand_k), np.int8),
                          np.ones(len(ret_k), np.int8)])
    order = np.lexsort((src, allr, allk))
    allk, allr, src = allk[order], allr[order], src[order]
    dead = np.zeros(len(allk), bool)
    ret_pos = np.flatnonzero(src == 1)
    dead[ret_pos - 1] = True  # the matching candidate right before each ret
    keep = (src == 0) & ~dead
    return allk[keep], allr[keep]


def reduce_by_key(keys: np.ndarray, cnt: np.ndarray, fp: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Aggregate (count sum, fingerprint XOR) per distinct key."""
    order = np.argsort(keys, kind="stable")
    keys, cnt, fp = keys[order], cnt[order], fp[order]
    starts = np.flatnonzero(np.concatenate([[True], keys[1:] != keys[:-1]]))
    uk = keys[starts]
    ucnt = np.add.reduceat(cnt, starts)
    ufp = np.bitwise_xor.reduceat(fp, starts)
    return uk, ucnt, ufp


def cms_gather(cms: torch.Tensor, idx: np.ndarray) -> np.ndarray:
    """Per-depth bucket counts of a device sketch: host (depth,
    *entry_shape) int32."""
    idx_t = torch.from_numpy(np.ascontiguousarray(idx, np.int32)).to(cms.device).long()
    got = torch.stack([cms[j][idx_t[j]] for j in range(idx_t.shape[0])])
    return got.cpu().numpy()


@dataclasses.dataclass
class LevelKeys:
    """One level's key space: the CMS (a device tensor) + the exact key
    table (host numpy)."""

    cms_cfg: sketches.CMSConfig
    cms: torch.Tensor     # (depth, width) int32 on the store's device
    tab_key: np.ndarray   # (K,) uint64, sorted
    tab_cnt: np.ndarray   # (K,) int64
    tab_fp: np.ndarray    # (K,) uint64
    tab_surv: np.ndarray  # (K,) bool

    @staticmethod
    def empty(cms_cfg: sketches.CMSConfig, device: torch.device) -> "LevelKeys":
        return LevelKeys(
            cms_cfg=cms_cfg,
            cms=torch.zeros((cms_cfg.depth, cms_cfg.width), dtype=torch.int32,
                            device=device),
            tab_key=np.zeros((0,), np.uint64),
            tab_cnt=np.zeros((0,), np.int64),
            tab_fp=np.zeros((0,), np.uint64),
            tab_surv=np.zeros((0,), bool),
        )

    # ---- CMS (linear sketch: fold-in/out = elementwise +/-) ----

    def cms_apply(self, idx: np.ndarray, sign: int,
                  key64: Optional[np.ndarray] = None) -> None:
        """Fold entry occurrences in (+1) or out (-1) of the sketch.

        ``idx`` holds the entries' (depth, M) cached bucket indices; their
        sketch is built on the device (the cms kernel on the card) and
        folded in or subtracted. ``key64`` (the entries' keys) is unused
        here; the sharded key space routes on it.
        """
        del key64
        if sign not in (1, -1):
            raise ValueError(f"sign must be +1 or -1, got {sign}")
        dev = self.cms.device
        idx_t = torch.from_numpy(np.ascontiguousarray(idx, np.int32)).to(dev)
        live = torch.ones(idx_t.shape[1], dtype=torch.bool, device=dev)
        delta = sketches.cms_build_indices(self.cms_cfg, idx_t, live)
        fold = sketches.cms_fold if sign > 0 else sketches.cms_subtract
        self.cms = fold(self.cms, delta)

    def cms_lookup(self, idx: np.ndarray) -> np.ndarray:
        return cms_gather(self.cms, idx)

    # ---- exact key table ----

    def update_keytab(self, d_key: np.ndarray, d_cnt: np.ndarray,
                      d_fp: np.ndarray) -> np.ndarray:
        """Apply aggregated (count, fingerprint) deltas; returns the keys
        whose table row changed (including inserts and deletions).

        ``d_key`` must be sorted unique (``reduce_by_key`` order), which
        keeps the table sorted under ``np.insert``.
        """
        if len(d_key) == 0:
            return d_key
        pos, found = searchsorted_mask(self.tab_key, d_key)
        upd = np.flatnonzero(found)
        if len(upd):
            rows = pos[upd]
            self.tab_cnt[rows] += d_cnt[upd]
            self.tab_fp[rows] ^= d_fp[upd]
        new = np.flatnonzero(~found)
        if len(new):
            at = pos[new]
            self.tab_key = np.insert(self.tab_key, at, d_key[new])
            self.tab_cnt = np.insert(self.tab_cnt, at, d_cnt[new])
            self.tab_fp = np.insert(self.tab_fp, at, d_fp[new])
            self.tab_surv = np.insert(self.tab_surv, at, False)
        # drop zero-count rows (all their entries un-kept)
        dead = self.tab_cnt == 0
        if dead.any():
            self.tab_key = self.tab_key[~dead]
            self.tab_cnt = self.tab_cnt[~dead]
            self.tab_fp = self.tab_fp[~dead]
            self.tab_surv = self.tab_surv[~dead]
        return d_key

    def lookup(self, key64: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(count, survivor flag, found) per query key (count 0 if absent)."""
        if len(self.tab_key) == 0:
            return (np.zeros(key64.shape, np.int64),
                    np.zeros(key64.shape, bool),
                    np.zeros(key64.shape, bool))
        pos, found = searchsorted_mask(self.tab_key, key64.reshape(-1))
        safe = np.minimum(pos, len(self.tab_key) - 1)
        cnt = np.where(found, self.tab_cnt[safe], 0)
        surv = np.where(found, self.tab_surv[safe], False)
        return (cnt.reshape(key64.shape).astype(np.int64),
                surv.reshape(key64.shape),
                found.reshape(key64.shape))

    def lookup_fp(self, key64: np.ndarray) -> np.ndarray:
        """Membership XOR-fingerprint per query key (0 if absent)."""
        if len(self.tab_key) == 0:
            return np.zeros(key64.shape, np.uint64)
        pos, found = searchsorted_mask(self.tab_key, key64.reshape(-1))
        safe = np.minimum(pos, len(self.tab_key) - 1)
        return np.where(found, self.tab_fp[safe],
                        np.uint64(0)).reshape(key64.shape)

    def oversized(self, max_block_size: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(key, count, fingerprint) of over-sized table rows, key-sorted."""
        over = self.tab_cnt > max_block_size
        return self.tab_key[over], self.tab_cnt[over], self.tab_fp[over]

    def set_survivors(self, over_key: np.ndarray,
                      surv: np.ndarray) -> np.ndarray:
        """Replace ALL survivor flags (rows not in ``over_key`` clear);
        returns the keys whose flag flipped."""
        new_surv = np.zeros(len(self.tab_key), bool)
        if len(over_key):
            pos, found = searchsorted_mask(self.tab_key, over_key)
            new_surv[pos[found]] = surv[found]
        changed = new_surv != self.tab_surv
        self.tab_surv = new_surv
        return self.tab_key[changed]

    @property
    def num_keys(self) -> int:
        return len(self.tab_key)

    @property
    def keytab_bytes(self) -> int:
        return (self.tab_key.nbytes + self.tab_cnt.nbytes
                + self.tab_fp.nbytes + self.tab_surv.nbytes)

    @property
    def cms_bytes(self) -> int:
        return self.cms.numel() * self.cms.element_size()


class BlockCsr:
    """Accepted-blocks CSR: sorted block keys -> member-rid runs.

    == ``pairs.build_blocks(min_size=1)`` of the union's accepted
    assignments, spliced per ingest only where membership changed.
    """

    def __init__(self):
        self.key = np.zeros((0,), np.uint64)
        self.start = np.zeros((0,), np.int64)
        self.size = np.zeros((0,), np.int64)
        self.members = np.zeros((0,), np.int64)

    def members_of(self, key64: np.ndarray) -> List[np.ndarray]:
        """Member rid arrays per query block key (empty when absent)."""
        out = []
        pos, found = searchsorted_mask(self.key, np.asarray(key64, np.uint64))
        for p, f in zip(pos, found):
            if f:
                s = self.start[p]
                out.append(self.members[s:s + self.size[p]])
            else:
                out.append(np.zeros((0,), np.int64))
        return out

    def affected_slice(self, keys: np.ndarray) -> pairs_mod.Blocks:
        """CSR restricted to ``keys`` (sorted unique), for the pair engine."""
        pos, found = searchsorted_mask(self.key, keys)
        pos = pos[found]
        members = gather_segments(self.start[pos], self.size[pos],
                                  self.members)
        return blocks_from_segments(self.key[pos], self.size[pos], members)

    def size_of(self, key64: np.ndarray) -> np.ndarray:
        """int64 block size per query key (0 when absent)."""
        if len(self.key) == 0:
            return np.zeros(len(key64), np.int64)
        pos, found = searchsorted_mask(self.key, key64)
        return np.where(found, self.size[np.minimum(pos, len(self.key) - 1)],
                        0).astype(np.int64)

    def splice(self, add_k: np.ndarray, add_r: np.ndarray,
               ret_k: np.ndarray, ret_r: np.ndarray,
               snapshot_keys: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, pairs_mod.Blocks, pairs_mod.Blocks]:
        """Splice accepted-assignment adds/retracts into the CSR.

        Returns (affected_keys_sorted, old_snapshot_csr, new_affected_csr).
        The old snapshot covers ``snapshot_keys`` (default: all affected
        keys) as they were BEFORE the splice; the new slice covers all
        affected keys after.
        """
        affected = np.unique(np.concatenate([add_k, ret_k]))
        old_csr = self.affected_slice(
            affected if snapshot_keys is None else snapshot_keys)

        # rebuild the affected keys' member lists
        pos, found = searchsorted_mask(self.key, affected)
        aff_pos = pos[found]
        old_sizes = self.size[aff_pos]
        old_k = np.repeat(self.key[aff_pos], old_sizes)
        old_r = gather_segments(self.start[aff_pos], old_sizes, self.members)
        cand_k = np.concatenate([old_k, add_k])
        cand_r = np.concatenate([old_r, add_r])
        new_k, new_r = set_subtract_pairs(cand_k, cand_r, ret_k, ret_r)
        uk_starts = np.flatnonzero(
            np.concatenate([[True], new_k[1:] != new_k[:-1]])
        ) if len(new_k) else np.zeros((0,), np.int64)
        uk = new_k[uk_starts]
        usz = np.diff(np.concatenate([uk_starts, [len(new_k)]])).astype(np.int64)

        # new global CSR = unaffected segments merged with rebuilt segments
        unaff = np.ones(len(self.key), bool)
        unaff[aff_pos] = False
        pool = np.concatenate([self.members, new_r])
        seg_key = np.concatenate([self.key[unaff], uk])
        seg_start = np.concatenate(
            [self.start[unaff],
             len(self.members) + np.concatenate([[0], np.cumsum(usz)])[:-1]]
        ).astype(np.int64)
        seg_size = np.concatenate([self.size[unaff], usz])
        order = np.argsort(seg_key, kind="stable")
        seg_key = seg_key[order]
        seg_start = seg_start[order]
        seg_size = seg_size[order]
        self.members = gather_segments(seg_start, seg_size, pool)
        self.key = seg_key
        self.size = seg_size
        self.start = (np.concatenate([[0], np.cumsum(seg_size)])[:-1]
                      .astype(np.int64))

        new_csr = blocks_from_segments(uk, usz, new_r)
        return affected, old_csr, new_csr

    def view(self, min_size: int = 1) -> pairs_mod.Blocks:
        """The CSR as a Blocks slice restricted to ``size >= min_size``."""
        keep = self.size >= min_size
        members = gather_segments(self.start[keep], self.size[keep],
                                  self.members)
        return blocks_from_segments(self.key[keep], self.size[keep], members)

    @property
    def num_blocks(self) -> int:
        return len(self.key)

    @property
    def num_assignments(self) -> int:
        return len(self.members)

    @property
    def nbytes(self) -> int:
        return (self.key.nbytes + self.start.nbytes + self.size.nbytes
                + self.members.nbytes)


class PairLedger:
    """Candidate-pair ledger: packed pair u64 -> largest source block size.

    == ``pairs.dedupe_pairs`` of the accepted-blocks CSR, kept from
    per-ingest pair deltas.
    """

    def __init__(self):
        self.pack = np.zeros((0,), np.uint64)
        self.src = np.zeros((0,), np.int64)

    def apply(self, pair_pack: np.ndarray, src: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Upsert/retract affected pairs; ``src == 0`` means uncovered.

        Returns (added_pack, added_src, retracted_pack), each sorted.
        """
        if len(pair_pack) == 0:
            z = np.zeros((0,), np.uint64)
            return z, np.zeros((0,), np.int64), z
        order = np.argsort(pair_pack)
        pair_pack, src = pair_pack[order], src[order]
        pos, found = searchsorted_mask(self.pack, pair_pack)
        to_del = found & (src == 0)
        to_upd = found & (src > 0)
        to_ins = ~found & (src > 0)
        retracted = pair_pack[to_del]
        if np.any(to_upd):
            self.src[pos[to_upd]] = src[to_upd]
        if np.any(to_ins):
            at = pos[to_ins]
            self.pack = np.insert(self.pack, at, pair_pack[to_ins])
            self.src = np.insert(self.src, at, src[to_ins])
        if np.any(to_del):
            # positions shift after insert; recompute by search
            dpos, dfound = searchsorted_mask(self.pack, retracted)
            keep = np.ones(len(self.pack), bool)
            keep[dpos[dfound]] = False
            self.pack = self.pack[keep]
            self.src = self.src[keep]
        return pair_pack[to_ins], src[to_ins], retracted

    def src_of(self, pack: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(current src size, found mask) per packed pair (0 when absent)."""
        if len(self.pack) == 0:
            return (np.zeros(len(pack), np.int64),
                    np.zeros(len(pack), bool))
        pos, found = searchsorted_mask(self.pack, pack)
        cur = np.zeros(len(pack), np.int64)
        cur[found] = self.src[np.minimum(pos, len(self.pack) - 1)][found]
        return cur, found

    @property
    def num_pairs(self) -> int:
        return len(self.pack)

    @property
    def nbytes(self) -> int:
        return self.pack.nbytes + self.src.nbytes


@dataclasses.dataclass
class LevelState:
    """Cached union state at one HDB iteration level (see module doc).

    Row state (everything per (record, key slot)) lives here; the key
    space (CMS + key table) lives in ``keyspace``. The delegation methods
    below are the only key-space surface the delta algorithm uses.
    """

    width: int
    rids: np.ndarray      # (R,) int64, sorted
    key64: np.ndarray     # (R, W) uint64, sentinel where ~valid
    valid: np.ndarray     # (R, W) bool
    psize: np.ndarray     # (R, W) int32
    idx: np.ndarray       # (depth, R, W) int32 CMS bucket indices
    right: np.ndarray     # (R, W) bool  CMS says right-sized
    keep: np.ndarray      # (R, W) bool  survives rough detection
    accept: np.ndarray    # (R, W) bool  accepted assignment
    survive: np.ndarray   # (R, W) bool  on a surviving over-sized block
    size: np.ndarray      # (R, W) int32 exact keep-count (0 where ~keep)
    keyspace: LevelKeys   # CMS + key table (or a sharded composite)

    @property
    def num_rows(self) -> int:
        return len(self.rids)

    @property
    def num_entries(self) -> int:
        return int(self.valid.sum())

    @staticmethod
    def empty(width: int, cms_cfg: sketches.CMSConfig, device: torch.device,
              keyspace=None) -> "LevelState":
        depth = cms_cfg.depth
        return LevelState(
            width=width,
            rids=np.zeros((0,), np.int64),
            key64=np.zeros((0, width), np.uint64),
            valid=np.zeros((0, width), bool),
            psize=np.zeros((0, width), np.int32),
            idx=np.zeros((depth, 0, width), np.int32),
            right=np.zeros((0, width), bool),
            keep=np.zeros((0, width), bool),
            accept=np.zeros((0, width), bool),
            survive=np.zeros((0, width), bool),
            size=np.zeros((0, width), np.int32),
            keyspace=(LevelKeys.empty(cms_cfg, device) if keyspace is None
                      else keyspace),
        )

    # ---- key-space delegation (the delta algorithm's only key-space API) --

    def cms_apply(self, idx: np.ndarray, sign: int,
                  key64: Optional[np.ndarray] = None) -> None:
        self.keyspace.cms_apply(idx, sign, key64)

    def cms_lookup(self, idx: np.ndarray) -> np.ndarray:
        return self.keyspace.cms_lookup(idx)

    def update_keytab(self, d_key: np.ndarray, d_cnt: np.ndarray,
                      d_fp: np.ndarray) -> np.ndarray:
        return self.keyspace.update_keytab(d_key, d_cnt, d_fp)

    def lookup(self, key64: np.ndarray):
        return self.keyspace.lookup(key64)

    def lookup_fp(self, key64: np.ndarray) -> np.ndarray:
        return self.keyspace.lookup_fp(key64)

    def oversized(self, max_block_size: int):
        return self.keyspace.oversized(max_block_size)

    def set_survivors(self, over_key: np.ndarray,
                      surv: np.ndarray) -> np.ndarray:
        return self.keyspace.set_survivors(over_key, surv)

    @property
    def num_keys(self) -> int:
        return self.keyspace.num_keys

    # ---- row state ----

    _ROW_FIELDS = ("key64", "valid", "psize", "right", "keep", "accept",
                   "survive", "size")

    def row_index(self, rids: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(row positions, found mask) for record ids."""
        return searchsorted_mask(self.rids, np.asarray(rids, np.int64))

    def _take_rows(self, rows: np.ndarray) -> None:
        self.rids = self.rids[rows]
        for name in self._ROW_FIELDS:
            setattr(self, name, getattr(self, name)[rows])
        self.idx = self.idx[:, rows]

    def drop_rows(self, rows: np.ndarray) -> None:
        keep = np.ones(len(self.rids), bool)
        keep[rows] = False
        self._take_rows(keep)

    def append_rows(self, rids, key64, valid, psize, idx) -> None:
        n, w = len(rids), self.width
        zb = np.zeros((n, w), bool)
        new = {"key64": key64, "valid": valid, "psize": psize, "right": zb,
               "keep": zb, "accept": zb, "survive": zb,
               "size": np.zeros((n, w), np.int32)}
        self.rids = np.concatenate([self.rids, np.asarray(rids, np.int64)])
        for name in self._ROW_FIELDS:
            setattr(self, name, np.concatenate([getattr(self, name), new[name]]))
        self.idx = np.concatenate([self.idx, idx], axis=1)
        order = np.argsort(self.rids, kind="stable")
        if not np.array_equal(order, np.arange(len(order))):
            self._take_rows(order)


class BlockStore:
    """Persistent blocking state for streaming ingest + candidate queries.

    ``device`` holds the level sketches and runs the device steps of the
    delta blocker; ``None`` means CUDA and raises without a card.
    """

    def __init__(self, cfg: hdb_mod.HDBConfig = hdb_mod.HDBConfig(),
                 device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.num_records = 0
        self.levels: List[Optional[LevelState]] = [None] * cfg.max_iterations
        # accepted blocks CSR (== pairs.build_blocks(min_size=1) of the union)
        self.csr = BlockCsr()
        # candidate-pair ledger (== pairs.dedupe_pairs of the CSR, exact)
        self.ledger = PairLedger()

    # array views the data pipeline and tests read

    @property
    def bk_key(self) -> np.ndarray:
        return self.csr.key

    @property
    def bk_members(self) -> np.ndarray:
        return self.csr.members

    @property
    def led_pack(self) -> np.ndarray:
        return self.ledger.pack

    @property
    def led_src(self) -> np.ndarray:
        return self.ledger.src

    # ---- level access ----

    def level(self, i: int, width: Optional[int] = None) -> LevelState:
        st = self.levels[i]
        if st is None:
            if width is None:
                raise ValueError(f"level {i} accessed before first ingest")
            st = LevelState.empty(width, self.cfg.cms, self.device)
            self.levels[i] = st
        elif width is not None and st.width != width:
            raise ValueError(
                f"level {i} width mismatch: store has {st.width}, delta has "
                f"{width} (top-level key schema must be stable)")
        return st

    # ---- accepted-blocks CSR ----

    def members_of(self, key64: np.ndarray) -> List[np.ndarray]:
        """Member rid arrays per query block key (empty when absent)."""
        return self.csr.members_of(key64)

    def affected_slice(self, keys: np.ndarray) -> pairs_mod.Blocks:
        """CSR restricted to ``keys`` (sorted unique), for the pair engine."""
        return self.csr.affected_slice(keys)

    def block_size_of(self, key64: np.ndarray) -> np.ndarray:
        """int64 accepted-block size per query key (0 when absent)."""
        return self.csr.size_of(key64)

    def apply_assignment_deltas(self, add_k: np.ndarray, add_r: np.ndarray,
                                ret_k: np.ndarray, ret_r: np.ndarray,
                                snapshot_keys: Optional[np.ndarray] = None
                                ) -> Tuple[np.ndarray, pairs_mod.Blocks,
                                           pairs_mod.Blocks]:
        """Splice accepted-assignment adds/retracts into the blocks CSR
        (see ``BlockCsr.splice``)."""
        return self.csr.splice(add_k, add_r, ret_k, ret_r, snapshot_keys)

    # ---- ledger ----

    def apply_pair_deltas(self, pair_pack: np.ndarray, src: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Upsert/retract affected pairs; ``src == 0`` means uncovered.

        Returns (added_pack, added_src, retracted_pack).
        """
        return self.ledger.apply(pair_pack, src)

    def ledger_src(self, pack: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(current src size, found mask) per packed pair (0 when absent)."""
        return self.ledger.src_of(pack)

    # ---- views ----

    def accepted_blocks(self, min_size: int = 1) -> pairs_mod.Blocks:
        """Current union accepted blocks (== build_blocks of a batch run)."""
        return self.csr.view(min_size)

    def candidate_pairs(self) -> pairs_mod.PairSet:
        """Current candidate-pair set (== dedupe_pairs of a batch run)."""
        a, b = unpack_pair(self.led_pack)
        blk = self.accepted_blocks(min_size=2)
        return pairs_mod.PairSet(a=a, b=b, src_size=self.led_src.copy(),
                                 exact=True, total_slots=blk.num_pair_slots)

    def memory_stats(self) -> Dict[str, int]:
        out = {"num_records": self.num_records,
               "ledger_pairs": len(self.led_pack),
               "accepted_blocks": len(self.bk_key),
               "accepted_assignments": len(self.bk_members)}
        keytab_bytes = cms_bytes = 0
        for i, st in enumerate(self.levels):
            if st is not None:
                out[f"level{i}_rows"] = st.num_rows
                out[f"level{i}_entries"] = st.num_entries
                out[f"level{i}_keys"] = st.num_keys
                keytab_bytes += st.keyspace.keytab_bytes
                cms_bytes += st.keyspace.cms_bytes
        out["keytab_bytes"] = keytab_bytes
        out["cms_bytes"] = cms_bytes
        out["csr_bytes"] = self.csr.nbytes
        out["ledger_bytes"] = self.ledger.nbytes
        return out
