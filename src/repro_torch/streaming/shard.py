"""Fingerprint-sharded BlockStore: N key-partitioned slices, one surface.

Port of the meshless path of the JAX package's ``streaming/shard.py``.
The single ``BlockStore`` keeps one ``LevelKeys`` (sketch + key table)
per level plus one ``BlockCsr`` and one ``PairLedger``. This module
partitions all three by fingerprint over ``core.routing``'s owner rule
and exposes the ``BlockStore`` surface the delta blocker uses:

- **Key space** (``ShardedLevelKeys``): key-table rows and sketch
  fold-ins go to ``owner = hash_u64(key64, KEY_OWNER_SEED) % n_shards``,
  the partition the distributed batch step uses for its exact counts.
  Each shard's sketch slice is an int32 tensor on the store's device that
  holds only its keys' entries, folded in and out by the cms kernel as
  ``LevelKeys`` does; the sketch is linear, so the elementwise sum of the
  slices (kept on the device as the merged replica) is the union's sketch
  and serves every estimate.
- **Accepted-blocks CSR** (``StoreShard.csr``): partitioned by block-key
  owner.
- **Pair ledger** (``StoreShard.ledger``): partitioned by pair-pack owner
  (``REP_OWNER_SEED``).

Shard key sets are disjoint, so every merged view (``accepted_blocks``,
``candidate_pairs``, splice and pair deltas) is a re-sorted
concatenation, equal to the single store's. Without a mesh the key-delta
exchange is the host owner grouping; ``n_shards=1`` is the single store.
A mesh (the routed exchange and ledger sync) belongs to the mesh and
distributed half of ROADMAP A7 (A7b) and raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core import hdb as hdb_mod
from ..core import pairs as pairs_mod
from ..core import routing, sketches
from ..device import DeviceLike, resolve_device
from .store import (BlockCsr, LevelKeys, LevelState, PairLedger, cms_gather,
                    merge_blocks, unpack_pair)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "a sharded store on a mesh (the routed key-delta exchange and "
            "ledger sync) is not ported yet: it belongs to the mesh and "
            "distributed half of ROADMAP A7 (A7b)")


class ShardRouter:
    """Owner computation and the (host) key-delta exchange."""

    def __init__(self, n_shards: int):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = n_shards
        self.exchange_total = 0
        # the host grouping never overflows; the mesh exchange's count
        self.exchange_fallback_total = 0

    def key_owner(self, key64: np.ndarray) -> np.ndarray:
        return routing.np_owner_u64(key64, self.n_shards,
                                    seed=routing.KEY_OWNER_SEED)

    def pair_owner(self, pack: np.ndarray) -> np.ndarray:
        return routing.np_owner_u64(pack, self.n_shards,
                                    seed=routing.REP_OWNER_SEED)

    def exchange_key_deltas(self, d_key: np.ndarray, d_cnt: np.ndarray,
                            d_fp: np.ndarray
                            ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Route aggregated key-table deltas to their owner shards.

        Returns one (key, cnt, fp) triple per shard, key-sorted (the
        ``update_keytab`` input contract): ``d_key`` is sorted unique
        (``reduce_by_key`` output), and grouping keeps its order.
        """
        self.exchange_total += 1
        owner = self.key_owner(d_key)
        return [(d_key[m], d_cnt[m], d_fp[m])
                for m in (owner == s for s in range(self.n_shards))]


class ShardedLevelKeys:
    """N per-shard ``LevelKeys`` slices + the merged sketch replica.

    Presents the ``LevelKeys`` method surface to ``LevelState``. The
    per-shard sketches are the partitioned state (each fold lands on the
    entry's key owner); ``cms`` is their elementwise sum on the device.
    """

    def __init__(self, cms_cfg: sketches.CMSConfig,
                 slices: List[LevelKeys], router: ShardRouter,
                 device: torch.device):
        self.cms_cfg = cms_cfg
        self.slices = slices
        self.router = router
        self.cms = torch.zeros((cms_cfg.depth, cms_cfg.width), dtype=torch.int32,
                               device=device)

    # ---- CMS ----

    def cms_apply(self, idx: np.ndarray, sign: int,
                  key64: Optional[np.ndarray] = None) -> None:
        """Fold entries into (+1) or out of (-1) their owners' slices
        (``key64``, the entries' keys, picks the owner), then re-sum the
        merged replica."""
        if key64 is None:
            raise ValueError("a sharded key space routes sketch folds on key64")
        owner = self.router.key_owner(key64)
        for s, sl in enumerate(self.slices):
            m = owner == s
            if m.any():
                sl.cms_apply(idx[:, m], sign)
        self.cms = torch.stack([sl.cms for sl in self.slices]).sum(
            0, dtype=torch.int32)

    def cms_lookup(self, idx: np.ndarray) -> np.ndarray:
        return cms_gather(self.cms, idx)

    # ---- key table ----

    def update_keytab(self, d_key: np.ndarray, d_cnt: np.ndarray,
                      d_fp: np.ndarray) -> np.ndarray:
        parts = self.router.exchange_key_deltas(d_key, d_cnt, d_fp)
        for sl, (k, c, f) in zip(self.slices, parts):
            if len(k):
                sl.update_keytab(k, c, f)
        return d_key

    def lookup(self, key64: np.ndarray
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        flat = np.asarray(key64, np.uint64).reshape(-1)
        owner = self.router.key_owner(flat)
        cnt = np.zeros(flat.shape, np.int64)
        surv = np.zeros(flat.shape, bool)
        found = np.zeros(flat.shape, bool)
        for s, sl in enumerate(self.slices):
            m = owner == s
            if m.any():
                cnt[m], surv[m], found[m] = sl.lookup(flat[m])
        shape = np.shape(key64)
        return cnt.reshape(shape), surv.reshape(shape), found.reshape(shape)

    def lookup_fp(self, key64: np.ndarray) -> np.ndarray:
        flat = np.asarray(key64, np.uint64).reshape(-1)
        owner = self.router.key_owner(flat)
        fp = np.zeros(flat.shape, np.uint64)
        for s, sl in enumerate(self.slices):
            m = owner == s
            if m.any():
                fp[m] = sl.lookup_fp(flat[m])
        return fp.reshape(np.shape(key64))

    def oversized(self, max_block_size: int
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        ks, cs, fs = zip(*(sl.oversized(max_block_size) for sl in self.slices))
        key = np.concatenate(ks)
        # global key order is the single store's survivor-pass input order
        # (shard key sets are disjoint)
        order = np.argsort(key)
        return (key[order], np.concatenate(cs)[order],
                np.concatenate(fs)[order])

    def set_survivors(self, over_key: np.ndarray,
                      surv: np.ndarray) -> np.ndarray:
        owner = self.router.key_owner(over_key)
        changed = []
        for s, sl in enumerate(self.slices):
            m = owner == s
            # every shard is called, even with no over-keys: its stale
            # survivor flags from the previous ingest must clear
            ch = sl.set_survivors(over_key[m], surv[m])
            if len(ch):
                changed.append(ch)
        if not changed:
            return np.zeros((0,), np.uint64)
        return np.sort(np.concatenate(changed))

    @property
    def num_keys(self) -> int:
        return sum(sl.num_keys for sl in self.slices)

    @property
    def keytab_bytes(self) -> int:
        return sum(sl.keytab_bytes for sl in self.slices)

    @property
    def cms_bytes(self) -> int:
        return (self.cms.numel() * self.cms.element_size()
                + sum(sl.cms_bytes for sl in self.slices))


class StoreShard:
    """One shard's slice of the partitioned state: its per-level
    ``LevelKeys``, its block keys' CSR and its pair fingerprints' ledger."""

    def __init__(self, cfg: hdb_mod.HDBConfig, shard_id: int,
                 device: torch.device):
        self.cfg = cfg
        self.shard_id = shard_id
        self.device = device
        self.level_keys: List[Optional[LevelKeys]] = [None] * cfg.max_iterations
        self.csr = BlockCsr()
        self.ledger = PairLedger()

    def keys_at(self, level: int) -> LevelKeys:
        if self.level_keys[level] is None:
            self.level_keys[level] = LevelKeys.empty(self.cfg.cms, self.device)
        return self.level_keys[level]

    @property
    def keytab_bytes(self) -> int:
        return sum(ks.keytab_bytes for ks in self.level_keys if ks is not None)

    @property
    def num_keys(self) -> int:
        return sum(ks.num_keys for ks in self.level_keys if ks is not None)

    @property
    def total_bytes(self) -> int:
        return self.keytab_bytes + self.csr.nbytes + self.ledger.nbytes


class ShardedBlockStore:
    """N fingerprint-routed ``StoreShard``s behind the ``BlockStore``
    surface.

    A drop-in for ``BlockStore`` in ``DeltaBlocker`` and
    ``StreamingEngine``: every merged view equals the single store's
    after the same ingest sequence. ``device`` holds the sketch slices
    and runs the delta blocker's device steps (``None`` means CUDA).
    ``mesh`` is not ported yet and raises.
    """

    def __init__(self, cfg: hdb_mod.HDBConfig = hdb_mod.HDBConfig(),
                 n_shards: int = 1, mesh=None, device: DeviceLike = None):
        _no_mesh(mesh)
        self.cfg = cfg
        self.n_shards = n_shards
        self.mesh = None
        self.device = resolve_device(device)
        self.router = ShardRouter(n_shards)
        self.shards = [StoreShard(cfg, s, self.device) for s in range(n_shards)]
        self.num_records = 0
        self.levels: List[Optional[LevelState]] = [None] * cfg.max_iterations

    # ---- level access ----

    def level(self, i: int, width: Optional[int] = None) -> LevelState:
        st = self.levels[i]
        if st is None:
            if width is None:
                raise ValueError(f"level {i} accessed before first ingest")
            keyspace = ShardedLevelKeys(
                self.cfg.cms, [sh.keys_at(i) for sh in self.shards],
                self.router, self.device)
            st = LevelState.empty(width, self.cfg.cms, self.device,
                                  keyspace=keyspace)
            self.levels[i] = st
        elif width is not None and st.width != width:
            raise ValueError(
                f"level {i} width mismatch: store has {st.width}, delta has "
                f"{width} (top-level key schema must be stable)")
        return st

    # ---- accepted-blocks CSR (key-owner partitioned) ----

    def members_of(self, key64: np.ndarray) -> List[np.ndarray]:
        key64 = np.asarray(key64, np.uint64)
        owner = self.router.key_owner(key64)
        out: List[Optional[np.ndarray]] = [None] * len(key64)
        for s, sh in enumerate(self.shards):
            m = np.flatnonzero(owner == s)
            if len(m):
                for qi, mem in zip(m, sh.csr.members_of(key64[m])):
                    out[qi] = mem
        return out  # type: ignore[return-value]

    def affected_slice(self, keys: np.ndarray) -> pairs_mod.Blocks:
        owner = self.router.key_owner(keys)
        return merge_blocks([sh.csr.affected_slice(keys[owner == s])
                             for s, sh in enumerate(self.shards)])

    def block_size_of(self, key64: np.ndarray) -> np.ndarray:
        owner = self.router.key_owner(key64)
        size = np.zeros(len(key64), np.int64)
        for s, sh in enumerate(self.shards):
            m = owner == s
            if m.any():
                size[m] = sh.csr.size_of(key64[m])
        return size

    def apply_assignment_deltas(self, add_k: np.ndarray, add_r: np.ndarray,
                                ret_k: np.ndarray, ret_r: np.ndarray,
                                snapshot_keys: Optional[np.ndarray] = None
                                ) -> Tuple[np.ndarray, pairs_mod.Blocks,
                                           pairs_mod.Blocks]:
        ao = self.router.key_owner(add_k)
        ro = self.router.key_owner(ret_k)
        so = (None if snapshot_keys is None
              else self.router.key_owner(snapshot_keys))
        affected, olds, news = [], [], []
        for s, sh in enumerate(self.shards):
            aff_s, old_s, new_s = sh.csr.splice(
                add_k[ao == s], add_r[ao == s],
                ret_k[ro == s], ret_r[ro == s],
                None if snapshot_keys is None else snapshot_keys[so == s])
            affected.append(aff_s)
            olds.append(old_s)
            news.append(new_s)
        return (np.sort(np.concatenate(affected)),
                merge_blocks(olds), merge_blocks(news))

    # ---- ledger (pair-fingerprint partitioned) ----

    def apply_pair_deltas(self, pair_pack: np.ndarray, src: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if len(pair_pack) == 0:
            z = np.zeros((0,), np.uint64)
            return z, np.zeros((0,), np.int64), z
        owner = self.router.pair_owner(pair_pack)
        add_p, add_s, retr = [], [], []
        for s, sh in enumerate(self.shards):
            m = owner == s
            ap, asrc, rp = sh.ledger.apply(pair_pack[m], src[m])
            add_p.append(ap)
            add_s.append(asrc)
            retr.append(rp)
        ap = np.concatenate(add_p)
        order = np.argsort(ap)
        return ap[order], np.concatenate(add_s)[order], np.sort(np.concatenate(retr))

    def ledger_src(self, pack: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        owner = self.router.pair_owner(pack)
        cur = np.zeros(len(pack), np.int64)
        found = np.zeros(len(pack), bool)
        for s, sh in enumerate(self.shards):
            m = owner == s
            if m.any():
                cur[m], found[m] = sh.ledger.src_of(pack[m])
        return cur, found

    # ---- merged views (equal to the single store's) ----

    def _ledger(self) -> Tuple[np.ndarray, np.ndarray]:
        pack = np.concatenate([sh.ledger.pack for sh in self.shards])
        src = np.concatenate([sh.ledger.src for sh in self.shards])
        order = np.argsort(pack)
        return pack[order], src[order]

    @property
    def led_pack(self) -> np.ndarray:
        return self._ledger()[0]

    @property
    def led_src(self) -> np.ndarray:
        return self._ledger()[1]

    def accepted_blocks(self, min_size: int = 1) -> pairs_mod.Blocks:
        return merge_blocks([sh.csr.view(min_size) for sh in self.shards])

    def candidate_pairs(self) -> pairs_mod.PairSet:
        pack, src = self._ledger()
        a, b = unpack_pair(pack)
        blk = self.accepted_blocks(min_size=2)
        return pairs_mod.PairSet(a=a, b=b, src_size=src, exact=True,
                                 total_slots=blk.num_pair_slots)

    # ---- stats ----

    def shard_skew(self) -> float:
        """max/mean ratio of per-shard state bytes (1.0 == balanced)."""
        per = [sh.total_bytes for sh in self.shards]
        mean = sum(per) / max(len(per), 1)
        return float(max(per) / mean) if mean else 1.0

    def memory_stats(self) -> dict:
        out = {"num_records": self.num_records,
               "n_shards": self.n_shards,
               "ledger_pairs": sum(sh.ledger.num_pairs for sh in self.shards),
               "accepted_blocks": sum(sh.csr.num_blocks for sh in self.shards),
               "accepted_assignments": sum(sh.csr.num_assignments
                                           for sh in self.shards)}
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
        out["csr_bytes"] = sum(sh.csr.nbytes for sh in self.shards)
        out["ledger_bytes"] = sum(sh.ledger.nbytes for sh in self.shards)
        for s, sh in enumerate(self.shards):
            out[f"shard{s}_keytab_bytes"] = sh.keytab_bytes
            out[f"shard{s}_csr_bytes"] = sh.csr.nbytes
            out[f"shard{s}_ledger_bytes"] = sh.ledger.nbytes
        out["shard_skew"] = self.shard_skew()
        out["exchange_fallback_total"] = self.router.exchange_fallback_total
        return out
