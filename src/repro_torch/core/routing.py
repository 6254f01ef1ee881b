"""The shard owner rule shared by the sharded streaming store.

Port of the host half of the JAX package's ``core/routing.py``: an
entry's owner shard is ``(low 32 bits of hash_u64(x, seed)) % n_shards``.
``KEY_OWNER_SEED`` partitions 64-bit block keys (the store's key tables,
sketch slices and CSR), ``REP_OWNER_SEED`` membership fingerprints and
pair packs (the ledger). The device routing (``route_buckets``,
``exchange``) belongs to the mesh half and is not ported yet.
"""
from __future__ import annotations

import numpy as np

from . import hashing

KEY_OWNER_SEED = 0xA110
REP_OWNER_SEED = 0xDED0


def np_owner_u64(x: np.ndarray, n_shards: int,
                 seed: int = KEY_OWNER_SEED) -> np.ndarray:
    """int32 owner shard per packed u64 value."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    h = hashing.np_hash_u64_vec(np.asarray(x, np.uint64), seed=seed)
    return ((h & np.uint64(0xFFFFFFFF))
            % np.uint64(n_shards)).astype(np.int32)
