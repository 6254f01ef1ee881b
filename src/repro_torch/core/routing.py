"""Shard routing: the owner rule, fixed-capacity buckets and the swap.

Port of the JAX package's ``core/routing.py``. Every distributed
exchange follows one pattern (paper §4): an owner shard per entry
(``(low 32 bits of hash_u64(x, seed)) % n_shards``), entries scattered
into fixed-capacity per-destination buckets (``route_buckets``), and the
buckets swapped with ONE ``all_to_all_single`` (``exchange``). Overflows
are counted, never silent: callers warn (HDB) or fall back (pair dedupe,
the sharded store's key exchange).

``KEY_OWNER_SEED`` partitions 64-bit block keys (the distributed HDB's
exact counts and the sharded store's key tables, sketch slices and CSR),
``REP_OWNER_SEED`` membership fingerprints and pair packs (the ledger).
``np_owner_u64`` is the host mirror of ``owner_u64``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import hashing, u64

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


def owner_u64(x: torch.Tensor, n_shards: int, seed: int,
              live: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int64 owner shard per u64 value (the hash64 mix kernel on the
    card); ``n_shards`` where ``live`` is given and false, which
    ``route_buckets`` drops."""
    owner = u64.lo32(hashing.hash_u64(x, seed=seed)) % n_shards
    return owner if live is None else torch.where(live, owner, n_shards)


def linear_shard_index(mesh, axis_names: Sequence[str]) -> int:
    """This rank's flat shard id: row-major over ``axis_names``, the
    order ``exchange`` gives its rows."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not part of the mesh")
    names = tuple(mesh.mesh_dim_names or ())
    idx = 0
    for name in axis_names:
        if name not in names:
            raise ValueError(f"mesh dims {names} have no {name!r}")
        d = names.index(name)
        idx = idx * mesh.size(d) + coord[d]
    return idx


def route_buckets(key: torch.Tensor, payloads: Sequence[torch.Tensor],
                  owner: torch.Tensor, n_shards: int, cap: int):
    """Scatter entries into per-destination buckets (before ``exchange``).

    Args:
      key: u64 key per entry (int64 bit patterns).
      payloads: more per-entry tensors routed beside the key.
      owner: destination shard per entry; ``n_shards`` drops the entry.
      cap: per-destination bucket capacity.

    Returns ``(bkey, bucketed_payloads, overflow)`` with bucket shape
    ``(n_shards, cap)``: absent slots hold the sentinel key and zero
    payloads; inside a bucket entries keep their input order, so an
    overflow drops the same entries as the reference's. ``overflow`` (a
    0-d int64 tensor) counts live entries past their bucket's capacity.
    """
    n = owner.shape[0]
    owner = owner.to(torch.int64)
    owner_s, order = torch.sort(owner, stable=True)
    counts = torch.bincount(owner, minlength=n_shards + 1)  # repro: noqa[R001] bucket counts of each owner
    first = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(owner)
    rank[order] = torch.arange(n, dtype=torch.int64, device=owner.device) - first[owner_s]
    routed = owner < n_shards
    ok = routed & (rank < cap)
    overflow = (routed & (rank >= cap)).sum()
    pos = (owner * cap + rank)[ok]  # repro: noqa[R001] keeps the entries that fit their bucket

    def scatter(x, fill):
        buf = torch.full((n_shards * cap,), fill, dtype=x.dtype, device=x.device)
        buf[pos] = x[ok]
        return buf.view(n_shards, cap)

    return (scatter(key, u64.SENTINEL), [scatter(p, 0) for p in payloads],
            overflow)


def exchange(group, *buckets: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Swap each ``(n_shards, cap)`` bucket tensor with one
    ``all_to_all_single`` on ``group``, on the device it lives on.

    After the exchange, row ``p`` of each returned tensor is the bucket
    this shard received from source shard ``p``.
    """
    out: List[torch.Tensor] = []
    for b in buckets:
        recv = torch.empty_like(b)
        dist.all_to_all_single(recv, b.contiguous(), group=group)
        out.append(recv)
    return tuple(out)
