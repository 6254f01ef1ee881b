"""Pair-engine ops: chunked slot decode + sort-based dedupe.

Port of the JAX package's ``kernels/pairs/ops.py``. A block of size ``n``
owns C(n, 2) consecutive slots of the canonical enumeration (``ref.py``).

- ``decode_chunk``: slots ``[base, base + chunk)`` -> (a, b, src_size,
  valid); the slot -> block map is a scatter of block starts + cumsum,
  the triangular decode is ``tri_decode`` (the CUDA kernel on the card),
  and the member gathers are plain PyTorch.
- ``decode_block_local``: the same for pre-split (block, local) slots
  (the sampling path splits int64 slot draws on the host).
- dedupe: "largest block wins" is ONE sort of the 62-bit word
  ``[a:23 | b:23 | (MAX-size):16]`` held in one int64, then a
  first-of-(a, b)-run winner mask. Invalid lanes are the all-ones
  sentinel, which sorts last in unsigned order.

``pair_route_owner`` gives each pair its shard in the routed
distributed dedupe.

int32 contract (kept from the reference so outputs and warnings agree):
rids and the slot range are < 2**31, block sizes <= MAX_BLOCK_N; the
packed sort word also needs rids < 2**PACK_RID_BITS.
"""
from __future__ import annotations

import torch

from ...core import hashing, u64
from ..sort import ops as sort_ops
from .tri import tri_decode

_INT32_MAX = 2**31 - 1
PACK_RID_BITS = 23
_PACK_SIZE_BITS = 16
_SIZE_MASK = (1 << _PACK_SIZE_BITS) - 1  # == MAX_BLOCK_N
_RID_MASK = (1 << PACK_RID_BITS) - 1
# pair-fingerprint routing seed (the reference's ROUTE_SEED)
ROUTE_SEED = 0x9A12


def _decode(start, members, block, local, n, valid, steps):
    i, j = tri_decode(local.to(torch.int32), n, steps)
    s0 = start[block].to(torch.int64)
    last = max(members.shape[0] - 1, 0)
    # garbage lanes (invalid, n < 2) may index anywhere: clamp as XLA does
    a = members[(s0 + i).clamp(0, last)]
    b = members[(s0 + j).clamp(0, last)]
    return torch.minimum(a, b), torch.maximum(a, b), n, valid


def decode_chunk(cum: torch.Tensor, start: torch.Tensor, size: torch.Tensor,
                 members: torch.Tensor, base: int, total: int, *, chunk: int,
                 steps: int):
    """Decode pair slots [base, base+chunk) -> (a, b, src_size, valid).

    ``cum`` is the int64 (B+1,) slot prefix on the device; ``start``,
    ``size``, ``members`` are int32 CSR arrays. Slots >= total are invalid.
    """
    dev = start.device
    offsets = torch.arange(chunk, dtype=torch.int64, device=dev)
    valid = offsets < (total - base)
    start_pos = (cum[:-1] - base).clamp(0, chunk)
    delta = torch.zeros(chunk + 1, dtype=torch.int32, device=dev)
    delta.index_add_(0, start_pos, torch.ones_like(start_pos, dtype=torch.int32))
    block = (torch.cumsum(delta[:chunk], 0) - 1).clamp(0, cum.shape[0] - 2)
    local = torch.where(valid, base + offsets, 0) - cum[block]
    return _decode(start, members, block, local, size[block], valid, steps)


def decode_block_local(start: torch.Tensor, size: torch.Tensor,
                       members: torch.Tensor, block: torch.Tensor,
                       local: torch.Tensor, valid: torch.Tensor, *,
                       steps: int):
    """Decode pre-split (block, local) slots (sampling path)."""
    block = block.to(torch.int64).clamp(0, size.shape[0] - 1)
    return _decode(start, members, block, local, size[block], valid, steps)


def pack_sort_words(a: torch.Tensor, b: torch.Tensor, src_size: torch.Tensor,
                    valid: torch.Tensor) -> torch.Tensor:
    """(a, b, size) -> the 62-bit sort word (int64); invalid -> sentinel.

    Word = (a << 39) | (b << 16) | (MAX_BLOCK_N - size): ascending order is
    (a, b) ascending with size DESCENDING inside each (a, b) run.
    """
    inv = _SIZE_MASK - src_size.to(torch.int64).clamp(0, _SIZE_MASK)
    w = (a.to(torch.int64) << (PACK_RID_BITS + _PACK_SIZE_BITS)) \
        | (b.to(torch.int64) << _PACK_SIZE_BITS) | inv
    return torch.where(valid, w, u64.SENTINEL)


def pair_route_owner(a: torch.Tensor, b: torch.Tensor, valid: torch.Tensor,
                     n_shards: int) -> torch.Tensor:
    """Owning shard of pair (a, b) in the fingerprint-routed dedupe.

    Hashes only the 46-bit run id ``(a << 23) | b`` (the sort word
    without its size bits), so every occurrence of a pair lands on one
    shard whichever block produced it; the low 32 bits of the hash (the
    hash64 mix kernel on the card) modulo ``n_shards``. Invalid lanes get
    ``n_shards``, which ``route_buckets`` drops.
    """
    run = (a.to(torch.int64) << PACK_RID_BITS) | b.to(torch.int64)
    owner = u64.lo32(hashing.hash_u64(run, seed=ROUTE_SEED)) % n_shards
    return torch.where(valid, owner, n_shards)


def radix_passes_for(max_rid: int) -> int:
    """Pass count covering the 62-bit word for rids <= max_rid."""
    bits = _PACK_SIZE_BITS + PACK_RID_BITS + max(1, int(max_rid).bit_length())
    n = -(-bits // sort_ops.RADIX_BITS)
    return max(sort_ops.MIN_PASSES, min(sort_ops.MAX_PASSES, n))


def dedupe_packed_device(words: torch.Tensor, sort_backend: str = "comparator",
                         n_passes: int = sort_ops.MAX_PASSES):
    """Sort packed words + mark the first word of each (a, b) run.

    Returns (sorted words, winner mask); sentinels are never winners.
    """
    sw = sort_ops.sort_words(words, backend=sort_backend, n_passes=n_passes)
    run = sw >> _PACK_SIZE_BITS       # (a << 23) | b on valid words
    first = torch.ones_like(sw, dtype=torch.bool)
    first[1:] = run[1:] != run[:-1]
    return sw, first & ~u64.is_sentinel(sw)


def unpack_words(words: torch.Tensor):
    """Valid sort words -> (a, b, src_size) int64 on the same device."""
    a = words >> (PACK_RID_BITS + _PACK_SIZE_BITS)  # repro: noqa[R002] 62-bit words: >> is logical
    b = (words >> _PACK_SIZE_BITS) & _RID_MASK  # repro: noqa[R002] 62-bit words: >> is logical
    return a, b, _SIZE_MASK - (words & _SIZE_MASK)


def dedupe_device(a: torch.Tensor, b: torch.Tensor, src_size: torch.Tensor,
                  valid: torch.Tensor, *, sort_backend: str = "comparator",
                  n_passes: int = sort_ops.MAX_PASSES):
    """Device sort by (a, b, size desc); mark each pair's largest block.

    ``"radix"`` sorts the packed words (rids < 2**PACK_RID_BITS, checked
    by the caller); ``"comparator"`` is the general-rid path: stable
    sorts, least significant key first. Returns (a, b, size, winner)
    sorted; invalid lanes sort to the tail and never win.
    """
    if sort_backend == "radix":
        sw, winner = dedupe_packed_device(
            pack_sort_words(a, b, src_size, valid), "radix", n_passes)
        ua, ub, us = unpack_words(sw)
        return ua, ub, us, winner
    av = torch.where(valid, a.to(torch.int64), _INT32_MAX)
    bv = torch.where(valid, b.to(torch.int64), _INT32_MAX)
    skey = _INT32_MAX - torch.where(valid, src_size.to(torch.int64), 0)
    order = torch.sort(skey, stable=True)[1]
    order = order[torch.sort(bv[order], stable=True)[1]]
    order = order[torch.sort(av[order], stable=True)[1]]
    sa, sb, ss = av[order], bv[order], skey[order]
    live = ~((sa == _INT32_MAX) & (sb == _INT32_MAX))
    first = torch.ones_like(live)
    first[1:] = (sa[1:] != sa[:-1]) | (sb[1:] != sb[:-1])
    return sa, sb, _INT32_MAX - ss, live & first
