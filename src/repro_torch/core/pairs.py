"""Pair materialization + deduplication (paper §3.1 "Pair Deduplication").

Port of the JAX package's ``core/pairs.py`` host driver around the
``kernels/pairs`` engine:

- ``build_blocks`` groups accepted (rid, key) assignments into CSR blocks
  (sorted on the device; host numpy out, as in the reference);
- ``dedupe_pairs`` enumerates every block's C(n, 2) pair slots and keeps
  each distinct (a, b) once, with the size of its LARGEST source block.
  ``backend="numpy"`` is the host reference; ``"auto"`` is the device
  path whenever the int32 contract holds: it decodes slots in fixed
  chunks with the tri-decode kernel and sorts packed words with the radix
  kernel (their plain versions on CPU tensors); rids beyond the pack
  bound take stable torch sorts instead. The reference's CPU-measured
  small-input crossover is not carried over. When the contract fails,
  the numpy path runs with a ``RuntimeWarning``.
- beyond ``budget`` slots, a seeded uniform sample of ``budget`` slots
  is decoded (``exact=False``); the sampler is the reference's, so every
  backend of both packages draws the same slots;
- ``enumerate_pairs`` streams the raw slot decode in chunks, without
  dedupe (meta-blocking's edge multiplicities); ``pair_covered`` tells,
  for labelled pairs, whether an accepted block holds both (PC), by a
  sorted search on the device; the ``pair_bit_index`` family is the
  paper's triangular pair bitmap (host numpy).

The winners are compacted on the device; ``PairSet`` holds them as host
numpy plus the device buffers the matcher reads.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Iterator, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from . import u64
from .hdb import BlockingResult
from ..device import DeviceLike, resolve_device
from ..kernels import pairs as pairs_kernels
from ..kernels.pairs import ref as pairs_ref

INT32_MAX = 2**31 - 1


@dataclasses.dataclass
class Blocks:
    """Accepted blocks in CSR form, sorted by (key, rid)."""

    key_hi: np.ndarray   # (B,) uint32 block key
    key_lo: np.ndarray   # (B,) uint32
    start: np.ndarray    # (B,) int64 offset into members
    size: np.ndarray     # (B,) int64
    members: np.ndarray  # (M,) int64 rids, sorted within each block

    @property
    def num_blocks(self) -> int:
        return len(self.start)

    @property
    def num_pair_slots(self) -> int:
        """Sum over blocks of C(n,2) — pairs BEFORE cross-block dedupe."""
        return int(np.sum(self.size * (self.size - 1) // 2))


def build_blocks(result: BlockingResult, min_size: int = 2,
                 device: DeviceLike = None) -> Blocks:
    """Group accepted (rid, key) assignments into blocks.

    The (key, rid) sort runs on ``device`` (stable sorts, least
    significant key first: the reference's ``np.lexsort`` order); the
    CSR result is host numpy.
    """
    dev = resolve_device(device)
    if len(result.rids) == 0:
        z64 = np.zeros((0,), np.int64)
        zu = np.zeros((0,), np.uint32)
        return Blocks(zu, zu, z64, z64, z64)
    key64 = (result.key_hi.astype(np.uint64) << np.uint64(32)) | result.key_lo.astype(np.uint64)
    key = u64.from_numpy_u64(key64, dev)
    rids = torch.from_numpy(np.asarray(result.rids, np.int64)).to(dev)  # repro: noqa[R001] the host rids, uploaded
    order = torch.sort(rids, stable=True)[1]
    order = order[u64.sort(key[order])[1]]
    key, rids = key[order], rids[order]
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    starts = torch.nonzero(first).flatten()  # repro: noqa[R001] block starts: the host needs the block count
    sizes = torch.diff(starts, append=starts.new_tensor([key.shape[0]]))  # repro: noqa[R001] the end of the last block, an int upload
    keep = sizes >= min_size
    starts, sizes = starts[keep], sizes[keep]  # repro: noqa[R001] keeps the blocks of at least min_size
    keys = u64.to_numpy_u64(key[starts])
    return Blocks(
        key_hi=(keys >> np.uint64(32)).astype(np.uint32),
        key_lo=(keys & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        start=starts.cpu().numpy(),  # repro: noqa[R001] Blocks is host numpy
        size=sizes.cpu().numpy(),  # repro: noqa[R001] Blocks is host numpy
        members=rids.cpu().numpy(),  # repro: noqa[R001] Blocks is host numpy
    )


def iter_block_pairs(blocks: Blocks, chunk_pairs: int = 2_000_000
                     ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Yield (a, b, block_size) pair chunks across all blocks (HOST path).

    Small blocks use the vectorized shift method, large blocks per-block
    triangular emission; only the deduped pair SET is order-canonical.
    """
    small_cut = 64
    small = blocks.size <= small_cut
    if np.any(small):
        s_start = blocks.start[small]
        s_size = blocks.size[small]
        total = int(s_size.sum())
        offs = np.arange(total) - np.repeat(np.cumsum(s_size) - s_size, s_size)
        mem = blocks.members[np.repeat(s_start, s_size) + offs]
        seg = np.repeat(np.arange(len(s_size)), s_size)
        bsz = np.repeat(s_size, s_size)
        max_d = int(s_size.max())
        buf_a, buf_b, buf_s, buffered = [], [], [], 0
        for d in range(1, max_d):
            ok = seg[d:] == seg[:-d]
            if not ok.any():
                continue
            buf_a.append(mem[:-d][ok])
            buf_b.append(mem[d:][ok])
            buf_s.append(bsz[:-d][ok])
            buffered += int(ok.sum())
            if buffered >= chunk_pairs:
                yield np.concatenate(buf_a), np.concatenate(buf_b), np.concatenate(buf_s)
                buf_a, buf_b, buf_s, buffered = [], [], [], 0
        if buffered:
            yield np.concatenate(buf_a), np.concatenate(buf_b), np.concatenate(buf_s)
    for bi in np.flatnonzero(~small):
        s, n = int(blocks.start[bi]), int(blocks.size[bi])
        m = blocks.members[s : s + n]
        ii, jj = np.triu_indices(n, 1)
        for off in range(0, len(ii), chunk_pairs):
            sl = slice(off, off + chunk_pairs)
            yield m[ii[sl]], m[jj[sl]], np.full(len(ii[sl]), n, np.int64)


@dataclasses.dataclass
class PairSet:
    """Distinct pairs with largest-source-block provenance."""

    a: np.ndarray          # (P,) int64, a < b, sorted by (a, b)
    b: np.ndarray          # (P,) int64
    src_size: np.ndarray   # (P,) int64 size of largest block producing the pair
    exact: bool            # False => uniform slot sampling (budget exceeded)
    total_slots: int       # sum C(n,2) before dedupe
    # int32 (a, b) on the device, when the device path produced them
    device_a: Optional[torch.Tensor] = None
    device_b: Optional[torch.Tensor] = None

    def pair_buffers(self, device: DeviceLike):
        """(a, b) as int32 tensors on ``device``; no copy when the device
        path produced them there, one upload otherwise."""
        dev = resolve_device(device)
        if self.device_a is not None and self.device_a.device == dev:
            return self.device_a, self.device_b
        return (torch.from_numpy(self.a.astype(np.int32)).to(dev),
                torch.from_numpy(self.b.astype(np.int32)).to(dev))


_BACKENDS = ("auto", "numpy", "distributed")
# slots decoded per tri-decode launch
DECODE_CHUNK = 1 << 20


def _device_contract_ok(blocks: Blocks, budget: int) -> Optional[str]:
    """None if the int32 device engine applies, else the reason it doesn't."""
    if budget >= INT32_MAX:
        return f"budget {budget} >= int32 max"
    if blocks.num_blocks == 0:
        return None
    max_n = int(blocks.size.max())
    if max_n > pairs_kernels.MAX_BLOCK_N:
        return f"block size {max_n} > MAX_BLOCK_N {pairs_kernels.MAX_BLOCK_N}"
    if len(blocks.members) and int(blocks.members.max()) >= INT32_MAX:
        return "record ids >= int32 max"
    return None


def _resolve_backend(backend: str, blocks: Blocks, budget: int) -> str:
    if backend == "numpy":
        return "numpy"
    reason = _device_contract_ok(blocks, budget)
    if reason is None:
        return "device"
    warnings.warn(f"pairs backend {backend!r} unavailable ({reason}); "
                  "falling back to numpy", RuntimeWarning, stacklevel=3)
    return "numpy"


def _sample_slots(total: int, budget: int, seed: int,
                  device: torch.device) -> torch.Tensor:
    """Deterministic uniform pair-slot sample (the reference's sampler).

    Returns exactly ``min(budget, total)`` sorted distinct int64 slot
    indices on ``device``, in O(budget) memory: dense draws permute the
    slot range, sparse draws reject duplicates in growing
    with-replacement rounds and then subsample the distinct set
    uniformly. The random numbers are the reference's (the same numpy
    calls in the same order), so both packages draw the same slots; the
    distinct set is kept sorted on the device.
    """
    rng = np.random.default_rng(seed)
    budget = max(0, min(budget, total))
    if budget == 0:
        return torch.zeros(0, dtype=torch.int64, device=device)
    if 2 * budget >= total:
        perm = rng.permutation(total)[:budget].astype(np.int64)
        return torch.sort(torch.from_numpy(perm).to(device))[0]  # repro: noqa[R001] the host's PCG64 draws, uploaded
    uniq = torch.zeros(0, dtype=torch.int64, device=device)
    while uniq.shape[0] < budget:
        need = budget - uniq.shape[0]
        draws = rng.integers(0, total, size=int(need * 1.1) + 16, dtype=np.int64)
        uniq = torch.unique(torch.cat([uniq, torch.from_numpy(draws).to(device)]))  # repro: noqa[R001] the host's PCG64 draws, deduped
    if uniq.shape[0] > budget:
        # subsample uniformly: truncating the SORTED set would exclude the
        # top of the slot space. A mask keeps the picks in sorted order.
        pick = rng.choice(uniq.shape[0], budget, replace=False)
        keep = torch.zeros(uniq.shape[0], dtype=torch.bool, device=device)
        keep[torch.from_numpy(pick).to(device)] = True  # repro: noqa[R001] the host's PCG64 picks, uploaded
        uniq = uniq[keep]  # repro: noqa[R001] keeps the picked slots in sorted order
    return uniq


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _empty_pairset(exact: bool, total: int) -> PairSet:
    z = np.zeros((0,), np.int64)
    return PairSet(z, z, z, exact, total)


def _dedupe_numpy(blocks: Blocks, slots: Optional[np.ndarray]
                  ) -> Tuple[np.ndarray, ...]:
    """Host reference: shift-method enumeration (exact) or canonical slot
    decode (sampled), then lexsort dedupe."""
    if slots is None:
        chunks = list(iter_block_pairs(blocks))
        if not chunks:
            z = np.zeros((0,), np.int64)
            return z, z, z
        a = np.concatenate([np.minimum(ca, cb) for ca, cb, _ in chunks])
        b = np.concatenate([np.maximum(ca, cb) for ca, cb, _ in chunks])
        s = np.concatenate([cs for _, _, cs in chunks])
    else:
        a, b, s = pairs_ref.decode_slots_ref(
            blocks.start, blocks.size, blocks.members, slots)
    return pairs_ref.dedupe_ref(a, b, s)


def _sort_kind(blocks: Blocks) -> str:
    """The dedupe sort the input needs: ``"radix"`` (the radix kernel over
    packed words; its plain version on CPU tensors) when every rid fits
    the 62-bit sort word, else ``"comparator"`` (stable torch sorts)."""
    if (len(blocks.members) == 0
            or int(blocks.members.max()) < (1 << pairs_kernels.PACK_RID_BITS)):
        return "radix"
    return "comparator"


def _device_csr(blocks: Blocks, dev: torch.device):
    """The CSR and its slot prefix on ``dev``, as the decode takes them:
    (cum int64 (B+1,), start, size, members int32, search steps)."""
    def up(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # repro: noqa[R001] the host CSR uploaded once a call

    return (up(pairs_ref.cum_pair_counts(blocks.size)),
            up(blocks.start.astype(np.int32)), up(blocks.size.astype(np.int32)),
            up(blocks.members.astype(np.int32)),
            pairs_kernels.search_steps_for(int(blocks.size.max())))


def _decode_chunks(csr, total: int, chunk: int):
    """Decode every slot of ``total``, ``chunk`` slots a launch: yields
    (a, b, src_size, valid) per chunk, in the canonical slot order."""
    cum_d, start, size, members, steps = csr
    for base in range(0, total, chunk):
        yield pairs_kernels.decode_chunk(cum_d, start, size, members, base,
                                         total, chunk=chunk, steps=steps)


def _decode_slots(blocks: Blocks, slots: Optional[torch.Tensor], total: int,
                  dev: torch.device):
    """Decode every slot (exact) or the sampled ones, in chunks of
    ``DECODE_CHUNK``. Returns (a, b, src_size, valid) on ``dev``."""
    csr = _device_csr(blocks, dev)
    cum_d, start, size, members, steps = csr
    if slots is None:
        chunk = min(DECODE_CHUNK, _round_up(max(total, 1), 1024))
        parts = list(_decode_chunks(csr, total, chunk))
    else:
        # split int64 slots into (block, local); global slot indices
        # overflow int32, block-local ones do not
        parts = []
        block = torch.searchsorted(cum_d, slots, right=True) - 1
        local = (slots - cum_d[block]).to(torch.int32)
        for off in range(0, slots.shape[0], DECODE_CHUNK):
            sl = slice(off, off + DECODE_CHUNK)
            b_d, l_d = block[sl], local[sl]
            parts.append(pairs_kernels.decode_block_local(
                start, size, members, b_d, l_d,
                torch.ones_like(b_d, dtype=torch.bool), steps=steps))
    return tuple(torch.cat([p[i] for p in parts]) for i in range(4))


def _dedupe_device(blocks: Blocks, slots: Optional[torch.Tensor], total: int,
                   dev: torch.device):
    """Chunked slot decode + one sort-dedupe pass; winners compacted on
    the device. Returns (a, b, s) numpy and the int32 device (a, b)."""
    with record_function("pairs.decode"):
        a, b, s, v = _decode_slots(blocks, slots, total, dev)
    n_passes = pairs_kernels.radix_passes_for(
        int(blocks.members.max()) if len(blocks.members) else 0)
    with record_function("pairs.sort"):
        sa, sb, ss, winner = pairs_kernels.dedupe_device(
            a, b, s, v, sort_backend=_sort_kind(blocks), n_passes=n_passes)
    with record_function("pairs.compact"):
        wa, wb, ws = sa[winner], sb[winner], ss[winner]  # repro: noqa[R001] compacts the dedupe's winners
        host = tuple(x.cpu().numpy().astype(np.int64) for x in (wa, wb, ws))  # repro: noqa[R001] the PairSet is host numpy
    return host + ((wa.to(torch.int32), wb.to(torch.int32)),)


def dedupe_pairs(blocks: Blocks, budget: int = 50_000_000,
                 backend: str = "auto", sample_seed: int = 0,
                 device: DeviceLike = None, mesh=None,
                 axis_names: Tuple[str, ...] = ("data",),
                 route_slack: float = 2.0) -> PairSet:
    """RemoveDupePairs: distinct (a, b), keeping the largest source block.

    Within ``budget`` total pair slots the result is exact; beyond it the
    engine decodes a seeded uniform sample of ``budget`` slots
    (``exact=False``); ``total_slots`` stays exact. Every backend gives
    the same PairSet as the reference.

    ``backend="distributed"`` is the fingerprint-routed shard-local
    dedupe over ``mesh`` (``core.distributed.dedupe_pairs_distributed``,
    ``DECODE_CHUNK`` slots a shard a round); ``mesh=None`` is a one-dim
    ``("data",)`` mesh over the default process group, which must be
    initialised.
    """
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
    dev = resolve_device(device)
    total = blocks.num_pair_slots
    if total == 0:
        return _empty_pairset(True, total)
    if backend == "distributed":
        from . import distributed as dist_mod
        if mesh is None:
            mesh, axis_names = dist_mod.default_mesh(dev), ("data",)
        return dist_mod.dedupe_pairs_distributed(
            blocks, mesh, axis_names, budget=budget, chunk_per_shard=DECODE_CHUNK,
            route_slack=route_slack, sample_seed=sample_seed, device=dev)
    exact = total <= budget
    with record_function("pairs.sample_slots"):
        slots = None if exact else _sample_slots(total, budget, sample_seed, dev)
    if _resolve_backend(backend, blocks, budget) == "numpy":
        a, b, s = _dedupe_numpy(blocks, None if slots is None
                                else slots.cpu().numpy())  # repro: noqa[R001] the numpy back end takes host slots
        return PairSet(a, b, s, exact, total)
    a, b, s, (da, db) = _dedupe_device(blocks, slots, total, dev)
    return PairSet(a, b, s, exact, total, device_a=da, device_b=db)


def enumerate_pairs(blocks: Blocks, backend: str = "auto",
                    chunk_pairs: int = 1 << 20, device: DeviceLike = None
                    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Stream raw (a, b, block_size) numpy chunks WITHOUT dedupe.

    For consumers that need multiplicities (meta-blocking's CBS edge
    weights) rather than the deduped pair set. ``"auto"`` decodes the
    canonical slot order on ``device`` in chunks of ``chunk_pairs`` slots
    (the tri-decode kernel on the card), the reference's device order
    chunk for chunk; ``"numpy"`` streams ``iter_block_pairs``. The whole
    slot space must fit the int32 slot indices; a block set outside that
    contract takes the numpy stream with a ``RuntimeWarning``.
    """
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
    if backend == "distributed":
        raise ValueError(
            "enumerate_pairs streams raw pre-dedupe chunks and has no "
            "distributed backend; use a single-device backend here")
    # min() maps an overflowing slot total onto the budget >= int32 check
    if _resolve_backend(backend, blocks,
                        min(blocks.num_pair_slots, INT32_MAX)) == "numpy":
        yield from iter_block_pairs(blocks, chunk_pairs)
        return
    total = blocks.num_pair_slots
    if total == 0:
        return
    dev = resolve_device(device)
    chunk = min(chunk_pairs, _round_up(total, 1024))
    for a, b, s, v in _decode_chunks(_device_csr(blocks, dev), total, chunk):
        yield tuple(x[v].cpu().numpy().astype(np.int64) for x in (a, b, s))


# ---------------------------------------------------------------------------
# Triangular pair bitmap (paper §3.1 equation for b_{i,j})
# ---------------------------------------------------------------------------


def pair_bit_index(i: np.ndarray, j: np.ndarray, n: int) -> np.ndarray:
    """Bit index of pair (i, j), i < j, in the C(n,2) upper-triangular map."""
    i = np.asarray(i, np.int64)
    j = np.asarray(j, np.int64)
    return i * (n - 1) - (i - 1) * i // 2 + j - i - 1


def pair_from_bit_index(bit: np.ndarray, n: int) -> Tuple[np.ndarray, np.ndarray]:
    """Inverse of ``pair_bit_index``."""
    bit = np.asarray(bit, np.int64)
    # row i satisfies cum(i) <= bit < cum(i+1), cum(i) = i*(n-1) - (i-1)i/2
    i_all = np.arange(n, dtype=np.int64)
    cum = i_all * (n - 1) - (i_all - 1) * i_all // 2
    i = np.searchsorted(cum, bit, side="right") - 1
    j = bit - cum[i] + i + 1
    return i, j


def build_pair_bitmap(n: int, kept_i: np.ndarray, kept_j: np.ndarray) -> np.ndarray:
    """Packed uint8 bitmap of C(n,2) bits with the kept pairs set."""
    bits = np.zeros(n * (n - 1) // 2, np.uint8)
    bits[pair_bit_index(kept_i, kept_j, n)] = 1
    return np.packbits(bits)


def read_pair_bitmap(n: int, bitmap: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    bits = np.unpackbits(bitmap, count=n * (n - 1) // 2)
    return pair_from_bit_index(np.flatnonzero(bits), n)


# ---------------------------------------------------------------------------
# Membership for recall (PC) evaluation without pair materialization
# ---------------------------------------------------------------------------


def pair_covered(result: BlockingResult, pairs_a: np.ndarray, pairs_b: np.ndarray,
                 device: DeviceLike = None) -> np.ndarray:
    """For labeled pairs (a, b): does any accepted block contain both?

    No pair materialization, so it works at any scale. On ``device``, the
    assignments sorted by (key, rid) in u64 order give each key a dense
    rank; the table ``rank << 32 | rid`` is sorted, and each (a, b) looks
    up ``rank(k) << 32 | b`` for every key ``k`` of ``a`` (a's keys from
    the assignments sorted by rid) with ``torch.searchsorted``. The same
    boolean array as the reference's per-pair loop.
    """
    dev = resolve_device(device)
    pa = torch.from_numpy(np.asarray(pairs_a, np.int64)).to(dev)
    pb = torch.from_numpy(np.asarray(pairs_b, np.int64)).to(dev)
    covered = torch.zeros(pa.shape[0], dtype=torch.bool, device=dev)
    if len(result.rids) == 0 or pa.shape[0] == 0:
        return covered.cpu().numpy()
    key64 = (result.key_hi.astype(np.uint64) << np.uint64(32)) | result.key_lo.astype(np.uint64)
    key = u64.from_numpy_u64(key64, dev)
    rid = torch.from_numpy(np.asarray(result.rids, np.int64)).to(dev)
    order = torch.sort(rid, stable=True)[1]
    order = order[u64.sort(key[order])[1]]
    key, rid = key[order], rid[order]
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = key[1:] != key[:-1]
    rank = torch.cumsum(first, 0) - 1
    table = (rank << 32) | rid                 # sorted: rids are < 2**31
    by_rid = torch.sort(rid, stable=True)[1]
    rid_sorted, rank_by_rid = rid[by_rid], rank[by_rid]
    lo = torch.searchsorted(rid_sorted, pa, side="left")
    deg = torch.searchsorted(rid_sorted, pa, side="right") - lo
    owner = torch.repeat_interleave(torch.arange(pa.shape[0], device=dev), deg)
    offs = torch.arange(owner.shape[0], device=dev) - (torch.cumsum(deg, 0) - deg)[owner]
    query = (rank_by_rid[lo[owner] + offs] << 32) | pb[owner]
    pos = torch.searchsorted(table, query).clamp(max=table.shape[0] - 1)
    hit = (table[pos] == query) & (pb[owner] >= 0) & (pb[owner] <= INT32_MAX)
    covered[owner[hit]] = True
    return covered.cpu().numpy()
