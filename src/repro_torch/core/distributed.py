"""Distributed HDB and routed pair dedupe over ``torch.distributed``.

Port of the JAX package's ``core/distributed.py``: the paper's Spark
dataflow on a mesh. The reference is single-controller (``shard_map``
hands each device its row slice, one host loop reads the result back);
the port is SPMD: every rank runs the same loop on the same global
arguments, keeps only its own row slice on its device, and gathers in
shard order what the reference's controller reads back, so every rank
returns the reference's result. ``mesh`` is a ``DeviceMesh`` whose dim
names are the reference's axis names (``distributed/sharding.py``).
Collectives take each tensor on the device it lives on.

Per HDB iteration, on each rank's slice:

  - CMS:     built by the cms kernel, merged with one ``all_reduce``.
  - Exact:   surviving entries route to key-owner shards with one
             ``all_to_all_single``; the owner sorts them and gets exact
             counts and XOR membership fingerprints.
  - Dedupe:  block representatives route by fingerprint with a second,
             smaller exchange; the survivors are all-gathered as the
             paper's broadcast counts map; a Bloom filter of every
             over-sized key is OR-merged (``all_reduce(MAX)``) so a rank
             recovers CMS-over-counted right-sized blocks (Alg. 4: not in
             the Bloom => right-sized; in the counts map => over-sized;
             otherwise a duplicate, dropped).
  - Intersect: record-local (Alg. 2), no communication.

Buffers have the reference's fixed capacities, so an overflow drops the
same entries and is counted the same (``rep_overflow``), never silent.

``dedupe_pairs_distributed`` shards the canonical pair-slot space,
packs each decoded pair into the 62-bit sort word and routes it by pair
fingerprint (``kernels/pairs.pair_route_owner``), one exchange a round,
so the largest-block-wins dedupe is shard-local (the radix sort). Its
PairSet equals the single-device ``core/pairs.dedupe_pairs``'s, exact
and sampled; a bucket overflow warns (``RepCapacityWarning``) and
returns the single-device result.
"""
from __future__ import annotations

import dataclasses
import logging
import warnings
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as tdist
from torch.profiler import record_function

from . import hashing, hdb, pairs as pairs_mod, routing, segments, sketches, u64
from .hdb import BlockingResult, HDBConfig, INT32_MAX, IterationStats, RepCapacityWarning
from ..device import DeviceLike, resolve_device
from ..distributed import sharding
from ..kernels import pairs as pairs_kernels
from ..kernels.sort import ops as sort_ops

logger = logging.getLogger(__name__)

_STATS = ("n_live_keys", "n_right_cms", "n_right_exact", "n_dropped_similarity",
          "n_dropped_max_keys", "n_duplicate_blocks", "n_surviving_oversized",
          "n_surviving_entries", "rep_overflow")


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Fixed buffer capacities for the distributed exchanges."""

    route_slack: float = 2.0       # bucket slack over the mean
    rep_capacity_per_shard: int = 1 << 14
    bloom_slots: int = 1 << 22
    bloom_hashes: int = 20


def default_mesh(device: DeviceLike = None):
    """A one-dim ``("data",)`` mesh over the default process group."""
    from torch.distributed.device_mesh import DeviceMesh
    if not tdist.is_initialized():
        raise ValueError("a distributed backend needs a process group: call "
                         "torch.distributed.init_process_group first (a world "
                         "of one is a valid group)")
    return DeviceMesh(resolve_device(device).type,
                      torch.arange(tdist.get_world_size()), mesh_dim_names=("data",))


def pad_rows(keys: torch.Tensor, valid: torch.Tensor, world: int):
    """``(keys, valid)`` padded with sentinel, invalid rows to a multiple of
    ``world``: the even row split ``distributed_hashed_dynamic_blocking``
    takes."""
    pad = (-keys.shape[0]) % world
    return (torch.cat([keys, keys.new_full((pad, keys.shape[1]), u64.SENTINEL)]),
            torch.cat([valid, valid.new_zeros((pad, valid.shape[1]))]))


def gather_rows(sh: sharding.Shards, x: torch.Tensor) -> torch.Tensor:
    """Concatenate every shard's ``x`` (ragged along dim 0) in shard order:
    the counts first, then padded buffers."""
    dev = x.device
    counts = torch.empty(sh.n_shards, dtype=torch.int64, device=dev)
    tdist.all_gather_into_tensor(
        counts, torch.tensor([x.shape[0]], dtype=torch.int64, device=dev),  # repro: noqa[R001] the row count sizes the gather
        group=sh.group)
    counts = counts.tolist()
    width = max(counts)
    if width == 0:
        return x[:0]
    pad = torch.zeros((width,) + tuple(x.shape[1:]), dtype=x.dtype, device=dev)
    pad[: x.shape[0]] = x
    out = torch.empty((sh.n_shards * width,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=dev)
    tdist.all_gather_into_tensor(out, pad, group=sh.group)
    return torch.cat([out[r * width: r * width + c] for r, c in enumerate(counts)])


def make_hdb_step(cfg: HDBConfig, mesh, axis_names: Sequence[str] = ("data",),
                  dist: DistConfig = DistConfig()):
    """The per-rank distributed HDB iteration on the rank's row slice.

    Returns ``step(keys, valid, psize) -> (accepted, (new_keys, new_valid,
    new_psize), stats)`` with every stat summed over the shards.
    """
    sh = sharding.shards(mesh, axis_names)
    n = sh.n_shards
    bloom_cfg = sketches.BloomConfig(dist.bloom_slots, dist.bloom_hashes)
    rcap = dist.rep_capacity_per_shard
    xcap = int(np.ceil(rcap / n * dist.route_slack)) + 8

    def step(keys: torch.Tensor, valid: torch.Tensor, psize: torch.Tensor):
        n_loc, k = valid.shape
        dev = keys.device
        flat_key = keys.reshape(-1)
        with record_function("hdb.rough"):
            # rough over-size detection (Alg. 3): the CMS merged by a sum
            idx = sketches.cms_indices(cfg.cms, flat_key)
            cms = sketches.cms_build_indices(cfg.cms, idx, valid.reshape(-1))
            tdist.all_reduce(cms, group=sh.group)
            s = sketches.cms_query_indices(cms, idx).reshape(valid.shape)
            right_cms, keep, dropped_sim = hdb.rough_classify(cfg, s, valid, psize)

        with record_function("hdb.exact"):
            # exact count: route the kept entries to key-owner shards. The
            # reference routes every lane with the dropped ones at owner
            # n_shards; they take no bucket rank, so routing only the kept
            # lanes, in order, fills the same buckets
            kept = torch.nonzero(keep.reshape(-1)).flatten()  # repro: noqa[R001] compacts the live entries
            kkey = flat_key[kept]
            rid = sh.shard * n_loc + kept // max(k, 1)
            owner = routing.owner_u64(kkey, n, routing.KEY_OWNER_SEED)
            cap = int(np.ceil(n_loc * k / n * dist.route_slack))
            bkey, (brid,), route_overflow = routing.route_buckets(
                kkey, [rid], owner, n, cap)
            bkey, brid = routing.exchange(sh.group, bkey, brid)

            # owner side: exact counts and fingerprints by one local sort
            fk, fr = bkey.reshape(-1), brid.reshape(-1)
            live = ~u64.is_sentinel(fk)
            skey, (srid,) = segments.sort_by_key(fk[live], [fr[live]])  # repro: noqa[R001] compacts the live entries
            sizes = segments.segment_counts(skey)
            xors = segments.segment_xor(skey, hashing.fingerprint_rid(srid))
            reps = segments.segment_starts(skey) & (sizes > cfg.max_block_size)

            # a Bloom filter of every over-sized key, OR-merged
            bloom = sketches.bloom_build(bloom_cfg, skey, reps)
            tdist.all_reduce(bloom, op=tdist.ReduceOp.MAX, group=sh.group)

            # dedupe: the first rcap representatives (key order) route by
            # membership fingerprint
            rep_pos = torch.nonzero(reps).flatten()  # repro: noqa[R001] representatives, capped on the host
            rep_overflow = max(rep_pos.shape[0] - rcap, 0)
            rep_pos = rep_pos[:rcap]
            r_x = xors[rep_pos]
            xowner = routing.owner_u64(r_x, n, routing.REP_OWNER_SEED)
            bx, (bsz, bk, blive), x_overflow = routing.route_buckets(
                r_x, [sizes[rep_pos], skey[rep_pos],
                      torch.ones_like(rep_pos, dtype=torch.int32)], xowner, n, xcap)
            bx, bsz, bk, blive = routing.exchange(sh.group, bx, bsz, bk, blive)
            got = blive.reshape(-1) > 0
            (t_k, t_sz), n_dup, survivor = hdb.dedupe_oversized_reps(
                bx.reshape(-1)[got], bsz.reshape(-1)[got], bk.reshape(-1)[got])  # repro: noqa[R001] compacts the received representatives

            # broadcast the survivor counts map: gather, then sort by key
            mine = ~u64.is_sentinel(t_k)
            table = gather_rows(sh, torch.stack([t_k[mine], t_sz[mine]], 1))
            t_key, order = u64.sort(table[:, 0])
            t_size = table[:, 1][order]

            # classify the kept local entries (Alg. 4 lines 9-19)
            in_bloom = sketches.bloom_query(bloom_cfg, bloom, kkey)
            hit, ex_size = segments.lookup_u64(t_key, t_size, kkey, 0)
            right_exact = torch.zeros(n_loc * k, dtype=torch.bool, device=dev)
            right_exact[kept] = ~in_bloom
            survive = torch.zeros_like(right_exact)
            survive[kept] = hit
            size = torch.zeros(n_loc * k, dtype=torch.int32, device=dev)
            size[kept] = ex_size.to(torch.int32)
            right_exact = right_exact.view(n_loc, k)
            survive = survive.view(n_loc, k)
            accepted = right_cms | right_exact

        with record_function("hdb.intersect"):
            new_key, new_valid, new_psize, n_dropped_mk = hdb.intersect_keys(
                cfg, keys, survive, size.view(n_loc, k))

        local = torch.stack([
            valid.sum(), right_cms.sum(), right_exact.sum(), dropped_sim.sum(),
            n_dropped_mk, n_dup, survivor.sum(), survive.sum(),
            route_overflow + x_overflow + rep_overflow]).to(torch.int64)
        tdist.all_reduce(local, group=sh.group)
        stats = dict(zip(_STATS, local.tolist()))  # repro: noqa[R001] IterationStats are host ints
        return accepted, (new_key, new_valid, new_psize), stats

    return step


def distributed_hashed_dynamic_blocking(
    keys: torch.Tensor, valid: torch.Tensor, cfg: HDBConfig, mesh,
    axis_names: Sequence[str] = ("data",),
    dist: DistConfig = DistConfig(),
    checkpoint_cb=None,
    start_iteration: int = 0,
    verbose: bool = False,
    device: DeviceLike = None,
) -> BlockingResult:
    """Multi-rank HDB loop (Algorithm 1) over ``make_hdb_step``.

    Every rank passes the same global ``(N, K)`` keys and valid mask (N a
    multiple of the shard count) and keeps its row slice on ``device``
    (``None`` means CUDA). Every rank returns the whole result.
    ``checkpoint_cb(iteration, state)`` gets the rank's local state after
    every iteration.
    """
    dev = resolve_device(device)
    step = make_hdb_step(cfg, mesh, axis_names, dist)
    sh = sharding.shards(mesh, axis_names)
    n = valid.shape[0]
    if n % sh.n_shards:
        raise ValueError(f"{n} records do not split over {sh.n_shards} shards: "
                         "pad them to a multiple")
    n_loc = n // sh.n_shards
    rows = slice(sh.shard * n_loc, (sh.shard + 1) * n_loc)
    keys = keys[rows].to(dev)
    valid = valid[rows].to(dev)
    psize = torch.full(valid.shape, INT32_MAX, dtype=torch.int32, device=dev)
    acc_rid: List[np.ndarray] = []
    acc_key: List[np.ndarray] = []
    all_stats: List[IterationStats] = []
    for it in range(start_iteration, cfg.max_iterations):
        accepted, (new_keys, new_valid, new_psize), stats = step(keys, valid, psize)
        with record_function("hdb.accept"):
            # the reference's np.nonzero over the global (N, K) array:
            # each shard's local nonzero, gathered in shard order
            ridx, kidx = torch.nonzero(accepted, as_tuple=True)  # repro: noqa[R001] accepted entries to the host BlockingResult
            acc = gather_rows(sh, torch.stack([ridx + sh.shard * n_loc,
                                               keys[ridx, kidx]], 1))
            acc_rid.append(acc[:, 0].cpu().numpy())  # repro: noqa[R001] accepted entries to the host BlockingResult
            acc_key.append(u64.to_numpy_u64(acc[:, 1]))
        st = IterationStats(iteration=it, **stats)
        all_stats.append(st)
        logger.log(logging.INFO if verbose else logging.DEBUG,
                   "[hdb-dist] iter=%d %s", it, st)
        if st.rep_overflow:
            warnings.warn(
                f"[hdb-dist] buffer overflow ({st.rep_overflow} entries "
                "dropped); raise DistConfig capacities",
                RepCapacityWarning, stacklevel=2)
        keys, valid, psize = new_keys, new_valid, new_psize
        if checkpoint_cb is not None:
            checkpoint_cb(it, {"keys": keys, "valid": valid, "psize": psize})
        if st.n_surviving_entries == 0:
            break
    key64 = np.concatenate(acc_key) if acc_key else np.zeros((0,), np.uint64)
    return BlockingResult(
        rids=np.concatenate(acc_rid) if acc_rid else np.zeros((0,), np.int64),
        key_hi=(key64 >> np.uint64(32)).astype(np.uint32),
        key_lo=(key64 & np.uint64(u64.MASK32)).astype(np.uint32),
        stats=all_stats,
        num_records=n,
    )


# ---------------------------------------------------------------------------
# Distributed pair materialization + fingerprint-routed dedupe (paper §3.1
# over the mesh)
# ---------------------------------------------------------------------------


def _pair_contract_reason(blocks: pairs_mod.Blocks, budget: int, per_round: int,
                          exact: bool) -> Optional[str]:
    """None if the routed distributed engine applies, else why not."""
    reason = pairs_mod._device_contract_ok(blocks, budget)
    if reason is not None:
        return reason
    if pairs_mod._sort_kind(blocks) != "radix":
        return (f"record ids >= 2**{pairs_kernels.PACK_RID_BITS} break the "
                "62-bit sort-word pack")
    if exact and blocks.num_pair_slots + per_round > INT32_MAX:
        # the reference's int32 per-shard slot offsets of the padded
        # final round would wrap
        return (f"slot space {blocks.num_pair_slots} + round {per_round} "
                "overflows int32 at the per-shard slot offsets")
    return None


def _shard_rounds(blocks: pairs_mod.Blocks, slots: Optional[torch.Tensor],
                  total: int, chunk: int, sh: sharding.Shards, dev: torch.device):
    """Yield this shard's decoded (a, b, src_size, valid) chunk of every
    round: slots ``[r0 + shard*chunk, r0 + (shard+1)*chunk)`` of the exact
    enumeration, or of the padded sample."""
    cum_d, start, size, members, steps = pairs_mod._device_csr(blocks, dev)
    per_round = sh.n_shards * chunk
    lo = sh.shard * chunk
    if slots is None:
        for r0 in range(0, total, per_round):
            yield pairs_kernels.decode_chunk(cum_d, start, size, members, r0 + lo,
                                             total, chunk=chunk, steps=steps)
        return
    # split int64 slots into (block, local) and pad to whole rounds
    m = slots.shape[0]
    padded = pairs_mod._round_up(m, per_round)
    block = torch.zeros(padded, dtype=torch.int64, device=dev)
    local = torch.zeros(padded, dtype=torch.int32, device=dev)
    valid = torch.zeros(padded, dtype=torch.bool, device=dev)
    block[:m] = torch.searchsorted(cum_d, slots, right=True) - 1
    local[:m] = (slots - cum_d[block[:m]]).to(torch.int32)
    valid[:m] = True
    for off in range(0, padded, per_round):
        sl = slice(off + lo, off + lo + chunk)
        yield pairs_kernels.decode_block_local(start, size, members, block[sl],
                                               local[sl], valid[sl], steps=steps)


def _pairset_from_words(words: torch.Tensor, exact: bool, total: int) -> pairs_mod.PairSet:
    a, b, s = pairs_kernels.unpack_words(words)
    host = tuple(x.cpu().numpy() for x in (a, b, s))  # repro: noqa[R001] the PairSet is host numpy
    return pairs_mod.PairSet(*host, exact, total, device_a=a.to(torch.int32),
                             device_b=b.to(torch.int32))


def dedupe_pairs_distributed(
    blocks: pairs_mod.Blocks, mesh=None, axis_names: Sequence[str] = ("data",),
    budget: int = 50_000_000, chunk_per_shard: int = 1 << 18,
    route_slack: float = 2.0, sample_seed: int = 0, device: DeviceLike = None,
) -> pairs_mod.PairSet:
    """Fingerprint-routed distributed pair dedupe (no global sort).

    Every shard decodes its slice of each round of the canonical slot
    space (or of the seeded global sample, drawn identically on every
    rank), packs the pairs into sort words and routes each to
    ``pair_route_owner`` with one exchange a round. All occurrences of a
    pair meet on one shard, so the largest-block-wins dedupe (the radix
    sort) runs shard-locally; the disjoint winner sets are gathered and
    sorted into the canonical (a, b) order. The PairSet equals the
    single-device ``dedupe_pairs``'s. A bucket overflow beyond
    ``route_slack`` warns and returns the single-device result;
    ``mesh=None`` is a one-dim mesh over the default process group.
    """
    dev = resolve_device(device)
    if mesh is None:
        mesh, axis_names = default_mesh(dev), ("data",)
    sh = sharding.shards(mesh, axis_names)
    n = sh.n_shards
    total = blocks.num_pair_slots
    exact = total <= budget
    # the seeded global sample every backend draws, drawn up front so the
    # chunk clamp below sees the real workload
    slots = None if exact else pairs_mod._sample_slots(total, budget, sample_seed, dev)
    workload = total if exact else slots.shape[0]
    if total > 0 and workload == 0:
        return pairs_mod._empty_pairset(False, total)
    chunk = min(chunk_per_shard, pairs_mod._round_up(max(1, -(-workload // n)), 1024))
    per_round = n * chunk
    reason = _pair_contract_reason(blocks, budget, per_round, exact)
    if total == 0 or reason is not None:
        if reason is not None:
            warnings.warn(f"routed distributed pairs unavailable ({reason}); "
                          "using the single-device engine", RuntimeWarning, stacklevel=2)
        return pairs_mod.dedupe_pairs(blocks, budget=budget, sample_seed=sample_seed,
                                      device=dev)

    cap = int(np.ceil(chunk / n * route_slack))
    received = []
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    with record_function("pairs.route"):
        for a, b, s, v in _shard_rounds(blocks, slots, total, chunk, sh, dev):
            owner = pairs_kernels.pair_route_owner(a, b, v, n)
            bw, _, ovf = routing.route_buckets(
                pairs_kernels.pack_sort_words(a, b, s, v), [], owner, n, cap)
            received.append(routing.exchange(sh.group, bw)[0].reshape(-1))
            overflow += ovf
        # one deferred sync: the fallback discards the buckets anyway
        tdist.all_reduce(overflow, group=sh.group)
    if int(overflow):  # repro: noqa[R001] an overflow picks the fallback
        warnings.warn(
            f"routed pair dedupe overflowed a bucket (cap {cap}, slack "
            f"{route_slack}); falling back to the single-device engine — "
            "raise route_slack to keep the routed path",
            RepCapacityWarning, stacklevel=2)
        return pairs_mod.dedupe_pairs(blocks, budget=budget, sample_seed=sample_seed,
                                      device=dev)

    n_passes = pairs_kernels.radix_passes_for(int(blocks.members.max()))
    with record_function("pairs.sort"):
        # sentinel lanes never win: sort only the pairs this shard received
        words = torch.cat(received)
        sw, winner = pairs_kernels.dedupe_packed_device(
            words[~u64.is_sentinel(words)], "radix", n_passes)  # repro: noqa[R001] drops the sentinel lanes
        # shard winner sets are disjoint: one sort of the gathered winners
        # restores the canonical global (a, b) order
        words = sort_ops.sort_words(gather_rows(sh, sw[winner]), backend="radix",  # repro: noqa[R001] compacts the winners
                                    n_passes=n_passes)
    return _pairset_from_words(words, exact, total)


def materialize_pairs_distributed(
    blocks: pairs_mod.Blocks, mesh=None, axis_names: Sequence[str] = ("data",),
    budget: int = 50_000_000, chunk_per_shard: int = 1 << 18,
    sample_seed: int = 0, dedupe: str = "routed", route_slack: float = 2.0,
    device: DeviceLike = None,
) -> pairs_mod.PairSet:
    """Shard pair-slot decoding over the mesh and dedupe the result.

    ``dedupe="routed"`` is ``dedupe_pairs_distributed``; ``"global"``
    gathers every shard's decoded pairs and runs one sort-dedupe over the
    whole buffer (the reference's baseline). Both equal the single-device
    engine.
    """
    if dedupe == "routed":
        return dedupe_pairs_distributed(
            blocks, mesh, axis_names, budget=budget, chunk_per_shard=chunk_per_shard,
            route_slack=route_slack, sample_seed=sample_seed, device=device)
    if dedupe != "global":
        raise ValueError(f"dedupe must be 'routed' or 'global', got {dedupe!r}")
    dev = resolve_device(device)
    if mesh is None:
        mesh, axis_names = default_mesh(dev), ("data",)
    sh = sharding.shards(mesh, axis_names)
    chunk = chunk_per_shard
    total = blocks.num_pair_slots
    reason = pairs_mod._device_contract_ok(blocks, budget)
    if reason is None and total + sh.n_shards * chunk > INT32_MAX:
        reason = f"slot space {total} + round {sh.n_shards * chunk} overflows int32"
    if total == 0 or total > budget or reason is not None:
        if reason is not None:
            warnings.warn(f"distributed pairs unavailable ({reason}); "
                          "using the single-device engine", RuntimeWarning, stacklevel=2)
        return pairs_mod.dedupe_pairs(blocks, budget=budget, sample_seed=sample_seed,
                                      device=dev)

    outs = [[], [], [], []]
    for part in _shard_rounds(blocks, None, total, chunk, sh, dev):
        for o, x in zip(outs, part):
            got = torch.empty(sh.n_shards * chunk, dtype=torch.int32, device=dev)
            tdist.all_gather_into_tensor(got, x.to(torch.int32).contiguous(),
                                         group=sh.group)
            o.append(got)
    a, b, s, v = (torch.cat(o) for o in outs)
    n_passes = pairs_kernels.radix_passes_for(
        int(blocks.members.max()) if len(blocks.members) else 0)
    sa, sb, ss, winner = pairs_kernels.dedupe_device(
        a, b, s, v.to(torch.bool), sort_backend=pairs_mod._sort_kind(blocks),
        n_passes=n_passes)
    wa, wb, ws = sa[winner], sb[winner], ss[winner]
    host = tuple(x.cpu().numpy().astype(np.int64) for x in (wa, wb, ws))
    return pairs_mod.PairSet(*host, True, total, device_a=wa.to(torch.int32),
                             device_b=wb.to(torch.int32))
