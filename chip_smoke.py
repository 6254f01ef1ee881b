#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own failure):

1. card and build: the card's name and power limit, then an nvcc build
   of every kernel under src/repro_torch/csrc/ for sm_90a;
2. the smoke config (150 entities) through dedup_corpus on cuda and on
   cpu, for blocker="hdb" and blocker="threshold": labels, survivors and
   counts must be equal;
3. the SYN1M corpus (400k entities, about 750k records; max_block_size
   200) through dedup_corpus on cuda:
   - a counted HDB run, with every kernel's launch count zeroed just
     before and read just after; each of the eight kernels must launch
     (the seven TPU kernels' ports, the radix sort being two: its digit
     counts and its pass);
   - a recorded HDB run that keeps the arguments of the kernel launches
     (every launch of tri-decode, the radix sort pass and match; of
     the radix digit counts, mix64, combine64, minhash and cms, each
     launch is held against its plain version as it happens and only
     the largest is kept);
   - a counted blocker="threshold" run, and the naive pair count of the
     SYN1M keys (the paper's Table 3 "Naive" column);
   - a run under torch.profiler for the stage breakdown and the device
     idle share;
4. each kernel against its plain PyTorch version on the card, on the
   inputs the SYN1M main path gave it, held bit-identical (tolerance:
   exact equality), timed beside the plain version, the library call
   where one exists, and the bound: ``ms`` is the device time of the
   kernels a call launches (torch.profiler, mean of 10 calls),
   ``call_ms`` the time per call from CUDA events around back-to-back
   calls (host gaps included). The radix sort is also held against
   torch.sort at every pass count 4..16, on the SYN1M pair words and on
   adversarial words, and timed as a whole sort (``sort_ms``);
5. streaming (``repro_torch.streaming``):
   a. the smoke config ingested in 3 parts through StreamingEngine (fused
      matcher, one query) and DedupPipeline.extend (both match back ends)
      on cuda and on cpu: ledger, probes, matched pairs and labels equal;
   b. STREAM100K, the acceptance workload of benchmarks/bench_streaming.py
      (a 100,000-record store, 1,000-record deltas, max_block_size 64):
      the base build, a warm delta and a timed delta (launch counts zeroed
      just before and read just after) beside the full re-block by the
      batch port, which the store must equal; the timed delta replayed on
      a store built the same way with every launch held against its plain
      version as it happens; a third delta profiled;
   c. the SYN stream: the SYN1M spec at SYN_STREAM_ENTITIES in a seeded
      arrival order through DedupPipeline.extend (a base, then ten 1%
      deltas, the last profiled); every kernel must launch; the base and
      the deltas are replayed on a twin pipeline with every launch held
      against its plain version as it happens (same counts, same last
      report); and the last report must equal dedup_corpus on the same
      rows with an exact pair budget;
   d. the sharded store: the smoke config in 3 parts through
      StreamingEngine(n_shards=n) for n in 1, 4, 8 on cuda, every launch
      held against its plain version, equal to the n_shards=1 (BlockStore)
      run and to the cpu run (every ingest report, the ledger, the
      candidate pairs, matched pairs, probes); STREAM100K's base and two
      deltas through ShardedBlockStore(n_shards=4) on cuda (the last delta
      timed, launch counts zeroed just before and read just after), equal
      to phase 5b's single store;
6. table2: paper Table 2 as benchmarks/bench_table2.py runs it
   (max_block_size 200, the default MetaBlockingConfig, the corpus's
   labelled pairs): THR, PMB and HDB through metrics.evaluate, each
   method's blocking timed with the card synchronised on both sides. SYN10K
   (4,000 entities, seed 1) on cuda, again on cuda with every launch held
   against its plain version, and on cpu: the metrics must be equal field
   for field. SYN1M (phase 3's corpus and keys) on cuda, launch counts
   zeroed just before and read just after; a PMB over its edge budget is
   recorded as the bench records it.

The line before the last is a JSON object with one entry per kernel
(``launches`` from the SYN1M HDB run; ``stream100k_delta_launches``,
``syn_stream_launches`` and ``sharded_delta_launches`` from phase 5,
``table2_syn1m_launches`` from phase 6); the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or
without the rest of the repository beside it, the script exits non-zero.
"""
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks: HBM3 bytes/s, and the float32 rate outside
# the tensor cores, which counts an FMA as two operations (132 SMs x 128
# lanes x 2 x 1.98 GHz)
HBM_BYTES_PER_S = 3.35e12
VECTOR_OPS_PER_S = 67e12
# integer (and other non-FMA) work: one instruction a scheduler a clock,
# 132 SMs x 4 schedulers x 32 lanes x 1.98 GHz = 33.5e12 32-bit
# lane-operations a second
INT_OPS_PER_S = 132 * 128 * 1.98e9
# 32-bit operations a key. A 64-bit xor-shift is 4 (a funnel shift and a
# shift for the two words, two xors), a 64-bit multiply 3 (IMAD.WIDE.U32
# and two IMAD), a 64-bit add, xor, compare, select or rotate 2.
# splitmix64 is three xor-shifts and two multiplies; combine64 adds the
# order compare, two selects, the rotate, the xor, the add and a second
# mix; a MinHash evaluation is the add, the chain with only the low word
# of the last xor-shift (2), and the running minimum (1)
MIX64_OPS = 3 * 4 + 2 * 3
COMBINE64_OPS = 2 * MIX64_OPS + 6 * 2
MINHASH_OPS = 2 + 4 + 3 + 4 + 3 + 2 + 1
# tri-decode, in uint32: a search step is the midpoint (an add and a
# halving), mid - 1, the two row products, their halving and difference,
# the compare and two selects; the fixed part is n - 1, the start of hi
# (a compare, a subtraction and a select), the final row's cum (5) and j (2)
TRI_STEP_OPS = 10
TRI_FIXED_OPS = 1 + 3 + 5 + 2
# match: a merge step is a compare and an advance; a record column's valid
# count is a popcount of a shifted, masked 64-bit mask word, done once a
# record; a pair column's integer term is the union (an add and a
# subtraction), its float terms the divide, the weighted multiply and add,
# and the norm's add
MATCH_STEP_OPS = 2
MATCH_RECORD_COLUMN_OPS = 7
MATCH_COLUMN_OPS = 2
MATCH_COLUMN_FLOPS = 4
REPS = 10
SYN1M_ENTITIES = 400_000
# STREAM100K, the streaming acceptance workload of benchmarks/bench_streaming.py:
# a 100,000-record store absorbing 1% deltas
STREAM_RECORDS = 100_000
STREAM_DELTA = 1_000
# the SYN stream: the SYN1M spec arriving in a seeded order, a base then
# SYN_STREAM_DELTAS deltas of 1% each through DedupPipeline.extend. Cut
# from SYN1M's 400,000 entities: at 200,000 one 1% delta took 54 s of host
# time on an H100 (PERF.md section 4)
SYN_STREAM_ENTITIES = 100_000
SYN_STREAM_DELTAS = 10
# lanes of the tri-decode check at block sizes the SYN1M path does not reach
TRI_EXTREME_SLOTS = 1 << 20


RANGE_PREFIXES = ("dedup.", "hdb.", "pairs.", "stream.")


def _kernel_events(prof):
    """The profiler's device-side events (kernels, copies, memsets), not
    the device-side spans of record_function ranges."""
    from torch.autograd import DeviceType
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith(RANGE_PREFIXES)]


def device_ms(fn, reps=REPS):
    """Device milliseconds per call of ``fn``: the summed duration of the
    kernels it launches (torch.profiler), without host launch gaps.

    Every call launches the same kernels, so an event count that is no
    multiple of the calls means the profiler lost events (it has, on
    calls of hundreds of kernels): the window is measured again, and the
    third that still loses events raises."""
    from torch.profiler import ProfilerActivity, profile
    attempts = 3
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = _kernel_events(prof)
        if events and len(events) % reps == 0:
            return sum(e.time_range.elapsed_us() for e in events) / reps / 1e3
    raise AssertionError(f"profiler saw {len(events)} device events over "
                         f"{reps} calls, {attempts} times")


def call_ms(fn, reps=REPS, inner=10):
    """Milliseconds per call of ``fn`` from CUDA events around ``inner``
    back-to-back calls (median of ``reps``), host launch gaps included."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def timings(kernel, plain, library=None):
    """The timing keys of one kernel's JSON entry."""
    return {"ms": device_ms(kernel), "plain_ms": device_ms(plain),
            "library_ms": None if library is None else device_ms(library),
            "call_ms": call_ms(kernel)}


def bound(bytes_moved, ops, flops=0):
    """Least time in ms: the larger of the byte time and the operation
    time (32-bit integer operations at INT_OPS_PER_S, float32 ones at
    VECTOR_OPS_PER_S)."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = (ops / INT_OPS_PER_S + flops / VECTOR_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(pairs):
    return max(float((x.double() - y.double()).abs().max()) if x.numel() else 0.0
               for x, y in pairs)


def assert_equal(name, pairs):
    for k, (x, y) in enumerate(pairs):
        if not torch.equal(x, y):
            raise AssertionError(f"{name}: output {k} differs from the plain version")


def check_tri_decode(calls):
    """Every main-path launch against the plain version, then block sizes
    up to MAX_BLOCK_N (the uint32 row products); the first launch, a
    full chunk, is timed."""
    from repro_torch.kernels.pairs import tri as td
    errs = []
    for local, size, steps in calls:
        got = td.tri_decode(local, size, steps)
        want = td.tri_decode_torch(local, size, steps)
        assert_equal("tri_decode", zip(got, want))
        errs.append(max_abs_err(zip(got, want)))
        n = size.long()
        live = (n >= 2) & (local >= 0) & (local.long() < n * (n - 1) // 2)
        i, j, n, t = got[0].long()[live], got[1].long()[live], n[live], local.long()[live]
        if not (bool((j > i).all()) and bool((j < n).all())
                and torch.equal(i * (n - 1) - i * (i - 1) // 2 + j - i - 1, t)):
            raise AssertionError("tri_decode: (i, j) do not invert the slot index")
    rng = np.random.default_rng(11)
    count = TRI_EXTREME_SLOTS
    n = rng.integers(2, td.MAX_BLOCK_N + 1, count)
    n[:4] = [2, 3, td.MAX_BLOCK_N, td.MAX_BLOCK_N]
    t = (rng.random(count) * (n * (n - 1) // 2)).astype(np.int64)
    t[3] = td.MAX_BLOCK_N * (td.MAX_BLOCK_N - 1) // 2 - 1
    ext = (torch.from_numpy(t.astype(np.int32)).cuda(),
           torch.from_numpy(n.astype(np.int32)).cuda(), td.MAX_SEARCH_STEPS)
    assert_equal("tri_decode (block sizes to MAX_BLOCK_N)",
                 zip(td.tri_decode(*ext), td.tri_decode_torch(*ext)))
    local, size, steps = calls[0]
    count = local.numel()
    b_ms, b_by = bound(16 * count, count * (TRI_STEP_OPS * steps + TRI_FIXED_OPS))
    return {"name": "tri_decode", "route": "cuda",
            "source": "src/repro_torch/csrc/tri_decode.cu",
            "replaces": "src/repro/kernels/pairs/pairs.py:61",
            "max_abs_err": max(errs),
            **timings(lambda: td.tri_decode(local, size, steps),
                      lambda: td.tri_decode_torch(local, size, steps)),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"{len(calls)} launches, timed: {count} slots, steps={steps}"}


def adversarial_words(count):
    """Words that stress the sort's ranks and look-back: one digit value
    everywhere, all sentinels, already sorted, reversed, and a size that is
    not a whole number of tiles."""
    rng = np.random.default_rng(13)
    rand = rng.integers(-(1 << 63), (1 << 63) - 1, count, dtype=np.int64)
    rand[::9] = -1
    ordered = np.sort(rand.view(np.uint64)).view(np.int64)
    return {"one digit": np.full(count, 0x5A5A5A5A5A5A5A5A, np.int64),
            "sentinels": np.full(count, -1, np.int64),
            "sorted": ordered, "reversed": ordered[::-1].copy(),
            "ragged": rand[: count - 4096 + 17]}


def check_sort_at_every_pass_count(name, words):
    """sort_words(backend="radix") against torch.sort at n_passes 4..16."""
    from repro_torch.core import u64
    from repro_torch.kernels.sort import ops as sort_ops
    from repro_torch.kernels.sort import radix
    for n_passes in range(sort_ops.MIN_PASSES, radix.MAX_PASSES + 1):
        got = sort_ops.sort_words(words, backend="radix", n_passes=n_passes)
        if n_passes == radix.MAX_PASSES:
            want = u64.flip(torch.sort(u64.flip(words), stable=True)[0])
        else:
            # digits at and above n_passes are never compared: a stable
            # sort by the low bits (the sentinel's are all ones, so it is last)
            low = words & ((1 << (4 * n_passes)) - 1)
            want = words[torch.sort(low, stable=True)[1]]
        if not torch.equal(got, want):
            raise AssertionError(f"radix sort of {name} words, n_passes="
                                 f"{n_passes}, differs from torch.sort")


def check_radix(calls):
    """Every main-path pass against the plain version; the sort of the
    first pass's words (the packed pair words) and of adversarial words at
    every pass count against torch.sort; the first pass and the main
    path's whole sort are timed."""
    from repro_torch.core import u64
    from repro_torch.kernels.sort import ops as sort_ops
    from repro_torch.kernels.sort import radix
    errs = []
    for args in calls:
        w, q, bits = args[:3]
        got = radix.sort_pass(*args)
        want = radix.sort_pass_torch(w, q, bits)
        assert_equal(f"sort_pass q={q} bits={bits}", [(got, want)])
        errs.append(max_abs_err([(got, want)]))
        del got, want
    words, q0, bits0, totals0 = calls[0]
    count = words.numel()
    check_sort_at_every_pass_count("SYN1M pair", words)
    for name, w in adversarial_words(1 << 20).items():
        check_sort_at_every_pass_count(name, torch.from_numpy(w).cuda())
    n_passes = sum(c[2] for c in calls) // radix.RADIX_BITS
    b_ms, b_by = bound(16 * count + 4 * radix.RADIX, 10 * count)
    # the radix algorithm's least bytes: one read for the digit counts,
    # then a read and a write a pass
    sort_bound_ms, _ = bound((8 + 16 * len(calls)) * count, 0)
    flipped = u64.flip(words)
    sentinels = int(u64.is_sentinel(words).sum())
    return {"name": "radix_sort", "route": "cuda",
            "source": "src/repro_torch/csrc/radix_sort.cu",
            "replaces": "src/repro/kernels/sort/sort.py:71",
            "max_abs_err": max(errs),
            # library_ms: one PyTorch call sorting the same words; it is a
            # full sort, so compare it with sort_ms (the main path's whole
            # sort: the digit counts and every pass)
            **timings(lambda: radix.sort_pass(words, q0, bits0, totals0),
                      lambda: radix.sort_pass_torch(words, q0, bits0),
                      lambda: torch.sort(flipped, stable=True)),
            "sort_ms": device_ms(lambda: sort_ops.sort_words(
                words, backend="radix", n_passes=n_passes)),
            "sort_call_ms": call_ms(lambda: sort_ops.sort_words(
                words, backend="radix", n_passes=n_passes)),
            "sort_bound_ms": sort_bound_ms,
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"{len(calls)} 8-bit passes (n_passes={n_passes}) of "
                     f"{count} words ({sentinels} sentinels), timed: one pass; "
                     f"sort_ms is the whole sort"}


def check_digit_counts(rec):
    from repro_torch.kernels.sort import radix
    words, n_digits, last_bits = rec["args"]
    n = words.numel()
    return {"name": "radix_digit_counts", "route": "cuda",
            "source": "src/repro_torch/csrc/radix_sort.cu",
            "replaces": "src/repro/kernels/sort/sort.py:71",
            **check_recorded(rec, lambda: radix.digit_counts(words, n_digits, last_bits),
                             lambda: radix.digit_counts_torch(words, n_digits, last_bits),
                             8 * n + 4 * n_digits * radix.RADIX, 3 * n_digits * n),
            "shape": f"{rec['launches']} launches checked, timed: {n} words, "
                     f"{n_digits} digit positions"}


def check_match(calls):
    """The main path's one launch against the plain version, timed."""
    from repro_torch.kernels.match import match as mk
    (args,) = calls
    tok, msk, col_off, weights, aa, bb, valid, threshold = args
    got = mk.match_tiles(*args)
    want = mk.match_tiles_torch(*args)
    torch.cuda.synchronize()
    assert_equal("match", zip(got, want))
    count = aa.numel()
    n_matched = int(got[0].sum())
    if not 0 < n_matched < count:
        raise AssertionError(f"match: {n_matched} of {count} pairs matched")
    rows = int(torch.unique(torch.cat([aa, bb])).numel())
    widths = np.diff(col_off)
    bytes_moved = count * (4 + 4 + 1 + 4 + 4) + (count // mk.LANES) * 4 \
        + rows * int(col_off[-1]) * 5
    # the operations this run's data needs: in each column where both rows
    # have valid slots, a merge of the two sorted valid runs (at most
    # na + nb - 1 steps of a compare and an advance), then the column's
    # score terms; each record column's valid count once
    n_valid = torch.stack([msk[:, lo:hi].sum(1) for lo, hi
                           in zip(col_off[:-1], col_off[1:])], 1)
    live = valid.bool()
    na, nb = n_valid[aa[live].long()], n_valid[bb[live].long()]
    steps = int(torch.where((na > 0) & (nb > 0), na + nb - 1, 0).sum())
    columns = int(live.sum()) * len(widths)
    b_ms, b_by = bound(bytes_moved, MATCH_STEP_OPS * steps + MATCH_COLUMN_OPS * columns
                       + MATCH_RECORD_COLUMN_OPS * rows * len(widths),
                       MATCH_COLUMN_FLOPS * columns)
    err = max_abs_err(zip(got, want))
    del got, want
    return {"name": "match", "route": "cuda",
            "source": "src/repro_torch/csrc/match.cu",
            "replaces": "src/repro/kernels/match/match.py:83",
            "max_abs_err": err,
            **timings(lambda: mk.match_tiles(*args),
                      lambda: mk.match_tiles_torch(*args)),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"{count} lanes, {n_matched} matched, {rows} distinct "
                     f"records, T={widths.tolist()}"}


def check_recorded(rec, kernel, plain, bytes_moved, ops, library=None):
    """The timing, bound and error keys of a kernel checked in the recorder
    (every launch already held against its plain version there); the
    largest launch is timed."""
    b_ms, b_by = bound(bytes_moved, ops)
    # every launch was torch.equal to its plain version in the recorder
    return {"max_abs_err": 0.0, **timings(kernel, plain, library),
            "bound_ms": b_ms, "bound_by": b_by}


def check_mix64(rec):
    from repro_torch.kernels.hash64 import hash64
    (x,) = rec["args"]
    n = x.numel()
    return {"name": "mix64", "route": "cuda",
            "source": "src/repro_torch/csrc/hash64.cu",
            "replaces": "src/repro/kernels/hash64/hash64.py:62",
            **check_recorded(rec, lambda: hash64.mix64_bulk(x),
                             lambda: hash64.mix64_torch(x), 16 * n, MIX64_OPS * n),
            "shape": f"{rec['launches']} launches checked, timed: {n} keys"}


def check_combine64(rec):
    from repro_torch.kernels.hash64 import hash64
    a, b = rec["args"]
    n = a.numel()
    return {"name": "combine64", "route": "cuda",
            "source": "src/repro_torch/csrc/hash64.cu",
            "replaces": "src/repro/kernels/hash64/hash64.py:55",
            **check_recorded(rec, lambda: hash64.combine64(a, b),
                             lambda: hash64.combine64_torch(a, b),
                             24 * n, COMBINE64_OPS * n),
            "shape": f"{rec['launches']} launches checked, timed: "
                     f"{tuple(a.shape)} key pairs"}


def off_alignment(x):
    """A copy of ``x`` whose data starts one element past a 16-byte
    boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x.reshape(-1)
    return flat[1:].view(x.shape)


def check_minhash(rec):
    """The largest launch is timed; the largest at each token width is
    also timed as given and from a copy off its 16-byte alignment, which
    takes the kernel's generic loop, held equal to the aligned result."""
    from repro_torch.kernels.minhash import minhash
    by_width = {}
    for t, (args, _) in sorted(rec["by_width"].items()):
        tok, mask, m, seed = args
        odd_tok, odd_mask = off_alignment(tok), off_alignment(mask)
        assert_equal(f"minhash T={t} off alignment",
                     [(minhash.minhash(odd_tok, odd_mask, m, seed),
                       minhash.minhash(tok, mask, m, seed))])
        by_width[str(t)] = {
            "rows": tok.shape[0], "valid": int(mask.sum()),
            "ms": device_ms(lambda: minhash.minhash(tok, mask, m, seed)),
            "unaligned_ms": device_ms(lambda: minhash.minhash(odd_tok, odd_mask, m, seed))}
        del odd_tok, odd_mask
    tok, mask, m, seed = rec["args"]
    r, t = tok.shape
    # only valid tokens need reading and hashing; the mask is read whole
    live = int(mask.sum())
    return {"name": "minhash", "route": "cuda",
            "source": "src/repro_torch/csrc/minhash.cu",
            "replaces": "src/repro/kernels/minhash/minhash.py:65",
            **check_recorded(rec, lambda: minhash.minhash(tok, mask, m, seed),
                             lambda: minhash.minhash_torch(tok, mask, m, seed),
                             r * t + live * 8 + r * m * 8, live * m * MINHASH_OPS),
            "by_width": by_width,
            "shape": f"{rec['launches']} launches checked, timed: R={r} T={t} "
                     f"M={m} ({live} valid tokens)"}


def check_cms(rec):
    from repro_torch.kernels.cms import cms
    idx, mask, width = rec["args"]
    depth, n = idx.shape
    # only live entries' indices need reading; the mask is read whole and
    # the sketch written once
    live = int(mask.sum())
    # library_ms: one scatter_add_ into the zeroed, flattened sketch; the
    # offset indices and the int32 update are built outside the timed call
    flat = torch.zeros(depth * width, dtype=torch.int32, device=idx.device)
    offsets = torch.arange(depth, dtype=torch.int64, device=idx.device) * width
    flat_idx = (idx.long() + offsets[:, None]).reshape(-1)
    upd = mask.to(torch.int32).repeat(depth)
    # the dead entries' adds of zero: how many land on each row's most
    # common dead bucket (the one scatter_add_ serialises on it)
    dead = idx[:, ~mask]
    crowd = max((int(torch.unique(row, return_counts=True)[1].max())
                 for row in dead if row.numel()), default=0)
    del dead

    def compact_scatter():
        # the same function from PyTorch calls that skip the dead entries:
        # the live entries compacted, then one scatter_add_ into a zeroed sketch
        sel = (idx[:, mask.nonzero().squeeze(1)].long() + offsets[:, None]).reshape(-1)
        return torch.zeros(depth * width, dtype=torch.int32, device=idx.device) \
            .scatter_add_(0, sel, torch.ones_like(sel, dtype=torch.int32))

    assert_equal("cms compact + scatter_add_",
                 [(compact_scatter().view(depth, width), cms.cms_update(idx, mask, width))])
    return {"name": "cms_update", "route": "cuda",
            "source": "src/repro_torch/csrc/cms.cu",
            "replaces": "src/repro/kernels/cms/cms.py:42",
            **check_recorded(rec, lambda: cms.cms_update(idx, mask, width),
                             lambda: cms.cms_update_torch(idx, mask, width),
                             depth * live * 4 + n + depth * width * 4,
                             depth * live,
                             lambda: flat.scatter_add_(0, flat_idx, upd)),
            "compact_scatter_ms": device_ms(compact_scatter),
            "shape": f"{rec['launches']} launches checked, timed: depth={depth} "
                     f"N={n} width={width} ({live} live; {crowd} dead entries "
                     f"in a row's most common dead bucket)"}


def launch_sites():
    """name: (module the main path calls the wrapper through, wrapper name,
    plain version with the wrapper's arguments)."""
    from repro_torch.kernels.cms import cms, ops as cms_ops
    from repro_torch.kernels.hash64 import hash64, ops as hash64_ops
    from repro_torch.kernels.match import match as mk, ops as match_ops
    from repro_torch.kernels.minhash import minhash, ops as minhash_ops
    from repro_torch.kernels.pairs import ops as pair_ops, tri as td
    from repro_torch.kernels.sort import ops as sort_ops
    from repro_torch.kernels.sort import radix
    return {"tri_decode": (pair_ops, "tri_decode", td.tri_decode_torch),
            "radix_sort": (sort_ops, "sort_pass",
                           lambda w, q, bits, totals: radix.sort_pass_torch(w, q, bits)),
            "radix_digit_counts": (sort_ops, "digit_counts", radix.digit_counts_torch),
            "match": (match_ops, "match_tiles", mk.match_tiles_torch),
            "mix64": (hash64_ops, "mix64_bulk", hash64.mix64_torch),
            "combine64": (hash64_ops, "combine64", hash64.combine64_torch),
            "minhash": (minhash_ops, "minhash", minhash.minhash_torch),
            "cms_update": (cms_ops, "cms_update", cms.cms_update_torch)}


# kernels whose every main-path launch record_launches keeps for phase 4
RECORDED = ("tri_decode", "radix_sort", "match")


def equal_outputs(out, want):
    if isinstance(out, tuple):
        return all(torch.equal(x, y) for x, y in zip(out, want))
    return torch.equal(out, want)


def wrap_launches(run, kernels, on_launch):
    """Run ``run`` with each kernel wrapper wrapped where the main path
    calls it; ``on_launch(name, args, out)`` sees every call that launched
    the kernel (calls that took no launch, such as empty inputs, pass)."""
    sites = launch_sites()
    by_name = {k.name: k for k in kernels}
    original = {name: getattr(mod, attr) for name, (mod, attr, _) in sites.items()}

    def wrapper(name):
        def call(*args):
            before = by_name[name].launches
            out = original[name](*args)
            if by_name[name].launches != before:
                on_launch(name, args, out)
            return out
        return call

    for name, (mod, attr, _) in sites.items():
        setattr(mod, attr, wrapper(name))
    try:
        run()
    finally:
        for name, (mod, attr, _) in sites.items():
            setattr(mod, attr, original[name])


def record_launches(run, kernels):
    """Run ``run`` with each kernel wrapper wrapped where the main path
    calls it. Returns {kernel name: record}: for tri_decode, radix_sort and
    match the positional arguments of every launch; for radix_digit_counts,
    mix64, combine64, minhash and cms_update (whose launches over up to 90M
    keys would not all fit on the card) a dict with the launch count and the arguments
    of the largest launch, after every launch was held equal to its plain
    version as it happened."""
    sites = launch_sites()
    calls = {name: [] if name in RECORDED else {"launches": 0, "args": None, "size": -1}
             for name in sites}

    def on_launch(name, args, out):
        if name in RECORDED:
            calls[name].append(args)
            return
        if not equal_outputs(out, sites[name][2](*args)):
            raise AssertionError(f"{name}: a main-path launch differs "
                                 "from the plain version")
        rec = calls[name]
        rec["launches"] += 1
        if args[0].numel() > rec["size"]:
            rec["args"], rec["size"] = args, args[0].numel()
        if name == "minhash":
            # the largest launch at each token width is timed
            wide = rec.setdefault("by_width", {})
            t = args[0].shape[1]
            if args[0].numel() > wide.get(t, (None, -1))[1]:
                wide[t] = (args, args[0].numel())

    wrap_launches(run, kernels, on_launch)
    return calls


def check_launches(run, kernels):
    """Run ``run`` holding every kernel launch against its plain version as
    it happens (tolerance: exact equality). Returns the launch counts."""
    sites = launch_sites()
    counts = {name: 0 for name in sites}

    def on_launch(name, args, out):
        if not equal_outputs(out, sites[name][2](*args)):
            raise AssertionError(f"{name}: a launch differs from the plain version")
        counts[name] += 1

    wrap_launches(run, kernels, on_launch)
    return counts


def smoke_pipeline():
    from repro_torch.core import hdb
    from repro_torch.data import pipeline, synthetic
    spec = synthetic.SyntheticSpec(num_entities=150, seed=7)
    cfg = hdb.HDBConfig(max_block_size=50, max_iterations=6, cms_width=1 << 12)
    for blocker in ("hdb", "threshold"):
        reps = {dev: pipeline.dedup_corpus(synthetic.generate(spec, device=dev),
                                           cfg, blocker=blocker, device=dev)
                for dev in ("cuda", "cpu")}
        gpu, cpu = reps["cuda"], reps["cpu"]
        for field in ("num_candidate_pairs", "num_matched_pairs", "num_components"):
            if getattr(gpu, field) != getattr(cpu, field):
                raise AssertionError(f"smoke {blocker}: {field} differs cuda vs cpu")
        if not (np.array_equal(gpu.component_of, cpu.component_of)
                and np.array_equal(gpu.survivors, cpu.survivors)):
            raise AssertionError(f"smoke {blocker}: labels or survivors differ "
                                 "cuda vs cpu")
        print(f"smoke {blocker}: {gpu.num_records} records, "
              f"{gpu.num_candidate_pairs} pairs, {gpu.num_matched_pairs} matched, "
              f"{gpu.num_components} components (cuda == cpu)", flush=True)


def profile_breakdown(run, tag="SYN1M"):
    """Run ``run`` under torch.profiler; print the stage ranges, the
    device's busy time and idle share of the wall time, the top device
    kernels and the top host ops, each line marked with ``tag``. Returns
    (run's result, wall seconds)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = {}
    for e in _kernel_events(prof):
        calls, us = kernels.get(e.name, (0, 0.0))
        kernels[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in kernels.values()) / 1e6
    print(f"profile {tag}: wall_s={wall:.3f} device_busy_s={busy:.3f} "
          f"device_idle_share={1 - busy / wall:.4f}", flush=True)
    events = prof.key_averages()
    for e in sorted(events, key=lambda e: e.key):
        if e.key.startswith(RANGE_PREFIXES) and e.cpu_time_total:
            print(f"profile {tag} range {e.key}: calls={e.count} "
                  f"host_s={e.cpu_time_total / 1e6:.3f}", flush=True)
    for name, (calls, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"profile {tag} device kernel {name[:70]}: calls={calls} "
              f"device_s={us / 1e6:.4f}", flush=True)
    host_ops = [e for e in events if not e.key.startswith(RANGE_PREFIXES)]
    for e in sorted(host_ops, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"profile {tag} host op {e.key[:60]}: calls={e.count} "
              f"host_s={e.self_cpu_time_total / 1e6:.4f}", flush=True)
    return out, wall


def check_components(tag, rep):
    """The survivor/label contract of a dedup_corpus report."""
    surv = rep.survivors
    if not (np.all(np.diff(surv) > 0)
            and np.array_equal(rep.component_of[surv], surv)
            and rep.component_of.shape == (rep.num_records,)
            and np.all(rep.component_of <= np.arange(rep.num_records))):
        raise AssertionError(f"{tag}: survivors/labels break the component contract")


def counted_run(tag, run, kernels):
    """One run with every launch count zeroed just before and read just
    after; prints the report. Returns the launch counts."""
    for k in kernels:
        k.launches = 0
    rep = run()
    launches = {k.name: k.launches for k in kernels}
    print(f"{tag}: records={rep.num_records} candidate_pairs="
          f"{rep.num_candidate_pairs} matched_pairs={rep.num_matched_pairs} "
          f"components={rep.num_components} blocking_s={rep.blocking_seconds:.3f} "
          f"matching_s={rep.matching_seconds:.3f} "
          f"partition_s={rep.partition_seconds:.3f} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
          f"launches={launches}", flush=True)
    check_components(tag, rep)
    return launches


def full_size(kernels):
    """The SYN1M main path: the counted HDB run, the recorded run, the
    counted threshold run, the naive pair count and the profiled run.
    Returns (HDB launch counts, recorded launches, SYN1M's corpus and keys
    moved to the host)."""
    from repro_torch.core import baselines, blocks, hdb
    from repro_torch.data import pipeline, synthetic
    t0 = time.perf_counter()
    corpus = synthetic.generate(synthetic.SyntheticSpec(num_entities=SYN1M_ENTITIES, seed=5),
                                device="cuda")
    torch.cuda.synchronize()
    print(f"SYN1M: generated {corpus.num_records} records in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    cfg = hdb.HDBConfig(max_block_size=200)

    def run(blocker="hdb"):
        return pipeline.dedup_corpus(corpus, cfg, blocker=blocker, device="cuda")

    torch.cuda.reset_peak_memory_stats()
    launches = counted_run("SYN1M hdb", run, kernels)
    idle = [name for name, c in launches.items() if c == 0]
    if idle:
        raise AssertionError(f"SYN1M: kernels never launched on the main path: {idle}")
    calls = record_launches(run, kernels)
    recorded = {name: len(c) if isinstance(c, list) else c["launches"]
                for name, c in calls.items()}
    if recorded != launches:
        raise AssertionError(f"SYN1M: recorded launches {recorded} != counted {launches}")
    torch.cuda.reset_peak_memory_stats()
    counted_run("SYN1M threshold", lambda: run("threshold"), kernels)
    keys, valid = blocks.build_keys(corpus.columns, corpus.blocking)
    print(f"SYN1M: naive_pair_count={baselines.naive_pair_count(keys, valid)} "
          f"over {int(valid.sum())} top-level keys", flush=True)
    profile_breakdown(run)
    return launches, calls, moved(corpus, keys, valid, "cpu")


def moved(corpus, keys, valid, device):
    """A corpus and its keys on ``device``: SYN1M waits on the host from
    phase 3 to phase 6, so the streaming phases' peak memory is theirs."""
    from repro_torch.core.blocks import TokenColumn
    from repro_torch.data import synthetic
    cols = {name: TokenColumn(c.tokens.to(device), c.mask.to(device))
            for name, c in corpus.columns.items()}
    return (synthetic.Corpus(cols, corpus.blocking, corpus.entity_id, corpus.num_records),
            keys.to(device), valid.to(device))


def synced(fn):
    """(fn(), seconds) with the card synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def stream_smoke():
    """Phase 5a: the streaming smoke on cuda and on cpu, held equal."""
    from repro_torch.streaming import smoke
    gpu, cpu = smoke.smoke_run("cuda"), smoke.smoke_run("cpu")
    differ = smoke.differing(gpu, cpu)
    if differ:
        raise AssertionError(f"stream smoke: {differ} differ cuda vs cpu")
    n_pairs, n_matched, label = gpu["extend auto"][-1]
    if not (len(gpu["ledger"][0]) == n_pairs and 0 < n_matched):
        raise AssertionError("stream smoke: empty ledger or no match")
    print(f"stream smoke: {label.shape[0]} records in 3 parts, {n_pairs} ledger "
          f"pairs, {n_matched} matched, {len(np.unique(label))} components, "
          f"{len(gpu['probes'])} probes (cuda == cpu: ledger, probes, matched "
          "pairs, component_of for the engine and both extend back ends)", flush=True)


def stream_keys(seed, n, card_n):
    """The key layout of benchmarks/bench_streaming.py:28-42 on the card:
    8 small keys at cardinality card_n // 4 and 2 hot keys at cardinality
    24 a record, row-deduped by the port's dedupe_row_keys."""
    from repro_torch.core import blocks, u64
    rng = np.random.default_rng(seed)
    small = rng.integers(0, max(int(card_n * 0.25), 4), (n, 8))
    hot = rng.integers(0, 24, (n, 2)) + (1 << 40)
    ids = np.concatenate([small, hot], axis=1).astype(np.uint64)
    k64 = ids * np.uint64(0x9E3779B97F4A7C15)
    return blocks.dedupe_row_keys(u64.from_numpy_u64(k64, "cuda"),
                                  torch.ones(ids.shape, dtype=torch.bool, device="cuda"))


def stream100k(kernels):
    """Phase 5b: STREAM100K. The base ingest, a warm delta, then the timed
    delta with every launch count zeroed just before and read just after;
    the store against the batch port on the same rows (the full re-block,
    timed); the timed delta again on a store built the same way with every
    launch held against its plain version as it happens; a third delta of
    the same layout, profiled. Returns the timed delta's launch counts and,
    for phase 5d, (keys and valid moved to the host, so the SYN stream's
    peak memory is its own; parts, cfg, candidate pairs and accepted
    blocks as they stood after the timed delta)."""
    from repro_torch.core import hdb, pairs
    from repro_torch.streaming import BlockStore, DeltaBlocker
    cfg = hdb.HDBConfig(max_block_size=64, max_iterations=6, cms_width=1 << 18)
    n, d = STREAM_RECORDS, STREAM_DELTA
    total = n + 2 * d
    keys, valid = stream_keys(0, total, total)
    parts = [slice(0, n), slice(n, n + d), slice(n + d, total)]

    def ingest(blk, part):
        return synced(lambda: blk.ingest_keys(keys[part], valid[part]))

    def warm_store():
        blk = DeltaBlocker(BlockStore(cfg, device="cuda"))
        return blk, [ingest(blk, part)[1] for part in parts[:2]]

    torch.cuda.reset_peak_memory_stats()
    blk, (base_s, warm_s) = warm_store()
    for k in kernels:
        k.launches = 0
    rep, delta_s = ingest(blk, parts[2])
    launches = {k.name: k.launches for k in kernels}
    store = blk.store
    # (level, rows replaced, entries reclassified, keys changed, rows dirty)
    levels = [(r.level, r.n_replaced, r.n_reclassified, r.n_changed_keys, r.n_dirty_rows)
              for r in rep.levels]
    print(f"STREAM100K: base_records={n} base_build_s={base_s:.4f} warm_delta_s="
          f"{warm_s:.4f} delta_records={d} delta_ingest_s={delta_s:.4f} "
          f"pairs_added={rep.num_pairs_added} pairs_retracted="
          f"{len(rep.pairs_retracted[0])} ledger_pairs={store.ledger.num_pairs} "
          f"levels={levels} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
          f"launches={launches}", flush=True)

    def reblock(m):
        # the calls benchmarks/bench_streaming.py:45-49 times
        res = hdb.hashed_dynamic_blocking(keys[:m], valid[:m], cfg, device="cuda")
        blocks = pairs.build_blocks(res, device="cuda")
        return res, pairs.dedupe_pairs(blocks, budget=blocks.num_pair_slots + 1,
                                       device="cuda")

    reblock(4096)
    (res, want), reblock_s = synced(lambda: reblock(total))
    want_blk = pairs.build_blocks(res, min_size=1, device="cuda")
    got, got_blk = store.candidate_pairs(), store.accepted_blocks(min_size=1)
    for f in ("a", "b", "src_size"):
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"STREAM100K: ledger {f} differs from the batch port")
    for f in ("key_hi", "key_lo", "start", "size", "members"):
        if not np.array_equal(getattr(got_blk, f), getattr(want_blk, f)):
            raise AssertionError(f"STREAM100K: accepted blocks {f} differ from the batch port")
    print(f"STREAM100K: full re-block of {total} records (hashed_dynamic_blocking + "
          f"build_blocks + exact dedupe_pairs) reblock_s={reblock_s:.4f}, "
          f"{reblock_s / delta_s:.2f} x the delta; ledger ({len(got.a)} pairs) and "
          f"accepted blocks ({got_blk.num_blocks}) equal the batch port", flush=True)

    blk2, _ = warm_store()
    checked = check_launches(lambda: blk2.ingest_keys(keys[parts[2]], valid[parts[2]]),
                             kernels)
    if checked != launches or not (np.array_equal(blk2.store.led_pack, store.led_pack)
                                   and np.array_equal(blk2.store.led_src, store.led_src)):
        raise AssertionError(f"STREAM100K: the checked delta ({checked}) differs from "
                             f"the timed one ({launches})")
    print(f"STREAM100K: the timed delta again on a store built the same way, "
          f"every launch bit-identical to its plain version: {checked}", flush=True)
    k3, v3 = stream_keys(1, d, total)
    profile_breakdown(lambda: blk.ingest_keys(k3, v3), tag="STREAM100K delta")
    return launches, (keys.cpu(), valid.cpu(), parts, cfg, got, got_blk)


def syn_stream(kernels, entities=SYN_STREAM_ENTITIES):
    """Phase 5c: the SYN1M corpus in a seeded arrival order through
    DedupPipeline.extend (fused back end): the base, then the deltas, with
    every launch count zeroed before the base and read after the last
    delta (the last one profiled); the same arrivals on a twin pipeline
    with every launch held against its plain version as it happens; the
    last report against dedup_corpus on the same rows with an exact pair
    budget. Returns the timed run's launch counts."""
    from repro_torch.core import hdb
    from repro_torch.data import pipeline, synthetic
    t_phase = time.perf_counter()
    corpus = synthetic.generate(synthetic.SyntheticSpec(num_entities=entities, seed=5),
                                device="cuda")
    n = corpus.num_records
    arrived = synthetic.corpus_slice(corpus, np.random.default_rng(5).permutation(n))
    del corpus
    d = n // 100
    cuts = [0] + [n - k * d for k in range(SYN_STREAM_DELTAS, -1, -1)]
    cfg = hdb.HDBConfig(max_block_size=200)
    pipe = pipeline.DedupPipeline(cfg, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    for i, (lo, hi) in enumerate(zip(cuts[:-1], cuts[1:])):
        def extend():
            return pipe.extend(synthetic.corpus_slice(arrived, np.arange(lo, hi)))
        if i == SYN_STREAM_DELTAS:
            rep, secs = profile_breakdown(extend, tag="SYN stream delta")
        else:
            rep, secs = synced(extend)
        print(f"SYN stream extend {i} ({'base' if i == 0 else 'delta'}): records="
              f"{hi - lo} union={rep.num_records} extend_s={secs:.4f} blocking_s="
              f"{rep.blocking_seconds:.4f} matching_s={rep.matching_seconds:.4f} "
              f"partition_s={rep.partition_seconds:.4f} candidate_pairs="
              f"{rep.num_candidate_pairs} matched_pairs={rep.num_matched_pairs} "
              f"components={rep.num_components}", flush=True)
    launches = {k.name: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated()
    idle = [name for name, c in launches.items() if c == 0]
    if idle:
        raise AssertionError(f"SYN stream: kernels never launched: {idle}")
    twin = pipeline.DedupPipeline(cfg, device="cuda")
    t_check = time.perf_counter()
    replay = []
    checked = check_launches(lambda: replay.extend(
        twin.extend(synthetic.corpus_slice(arrived, np.arange(lo, hi)))
        for lo, hi in zip(cuts[:-1], cuts[1:])), kernels)
    again = replay[-1]
    if checked != launches or not (
            again.num_candidate_pairs == rep.num_candidate_pairs
            and again.num_matched_pairs == rep.num_matched_pairs
            and np.array_equal(again.component_of, rep.component_of)
            and np.array_equal(again.survivors, rep.survivors)):
        raise AssertionError(f"SYN stream: the checked replay ({checked}) differs "
                             f"from the timed run ({launches})")
    print(f"SYN stream: the base and the deltas again on a twin pipeline, every "
          f"launch bit-identical to its plain version, same counts and last report "
          f"({time.perf_counter() - t_check:.1f} s): {checked}", flush=True)
    del twin
    total_slots = pipe.store.candidate_pairs().total_slots
    batch, batch_s = synced(lambda: pipeline.dedup_corpus(
        arrived, cfg, pair_budget=total_slots + 1, device="cuda"))
    if not (rep.num_candidate_pairs == batch.num_candidate_pairs
            and rep.num_matched_pairs == batch.num_matched_pairs
            and np.array_equal(rep.component_of, batch.component_of)
            and np.array_equal(rep.survivors, batch.survivors)):
        raise AssertionError("SYN stream: the last extend differs from dedup_corpus")
    check_components("SYN stream", rep)
    print(f"SYN stream: entities={entities} records={n} base={cuts[1]} deltas="
          f"{SYN_STREAM_DELTAS}x{d} equals dedup_corpus (exact, {total_slots} pair "
          f"slots, batch_s={batch_s:.4f}): candidate_pairs={rep.num_candidate_pairs} "
          f"matched_pairs={rep.num_matched_pairs} components={rep.num_components}; "
          f"max_memory_allocated={peak} launches={launches} "
          f"phase_s={time.perf_counter() - t_phase:.1f}", flush=True)
    return launches


def sharded_store(kernels, stream_ref):
    """Phase 5d: the sharded store. The smoke config through
    StreamingEngine(n_shards=n), n in 1, 4, 8, with every launch held
    against its plain version, against the single store and the cpu run;
    then STREAM100K's parts through ShardedBlockStore(n_shards=4), the last
    delta timed and counted, against phase 5b's single store. Returns the
    timed delta's launch counts."""
    from repro_torch.streaming import DeltaBlocker, ShardedBlockStore, smoke
    t_phase = time.perf_counter()
    single = smoke.sharded_run("cuda", 1)
    for n in (1, 4, 8):
        out = []
        checked = check_launches(lambda: out.append(smoke.sharded_run("cuda", n)),
                                 kernels)
        (gpu,) = out
        differ = smoke.differing(gpu, single) + smoke.differing(gpu, smoke.sharded_run("cpu", n))
        if differ:
            raise AssertionError(f"sharded smoke n_shards={n}: {differ} differ from the "
                                 "single store or the cpu run")
        print(f"sharded smoke n_shards={n}: {len(gpu['reports'])} ingests, "
              f"{len(gpu['ledger'][0])} ledger pairs, {len(gpu['probes'])} probes, equal "
              f"to the single store and the cpu run (reports, ledger, candidate pairs, "
              f"matched pairs, probes); every launch bit-identical to its plain "
              f"version: {checked}", flush=True)
    keys, valid, parts, cfg, want, want_blk = stream_ref
    keys, valid = keys.cuda(), valid.cuda()
    torch.cuda.reset_peak_memory_stats()
    blk = DeltaBlocker(ShardedBlockStore(cfg, n_shards=4, device="cuda"))
    (base_s, warm_s) = [synced(lambda: blk.ingest_keys(keys[p], valid[p]))[1]
                        for p in parts[:2]]
    for k in kernels:
        k.launches = 0
    rep, delta_s = synced(lambda: blk.ingest_keys(keys[parts[2]], valid[parts[2]]))
    launches = {k.name: k.launches for k in kernels}
    store = blk.store
    got, got_blk = store.candidate_pairs(), store.accepted_blocks(min_size=1)
    for f in ("a", "b", "src_size"):
        if not np.array_equal(getattr(got, f), getattr(want, f)):
            raise AssertionError(f"STREAM100K sharded: candidate pairs {f} differ "
                                 "from the single store")
    for f in ("key_hi", "key_lo", "start", "size", "members"):
        if not np.array_equal(getattr(got_blk, f), getattr(want_blk, f)):
            raise AssertionError(f"STREAM100K sharded: accepted blocks {f} differ "
                                 "from the single store")
    ms = store.memory_stats()
    shard_bytes = [sh.total_bytes for sh in store.shards]
    print(f"STREAM100K sharded (n_shards=4): base_build_s={base_s:.4f} warm_delta_s="
          f"{warm_s:.4f} delta_ingest_s={delta_s:.4f} pairs_added={rep.num_pairs_added} "
          f"ledger_pairs={ms['ledger_pairs']} shard_skew={ms['shard_skew']:.6f} "
          f"shard_total_bytes={shard_bytes} memory_stats_bytes="
          f"{ {k: v for k, v in ms.items() if k.endswith('_bytes')} } "
          f"exchange_total={store.router.exchange_total} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
          f"launches={launches}; ledger, candidate pairs and accepted blocks equal "
          f"phase 5b's single store", flush=True)
    print(f"phase 5d: phase_s={time.perf_counter() - t_phase:.1f}", flush=True)
    return launches


# benchmarks/bench_table2.py's threshold and HDB max_block_size
TABLE2_MAX_BLOCK = 200


def table2_methods(corpus, keys, valid, device):
    """THR, PMB and HDB as benchmarks/bench_table2.py runs them: each
    method's blocking timed (the card synchronised on both sides), then
    metrics.evaluate against the corpus's labelled pairs. Returns
    {method: (BlockingMetrics, or the MetaBlockingBudgetError of a PMB over
    its edge budget; seconds)} and PMB's tri-decode launches."""
    from repro_torch.core import baselines, hdb, metablocking
    from repro_torch.data import metrics
    from repro_torch.kernels.pairs import tri as td
    labeled = corpus.labeled_pairs()

    def evaluated(block):
        res, secs = synced(block)
        return metrics.evaluate(res, corpus, labeled, device=device), secs

    out = {"THR": evaluated(lambda: baselines.threshold_blocking(
        keys, valid, TABLE2_MAX_BLOCK, device=device))}
    before = td.KERNEL.launches
    try:
        out["PMB"] = evaluated(lambda: metablocking.meta_blocking_result(
            keys, valid, device=device))
    except metablocking.MetaBlockingBudgetError as e:
        out["PMB"] = (e, None)
    pmb_tri = td.KERNEL.launches - before
    out["HDB"] = evaluated(lambda: hdb.hashed_dynamic_blocking(
        keys, valid, hdb.HDBConfig(max_block_size=TABLE2_MAX_BLOCK), device=device))
    return out, pmb_tri


def print_table2(dataset, rows, pmb_tri):
    for method, (m, secs) in rows.items():
        if isinstance(m, Exception):
            print(f"# PMB failed on {dataset}: {m} (mirrors paper section 5.3)", flush=True)
            print(f"table2,{dataset},{method},nan,nan,0,nan", flush=True)
        else:
            print(f"table2,{dataset},{method},{m.pq!r},{m.pc!r},{m.distinct_pairs},"
                  f"{secs!r}", flush=True)
            print(f"table2 {dataset} {method} metrics: {dataclasses.asdict(m)}", flush=True)
    print(f"table2 {dataset}: enumerate_pairs tri-decode launches (PMB stage 3) = "
          f"{pmb_tri}", flush=True)


def same_metrics(a, b):
    return all(type(a[k][0]) is type(b[k][0]) and (
        str(a[k][0]) == str(b[k][0]) if isinstance(a[k][0], Exception)
        else dataclasses.asdict(a[k][0]) == dataclasses.asdict(b[k][0])) for k in a)


def table2(kernels, syn1m):
    """Phase 6: paper Table 2 on SYN10K (cuda timed, cuda checked, cpu;
    equal metrics) and on SYN1M (cuda, counted). Returns SYN1M's launch
    counts."""
    from repro_torch.core import blocks
    from repro_torch.data import synthetic
    t_phase = time.perf_counter()
    spec = synthetic.SyntheticSpec(num_entities=4_000, seed=1)   # benchmarks/common.py:45
    runs = {}
    for dev in ("cuda", "cpu"):
        corpus = synthetic.generate(spec, device=dev)
        keys, valid = blocks.build_keys(corpus.columns, corpus.blocking)
        runs[dev] = table2_methods(corpus, keys, valid, dev)
        if dev == "cuda":
            print_table2("SYN10K", *runs[dev])
            out = []
            checked = check_launches(
                lambda: out.append(table2_methods(corpus, keys, valid, dev)), kernels)
            if not same_metrics(out[0][0], runs[dev][0]):
                raise AssertionError("table2 SYN10K: the checked cuda run's metrics differ")
    if not same_metrics(runs["cuda"][0], runs["cpu"][0]):
        raise AssertionError("table2 SYN10K: metrics differ cuda vs cpu")
    print(f"table2 SYN10K: BlockingMetrics of THR, PMB and HDB equal on cuda and cpu; "
          f"the cuda run again with every launch bit-identical to its plain version: "
          f"{checked}", flush=True)
    corpus, keys, valid = moved(*syn1m, "cuda")
    for k in kernels:
        k.launches = 0
    rows, pmb_tri = table2_methods(corpus, keys, valid, "cuda")
    launches = {k.name: k.launches for k in kernels}
    print_table2("SYN1M", rows, pmb_tri)
    print(f"table2 SYN1M: records={corpus.num_records} launches={launches}", flush=True)
    print(f"phase 6: phase_s={time.perf_counter() - t_phase:.1f}", flush=True)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels.cms import cms
    from repro_torch.kernels.hash64 import hash64
    from repro_torch.kernels.match import match as mk
    from repro_torch.kernels.minhash import minhash
    from repro_torch.kernels.pairs import tri as td
    from repro_torch.kernels.sort import radix

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)

    smoke_pipeline()
    kernels = [td.KERNEL, radix.PASS_KERNEL, radix.COUNTS_KERNEL, mk.KERNEL,
               hash64.MIX_KERNEL, hash64.COMBINE_KERNEL, minhash.KERNEL, cms.KERNEL]
    launches, calls, syn1m = full_size(kernels)
    checks = {"tri_decode": check_tri_decode, "radix_sort": check_radix,
              "radix_digit_counts": check_digit_counts,
              "match": check_match, "mix64": check_mix64,
              "combine64": check_combine64, "minhash": check_minhash,
              "cms_update": check_cms}
    rows = []
    for name, check in checks.items():
        rows.append(check(calls.pop(name)))
        torch.cuda.empty_cache()
    del calls

    stream_smoke()
    stream_launches, stream_ref = stream100k(kernels)
    torch.cuda.empty_cache()
    syn_launches = syn_stream(kernels)
    torch.cuda.empty_cache()
    sharded_launches = sharded_store(kernels, stream_ref)
    del stream_ref
    torch.cuda.empty_cache()
    table2_launches = table2(kernels, syn1m)
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["stream100k_delta_launches"] = stream_launches[row["name"]]
        row["syn_stream_launches"] = syn_launches[row["name"]]
        row["sharded_delta_launches"] = sharded_launches[row["name"]]
        row["table2_syn1m_launches"] = table2_launches[row["name"]]
        row["card"] = card
        print(f"kernel {row['name']}: ms={row['ms']:.4f} plain_ms="
              f"{row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
              f"({row['bound_by']}) library_ms={row['library_ms']} "
              f"call_ms={row['call_ms']:.4f} [{row['shape']}]", flush=True)
        for key in ("compact_scatter_ms", "by_width"):
            if key in row:
                print(f"kernel {row['name']}: {key}={row[key]}", flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
