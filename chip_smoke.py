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
      arrival order through DedupPipeline.extend (a base, then
      SYN_STREAM_DELTAS 1% deltas, the last profiled); every kernel must
      launch; the base and the deltas are replayed on a twin pipeline with
      every launch held against its plain version as it happens (same
      counts, same last report); and the last report must equal
      dedup_corpus on the same rows with an exact pair budget;
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
   recorded as the bench records it;
7. mesh (``core/distributed``, the sharded store on a mesh), after the
   build of phase 1, so ranks only load the libraries:
   b. a one-rank NCCL group in this process: distributed HDB on SYN1M
      (phase 3's keys, max_block_size 200, the representative capacity
      sized from the single device's largest iteration) with rep_overflow
      0 in every iteration, held to the single device by the reference's
      rule (no extra assignment, at most 2 missing, equal
      n_surviving_oversized and n_right_cms); the routed dedupe of its
      blocks at dedup_corpus's 20M budget (sampled) and of SYN10K's blocks
      at an exact budget, each PairSet equal to the single device's; each
      run timed with the card synchronised and the launch counts zeroed
      just before and read just after, then replayed with every launch
      held against its plain version;
   c. MESH_RANKS gloo ranks spawned on the one card (NCCL takes one rank a
      card): the smoke config and SYN10K through distributed HDB and the
      routed dedupe, tests/_shard_worker.py's store scenario on the mesh
      (routed, and at route_slack 0.01, whose fallback must warn and lose
      nothing), SYN1M's distributed HDB, and STREAM100K's base and two
      deltas through ShardedBlockStore(n_shards=MESH_RANKS) on the mesh
      (no fallback at the default slack, equal to phase 5b's store); every
      launch held against its plain version; each rank equal to every
      other, to its cpu run and to the single-device port on cuda.
   Each run prints ``mesh,<what>,<ranks>,<backend>,<seconds>,<rep_overflow>,
   <route_overflow>``;
8. serving (``repro_torch.serving``):
   a. the DedupeService at benchmarks/bench_serving.py's defaults: a
      50,000-record store of the streaming bench's key layout built
      through the write lane (launch counts zeroed before and read after),
      one warm-up round a client batch size, then 2,048 probe rows at
      batch sizes 1, 8 and 64 (launch counts zeroed before and read after
      each timed pass), each printing ``serving,b=<b>,<qps>,<p50_ms>,
      <p99_ms>,<occupancy>,<batches>`` from the service's own histograms.
      The walk shapes (``probe_jit_cache_sizes``) and the bucket shapes
      must not grow after the warm-up; every response ``ok``; every row
      equal across batch sizes and to a solo ``query_keys`` on the card;
      batch size 8 replayed with every launch held against its plain
      version, then profiled; a 4-shard tenant (its ingest checked launch
      by launch) answering every row equally; the same service on the cpu
      answering the first 256 rows equally; ``refresh_clusters`` on the
      card equal to the cpu run;
   b. the LM ServingEngine: tinyllama-1.1b as published (bfloat16,
      weights from a seeded generator on the card; its parameter count
      checked on the meta device), 16 requests of 2-32 prompt tokens over
      8 slots, 32 new tokens each, max_len 1024, timed with CUDA events;
      ten more decode steps profiled; then the same widths at 2 layers in float32 (TF32 off) on cuda and
      cpu: equal tokens, first-step logits within 1e-3;
9. training (``repro_torch.launch.train``, ``repro_torch.training``):
   a. the launcher on tinyllama-1.1b as published (bfloat16, seeded
      weights on the card, remat "full"), --dedup at its defaults (3,000
      entities, batch 8, seq 256), 12 steps with a checkpoint every 6,
      every dedup kernel launch held against its plain version (launch
      counts zeroed just before and read just after); every loss finite;
      the CUDA-event step time of steps 2-12, tokens/s, peak memory, the
      checkpoints' size and save time; then a second run resumed from
      step 6's checkpoint to step 12 (step counter, the loader's batch at
      step 6 equal to the first run's); two more steps profiled (idle
      share, launches a step, top device kernels) and the optimizer's
      device time;
   b. the same widths at 2 layers in float32 (TF32 off) from the same
      weights on cuda and cpu: 3 train steps with wq and wk scaled by
      1/8 give loss, ce and grad_norm within rtol 1e-4; one step at the
      unscaled init is printed beside them; and, in a process of its own
      with deterministic kernels (``python -m repro_torch.training.smoke``),
      a run resumed from a checkpoint halfway bit-identical to the
      uninterrupted run;
10. host-sync census (``repro_torch.analysis.sync_census``): one untimed
    run of each path under torch's sync debug mode, none of them timed:
    SYN1M through dedup_corpus(blocker="hdb"), a STREAM100K delta, a
    SERVE50K probe pass at client batch 8, a TINYLLAMA-SERVE decode step
    and launch/train.py --dedup for two TINYLLAMA-TRAIN steps. Each prints
    its total syncs, the syncs per profiler range and its ten heaviest
    sites with their inventory reasons (``census`` lines); a run that
    counts no sync, or a site of the port whose line carries no
    ``# repro: noqa[R001]``/``noqa[R003]``, fails the phase.

The line before the last is a JSON object with one entry per kernel
(``launches`` from the SYN1M HDB run; ``stream100k_delta_launches``,
``syn_stream_launches`` and ``sharded_delta_launches`` from phase 5,
``table2_syn1m_launches`` from phase 6, ``mesh_launches`` from phase 7b's
timed runs, ``mesh_gloo_launches`` from rank 0 of phase 7c,
``serving_probe_launches`` summed over phase 8a's three timed passes and
``serving_ingest_launches`` from its write-lane build,
``train_dedup_launches`` from phase 9a's first run); the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or
without the rest of the repository beside it, the script exits non-zero.
"""
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
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
# time on an H100 (PERF.md section 4); and from ten deltas to four: each
# costs about 20 s, twice with its checked replay, which kept the script
# too near its time limit
SYN_STREAM_ENTITIES = 100_000
SYN_STREAM_DELTAS = 4
# lanes of the tri-decode check at block sizes the SYN1M path does not reach
TRI_EXTREME_SLOTS = 1 << 20


RANGE_PREFIXES = ("dedup.", "hdb.", "pairs.", "stream.", "serve.", "train.")


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
    multiple of the calls means the profiler lost (or gained) events (it
    has, on calls of hundreds of kernels, and on the compacting scatter of
    check_cms): the window is measured again; after the third, each call
    is profiled in a window of its own, and the calls are timed there if
    every window saw the same device events; a round of such windows is
    tried three times (the first window of a round has come up short),
    then it raises."""
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
    for _ in range(attempts):
        windows = []
        for _ in range(reps):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            windows.append(_kernel_events(prof))
        names = [sorted(e.name for e in w) for w in windows]
        if names[0] and all(n == names[0] for n in names):
            print(f"device_ms: {len(events)} device events over {reps} calls in one "
                  f"window, {attempts} times; timed in {reps} windows of one call "
                  f"({len(names[0])} events each)", flush=True)
            return sum(e.time_range.elapsed_us() for w in windows for e in w) / reps / 1e3
    raise AssertionError(f"profiler saw {len(events)} device events over {reps} calls, "
                         f"{attempts} times, and {attempts} rounds of windows of one "
                         f"call disagreed, the last {[len(n) for n in names]}: "
                         f"{sorted(set(names[0]))[:8]}")


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
    from repro_torch.data import pipeline, synthetic
    from repro_torch.streaming import smoke
    spec, cfg = smoke.smoke_config()
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
    (run's result, wall seconds, device busy seconds, device launches,
    {range: device seconds of the kernels its ops launched})."""
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
    launches = sum(calls for calls, _ in kernels.values())
    print(f"profile {tag}: wall_s={wall:.3f} device_busy_s={busy:.3f} "
          f"device_idle_share={1 - busy / wall:.4f} device_launches={launches}",
          flush=True)
    events = prof.key_averages()
    ranges = {}
    for e in sorted(events, key=lambda e: e.key):
        if e.key.startswith(RANGE_PREFIXES) and e.cpu_time_total:
            ranges[e.key] = e.device_time_total / 1e6
            print(f"profile {tag} range {e.key}: calls={e.count} "
                  f"host_s={e.cpu_time_total / 1e6:.3f} device_s={ranges[e.key]:.4f}",
                  flush=True)
    for name, (calls, us) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]:
        print(f"profile {tag} device kernel {name[:70]}: calls={calls} "
              f"device_s={us / 1e6:.4f}", flush=True)
    host_ops = [e for e in events if not e.key.startswith(RANGE_PREFIXES)]
    for e in sorted(host_ops, key=lambda e: -e.self_cpu_time_total)[:10]:
        print(f"profile {tag} host op {e.key[:60]}: calls={e.count} "
              f"host_s={e.self_cpu_time_total / 1e6:.4f}", flush=True)
    return out, wall, busy, launches, ranges


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


def stream100k_config():
    """STREAM100K's HDB settings (benchmarks/bench_streaming.py)."""
    from repro_torch.core import hdb
    return hdb.HDBConfig(max_block_size=64, max_iterations=6, cms_width=1 << 18)


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
    cfg = stream100k_config()
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
            rep, secs, *_ = profile_breakdown(extend, tag="SYN stream delta")
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
          f"({time.perf_counter() - t_check:.1f} s): {checked}", flush=True)  # repro: noqa[R004] the replay's reports are host numpy
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
    print(f"phase 6: phase_s={time.perf_counter() - t_phase:.1f}", flush=True)  # repro: noqa[R004] phase wall time, printed only
    return launches


# ---------------------------------------------------------------------------
# phase 7: the mesh half (core/distributed, the sharded store on a mesh)
# ---------------------------------------------------------------------------

# the kernels the distributed path runs (minhash only builds keys, match
# only matches)
MESH_PATH = ("cms_update", "mix64", "combine64", "tri_decode", "radix_sort",
             "radix_digit_counts")
MESH_RANKS = 4
# tests/_shard_worker.py's store scenarios: its HDBConfig, and per run the
# route slack, records and key cardinality (the overflow run's slack of
# 0.01 must overflow the 8-lane buckets and fall back, loudly)
SHARD_CFG = dict(max_block_size=8, max_iterations=5, max_oversize_keys=6,
                 cms_width=1 << 10)
SHARD_RUNS = {"routed": (2.0, 120, 20), "overflow": (0.01, 240, 120)}


def mesh_line(what, ranks, backend, secs, rep_overflow, route_overflow):
    """One phase-7 run: rep_overflow sums HDB's IterationStats.rep_overflow
    (0 for a pair dedupe); route_overflow counts the RepCapacityWarnings of
    a routed fallback."""
    print(f"mesh,{what},{ranks},{backend},{secs!r},{rep_overflow},{route_overflow}",
          flush=True)


def assignment_hashes(res):
    """One u64 hash a (rid, key) assignment (for set differences of tens of
    millions of assignments; two distinct assignments collide with
    probability 2**-64)."""
    from repro_torch.core import hashing
    key = (res.key_hi.astype(np.uint64) << np.uint64(32)) | res.key_lo.astype(np.uint64)
    return hashing.np_hash_u64_vec(key ^ hashing.np_mix64_vec(
        np.asarray(res.rids, np.uint64)), seed=0x5E7)


def hold_to_single(tag, got, want):
    """The reference's rule for distributed HDB against the single device
    (tests/_dist_worker.py:96-104): no extra assignment, at most 2 missing
    (Bloom false positives), equal n_surviving_oversized and n_right_cms
    in every iteration. Both list the assignments in the same order, so
    equal arrays need no set difference. Returns the missing count."""
    if all(np.array_equal(getattr(got, f), getattr(want, f))
           for f in ("rids", "key_hi", "key_lo")):
        n_extra = n_missing = 0
    else:
        hg, hw = assignment_hashes(got), assignment_hashes(want)
        n_extra = len(np.setdiff1d(hg, hw))
        n_missing = len(np.setdiff1d(hw, hg))
    if n_extra or n_missing > 2:
        raise AssertionError(f"{tag}: {n_extra} extra, {n_missing} missing "
                             "assignments against the single device")
    for a, b in zip(want.stats, got.stats):
        if (a.n_surviving_oversized, a.n_right_cms) != (b.n_surviving_oversized,
                                                        b.n_right_cms):
            raise AssertionError(f"{tag}: iteration {a.iteration} stats differ: "
                                 f"{a} vs {b}")
    return n_missing


def pairset_arrays(ps):
    return [ps.a, ps.b, ps.src_size, ps.exact, ps.total_slots]


def blocking_arrays(res):
    return [res.rids, res.key_hi, res.key_lo,
            [dataclasses.astuple(st) for st in res.stats]]


def dist_config(reps):
    """DistConfig for a layout whose largest iteration has ``reps``
    over-sized blocks: the representative capacity at least that, rounded
    up to a power of two, and a Bloom filter of at least the default size
    that ``BloomConfig.for_capacity`` gives it (a false-positive rate near
    1e-8)."""
    from repro_torch.core import distributed, sketches
    default = distributed.DistConfig()
    rcap = max(default.rep_capacity_per_shard, 1 << max(reps - 1, 0).bit_length())
    bloom = sketches.BloomConfig.for_capacity(rcap)
    if bloom.num_slots <= default.bloom_slots:
        return distributed.DistConfig(rep_capacity_per_shard=rcap)
    return distributed.DistConfig(rep_capacity_per_shard=rcap,
                                  bloom_slots=bloom.num_slots,
                                  bloom_hashes=bloom.num_hashes)


def caught_capacity(fn):
    """(fn(), the RepCapacityWarnings it raised)."""
    import warnings
    from repro_torch.core.hdb import RepCapacityWarning
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out = fn()
    return out, sum(issubclass(w.category, RepCapacityWarning) for w in caught)


def corpus_keys(spec, device, world):
    from repro_torch.core import blocks, distributed
    from repro_torch.data import synthetic
    corpus = synthetic.generate(spec, device=device)
    return distributed.pad_rows(*blocks.build_keys(corpus.columns, corpus.blocking),
                                world)


def store_run(store, n, card):
    """The store scenario's four parts into ``store``; its ledger,
    accepted blocks and counters."""
    from repro_torch.streaming import DeltaBlocker, smoke
    # tests/_shard_worker.py's random_keys(rng(17), n, 5, card), row-deduped
    keys, valid = smoke.scenario_keys(np.random.default_rng(17), n, 5, card,
                                      store.device)
    blk = DeltaBlocker(store)
    n = keys.shape[0]
    cuts = [0, n // 4 + 1, n // 2, 3 * n // 4 + 1, n]
    _, warned = caught_capacity(lambda: [blk.ingest_keys(keys[a:b], valid[a:b])
                                         for a, b in zip(cuts[:-1], cuts[1:])])
    acc = store.accepted_blocks(1)
    out = {"ledger": [store.led_pack, store.led_src],
           "accepted": [acc.key_hi, acc.key_lo, acc.start, acc.size, acc.members]}
    if hasattr(store, "router"):
        out["counters"] = [store.router.exchange_total,
                           store.router.exchange_fallback_total,
                           blk.routed_fallback_total, warned]
    return out


def syn10k_spec():
    from repro_torch.core import hdb
    from repro_torch.data import synthetic
    return (synthetic.SyntheticSpec(num_entities=4_000, seed=1),     # benchmarks/common.py:45
            hdb.HDBConfig(max_block_size=TABLE2_MAX_BLOCK))


def mesh_cases(mesh, world, device):
    """The 7c runs on one rank: the smoke config and SYN10K through
    distributed HDB and the routed exact dedupe, and the store scenario on
    the mesh at both slacks. Returns {case: (result values, seconds,
    rep_overflow, route_overflow)}."""
    from repro_torch.core import distributed, hdb, pairs
    from repro_torch.streaming import ShardedBlockStore, smoke
    out = {}
    for name, (spec, cfg) in (("smoke", smoke.smoke_config()), ("SYN10K", syn10k_spec())):
        keys, valid = corpus_keys(spec, device, world)
        res, secs = synced(lambda: distributed.distributed_hashed_dynamic_blocking(
            keys, valid, cfg, mesh, device=device))
        out[f"{name} hdb"] = (blocking_arrays(res), secs, res.rep_overflow_total, 0)
        blk = pairs.build_blocks(res, device=device)
        (ps, warned), secs = synced(lambda: caught_capacity(lambda: pairs.dedupe_pairs(
            blk, budget=blk.num_pair_slots + 1, backend="distributed", mesh=mesh,
            device=device)))
        out[f"{name} routed exact"] = (pairset_arrays(ps), secs, 0, warned)
    for run, (slack, n, card) in SHARD_RUNS.items():
        st = ShardedBlockStore(hdb.HDBConfig(**SHARD_CFG), n_shards=world, mesh=mesh,
                               route_slack=slack, device=device)
        got, secs = synced(lambda: store_run(st, n, card))
        out[f"store {run}"] = (got, secs, 0, got["counters"][3])
    return out


def mesh_stream100k(mesh, world, keys, valid, parts, cfg):
    """STREAM100K's base and two deltas through ShardedBlockStore(n_shards=
    world) on ``mesh``: the routed key-delta exchange and the routed ledger
    sync at the store's real size. Returns (ledger, candidate pairs,
    accepted blocks and counters; each ingest's seconds)."""
    from repro_torch.streaming import DeltaBlocker, ShardedBlockStore
    blk = DeltaBlocker(ShardedBlockStore(cfg, n_shards=world, mesh=mesh,
                                         device=keys.device))
    secs, warned = caught_capacity(lambda: [
        synced(lambda: blk.ingest_keys(keys[p], valid[p]))[1] for p in parts])
    store = blk.store
    got, acc = store.candidate_pairs(), store.accepted_blocks(min_size=1)
    return ({"ledger": [store.led_pack, store.led_src],
             "pairs": [got.a, got.b, got.src_size],
             "accepted": [acc.key_hi, acc.key_lo, acc.start, acc.size, acc.members],
             "counters": [store.router.exchange_total,
                          store.router.exchange_fallback_total,
                          blk.routed_fallback_total, warned]}, secs)


def mesh_rank(rank, world, init, tmp, syn1m_path, dcfg, stream_path, parts, scfg):
    """One of phase 7c's ranks: gloo on the one card, every launch held
    against its plain version; the results pickled to ``tmp``."""
    import pickle
    import torch.distributed as tdist
    from torch.distributed.device_mesh import DeviceMesh
    torch.cuda.set_device(0)
    tdist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("data",))
        out = {}
        counts = check_launches(lambda: out.update(mesh_cases(mesh, world, "cuda")),
                                all_kernels())
        cpu = mesh_cases(mesh, world, "cpu")
        from repro_torch.core import distributed, hdb
        keys, valid = torch.load(syn1m_path)
        keys, valid = distributed.pad_rows(keys.cuda(), valid.cuda(), world)
        syn1m = {}
        counts1m = check_launches(lambda: syn1m.update(res=synced(
            lambda: distributed.distributed_hashed_dynamic_blocking(
                keys, valid, hdb.HDBConfig(max_block_size=TABLE2_MAX_BLOCK), mesh,
                dist=dcfg, device="cuda"))), all_kernels())
        res, secs = syn1m["res"]
        out["SYN1M hdb"] = (blocking_arrays(res), secs, res.rep_overflow_total, 0)
        skeys, svalid = torch.load(stream_path)
        stream = {}
        counts_s = check_launches(lambda: stream.update(run=mesh_stream100k(
            mesh, world, skeys.cuda(), svalid.cuda(), parts, scfg)), all_kernels())
        got, secs = stream["run"]
        out["STREAM100K store"] = (got, secs, 0, got["counters"][3])
        counts = {k: counts[k] + counts1m[k] + counts_s[k] for k in counts}
    finally:
        tdist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump({"card": out, "host": cpu, "launches": counts}, f)


def all_kernels():
    """Every kernel wrapper's launch counter, in the JSON line's order."""
    from repro_torch.kernels.cms import cms
    from repro_torch.kernels.hash64 import hash64
    from repro_torch.kernels.match import match as mk
    from repro_torch.kernels.minhash import minhash
    from repro_torch.kernels.pairs import tri as td
    from repro_torch.kernels.sort import radix
    return [td.KERNEL, radix.PASS_KERNEL, radix.COUNTS_KERNEL, mk.KERNEL,
            hash64.MIX_KERNEL, hash64.COMBINE_KERNEL, minhash.KERNEL, cms.KERNEL]


def mesh_one_rank(kernels, syn1m):
    """Phase 7b: a one-rank NCCL group in this process. Distributed HDB and
    the routed dedupe (sampled, at dedup_corpus's 20M budget) on SYN1M,
    the routed exact dedupe on SYN10K, each timed with the launch counts
    zeroed just before and read just after, then replayed with every
    launch held against its plain version. Returns (launch counts, the
    SYN1M DistConfig, the single-device SYN1M result)."""
    import tempfile
    import torch.distributed as tdist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.core import distributed, hdb, pairs
    _, keys, valid = moved(*syn1m, "cuda")
    cfg = hdb.HDBConfig(max_block_size=TABLE2_MAX_BLOCK)
    single, single_s = synced(lambda: hdb.hashed_dynamic_blocking(keys, valid, cfg,
                                                                  device="cuda"))
    reps = max(st.n_surviving_oversized + st.n_duplicate_blocks for st in single.stats)
    dcfg = dist_config(reps)
    mesh_line("SYN1M hdb single-device", 1, "none", single_s, single.rep_overflow_total, 0)
    blocks = pairs.build_blocks(single, device="cuda")
    budget = 20_000_000                                    # dedup_corpus's pair_budget
    want, want_s = synced(lambda: pairs.dedupe_pairs(blocks, budget=budget, device="cuda"))
    mesh_line("SYN1M pairs single-device", 1, "none", want_s, 0, 0)
    spec10k, cfg10k = syn10k_spec()
    k10, v10 = corpus_keys(spec10k, "cuda", 1)
    single10k = hdb.hashed_dynamic_blocking(k10, v10, cfg10k, device="cuda")
    blk10k = pairs.build_blocks(single10k, device="cuda")
    want10k = pairs.dedupe_pairs(blk10k, budget=blk10k.num_pair_slots + 1, device="cuda")

    def runs(mesh):
        out = {}
        out["SYN1M hdb"] = synced(lambda: distributed.distributed_hashed_dynamic_blocking(
            keys, valid, cfg, mesh, dist=dcfg, device="cuda"))
        out["SYN1M routed sampled"] = synced(lambda: caught_capacity(
            lambda: pairs.dedupe_pairs(blocks, budget=budget, backend="distributed",
                                       mesh=mesh, device="cuda")))
        out["SYN10K hdb"] = synced(lambda: distributed.distributed_hashed_dynamic_blocking(
            k10, v10, cfg10k, mesh, device="cuda"))
        out["SYN10K routed exact"] = synced(lambda: caught_capacity(
            lambda: pairs.dedupe_pairs(blk10k, budget=blk10k.num_pair_slots + 1,
                                       backend="distributed", mesh=mesh, device="cuda")))
        return out

    with tempfile.TemporaryDirectory() as tmp:
        tdist.init_process_group("nccl", init_method=f"file://{tmp}/init", rank=0,
                                 world_size=1)
        try:
            mesh = DeviceMesh("cuda", torch.arange(1), mesh_dim_names=("data",))
            for k in kernels:
                k.launches = 0
            timed = runs(mesh)
            launches = {k.name: k.launches for k in kernels}
            checked_out = {}
            checked = check_launches(lambda: checked_out.update(runs(mesh)), kernels)
        finally:
            tdist.destroy_process_group()
    if checked != launches:
        raise AssertionError(f"mesh 7b: checked launches {checked} != timed {launches}")
    idle = [name for name in MESH_PATH if launches[name] == 0]
    if idle:
        raise AssertionError(f"mesh 7b: kernels never launched: {idle}")
    for what in ("SYN1M hdb", "SYN10K hdb"):
        res, secs = timed[what]
        if any(st.rep_overflow for st in res.stats):
            raise AssertionError(f"mesh 7b {what}: rep_overflow {res.rep_overflow_total}")
        if not same_nested(blocking_arrays(res), blocking_arrays(checked_out[what][0])):
            raise AssertionError(f"mesh 7b {what}: the checked replay differs")
        missing = hold_to_single(f"mesh 7b {what}", res,
                                 single if what.startswith("SYN1M") else single10k)
        mesh_line(what, 1, "nccl", secs, res.rep_overflow_total, 0)
        print(f"mesh 7b {what}: {len(res.rids)} assignments, {missing} missing against "
              f"the single device, {len(res.stats)} iterations", flush=True)
    for what, ref in (("SYN1M routed sampled", want), ("SYN10K routed exact", want10k)):
        (ps, warned), secs = timed[what]
        if not (same_nested(pairset_arrays(ps), pairset_arrays(ref)) and same_nested(
                pairset_arrays(ps), pairset_arrays(checked_out[what][0][0]))):
            raise AssertionError(f"mesh 7b {what}: PairSet differs from the single device")
        mesh_line(what, 1, "nccl", secs, 0, warned)
        print(f"mesh 7b {what}: {len(ps.a)} pairs (exact={ps.exact}, {ps.total_slots} "
              f"slots) equal the single device bit for bit", flush=True)
    print(f"mesh 7b: launches={launches}; the replay, every launch bit-identical to its "
          f"plain version: {checked}; SYN1M DistConfig {dcfg} for {reps} "
          "over-sized blocks", flush=True)
    return launches, dcfg, single


def same_nested(x, y):
    from repro_torch.streaming import smoke
    if isinstance(x, dict):
        return sorted(x) == sorted(y) and all(same_nested(x[k], y[k]) for k in x)
    if isinstance(x, tuple):
        x, y = list(x), list(y)
    if isinstance(x, list):
        return len(x) == len(y) and all(same_nested(a, b) for a, b in zip(x, y))
    return smoke.same_values(x, y)


def mesh_four_ranks(syn1m, dcfg, single1m, stream_ref):
    """Phase 7c: MESH_RANKS gloo ranks on the one card, spawned after the
    build. Each rank's results must equal every other rank's, its own cpu
    run (STREAM100K: phase 5b's single store) and the single-device port
    on cuda. Returns the ranks' launches."""
    import pickle
    import tempfile
    import torch.multiprocessing as mp
    from repro_torch.core import hdb, pairs
    from repro_torch.streaming import BlockStore, smoke
    with tempfile.TemporaryDirectory() as tmp:
        syn1m_path = os.path.join(tmp, "syn1m.pt")
        torch.save((syn1m[1], syn1m[2]), syn1m_path)
        skeys, svalid, parts, scfg, _, _ = stream_ref
        stream_path = os.path.join(tmp, "stream100k.pt")
        torch.save((skeys, svalid), stream_path)
        t0 = time.perf_counter()
        mp.start_processes(mesh_rank, args=(MESH_RANKS, f"file://{tmp}/init", tmp,
                                            syn1m_path, dcfg, stream_path, parts, scfg),
                           nprocs=MESH_RANKS, start_method="spawn")
        wall = time.perf_counter() - t0  # repro: noqa[R004] the spawned ranks have exited
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    first = ranks[0]
    for r, got in enumerate(ranks[1:], 1):
        for run in ("card", "host"):
            for case, vals in got[run].items():
                if not same_nested(vals[0], first[run][case][0]):
                    raise AssertionError(f"mesh 7c {case} ({run}): rank {r} differs "
                                         "from rank 0")
    for case, vals in first["host"].items():
        if not same_nested(vals[0], first["card"][case][0]):
            raise AssertionError(f"mesh 7c {case}: cuda differs from cpu")
    # the single-device port on cuda
    for name, (spec, cfg) in (("smoke", smoke.smoke_config()), ("SYN10K", syn10k_spec())):
        keys, valid = corpus_keys(spec, "cuda", MESH_RANKS)
        single = hdb.hashed_dynamic_blocking(keys, valid, cfg, device="cuda")
        got = hdb.BlockingResult(*first["card"][f"{name} hdb"][0][:3], stats=[
            hdb.IterationStats(*row) for row in first["card"][f"{name} hdb"][0][3]],
            num_records=single.num_records)
        hold_to_single(f"mesh 7c {name} hdb", got, single)
        blk = pairs.build_blocks(got, device="cuda")
        want = pairs.dedupe_pairs(blk, budget=blk.num_pair_slots + 1, device="cuda")
        if not same_nested(first["card"][f"{name} routed exact"][0], pairset_arrays(want)):
            raise AssertionError(f"mesh 7c {name}: routed dedupe differs from the "
                                 "single device")
    for run, (slack, n, card) in SHARD_RUNS.items():
        single_store = store_run(BlockStore(hdb.HDBConfig(**SHARD_CFG), device="cuda"),
                                 n, card)
        got = first["card"][f"store {run}"][0]
        if not (same_nested(got["ledger"], single_store["ledger"])
                and same_nested(got["accepted"], single_store["accepted"])):
            raise AssertionError(f"mesh 7c store {run}: differs from the single store")
        fallbacks, warned = got["counters"][1], got["counters"][3]
        if (run == "overflow") != (fallbacks > 0 and warned > 0):
            raise AssertionError(f"mesh 7c store {run}: counters {got['counters']}")
    rids, hi, lo, stats = first["card"]["SYN1M hdb"][0]
    got = hdb.BlockingResult(rids, hi, lo, [hdb.IterationStats(*row) for row in stats],
                             single1m.num_records)
    if got.rep_overflow_total:
        raise AssertionError(f"mesh 7c SYN1M: rep_overflow {got.rep_overflow_total}")
    hold_to_single("mesh 7c SYN1M hdb", got, single1m)
    got, secs, _, _ = first["card"]["STREAM100K store"]
    want, want_blk = stream_ref[4:]
    differ = [f for f, x, y in (
        ("candidate pairs", got["pairs"], [want.a, want.b, want.src_size]),
        ("accepted blocks", got["accepted"], [want_blk.key_hi, want_blk.key_lo,
                                              want_blk.start, want_blk.size,
                                              want_blk.members])) if not same_nested(x, y)]
    if differ:
        raise AssertionError(f"mesh 7c STREAM100K store: {differ} differ from phase "
                             "5b's store")
    if any(got["counters"][1:]):
        raise AssertionError(f"mesh 7c STREAM100K store: fell back at the default "
                             f"slack, counters {got['counters']}")
    print(f"mesh 7c STREAM100K store (n_shards={MESH_RANKS}, on the mesh, checked): "
          f"base_build_s={secs[0]:.4f} warm_delta_s={secs[1]:.4f} delta_ingest_s="
          f"{secs[2]:.4f} ledger_pairs={len(got['ledger'][0])}; exchange_total, "
          f"exchange_fallback_total, routed_fallback_total, warnings "
          f"{got['counters']}; candidate pairs and accepted blocks equal phase 5b's "
          f"single store", flush=True)
    first["card"]["STREAM100K store"] = (got, secs[2], 0, 0)
    counters = {run: first["card"][f"store {run}"][0]["counters"] for run in SHARD_RUNS}
    for case, (_, secs, rep_ovf, route_ovf) in first["card"].items():
        mesh_line(f"{case} (checked)", MESH_RANKS, "gloo-cuda", secs, rep_ovf, route_ovf)
    print(f"mesh 7c: {MESH_RANKS} gloo ranks on cuda:0, spawn to join {wall:.1f} s; every "
          f"rank equal to rank 0, to its cpu run and to the single-device port on cuda; "
          f"store counters (exchange_total, exchange_fallback_total, "
          f"routed_fallback_total, warnings) "
          f"{counters}; "
          f"launches (rank 0, each held against its plain version): {first['launches']}",
          flush=True)
    return first["launches"]


def mesh_phase(kernels, syn1m, stream_ref):
    """Phase 7. Returns the launch counts of the one-rank runs and of rank
    0 of the four-rank runs."""
    t_phase = time.perf_counter()
    launches, dcfg, single1m = mesh_one_rank(kernels, syn1m)
    torch.cuda.empty_cache()
    print(f"phase 7b: phase_s={time.perf_counter() - t_phase:.1f}", flush=True)  # repro: noqa[R004] phase wall time, printed only
    gloo_launches = mesh_four_ranks(syn1m, dcfg, single1m, stream_ref)
    print(f"phase 7: phase_s={time.perf_counter() - t_phase:.1f}", flush=True)
    return launches, gloo_launches


# ---------------------------------------------------------------------------
# phase 8: serving (the DedupeService and the LM ServingEngine)
# ---------------------------------------------------------------------------

# benchmarks/bench_serving.py's workload at its defaults: a 50,000-record
# store of the streaming bench's key layout, 2,048 probe rows at client
# batch sizes 1, 8 and 64
SERVE_RECORDS = 50_000
SERVE_PROBES = 2_048
SERVE_BATCH_SIZES = (1, 8, 64)
# probe rows also answered by the same service on the cpu
SERVE_CPU_ROWS = 256
# the batch size replayed with every launch checked, and profiled
SERVE_CHECKED_BATCH = 8
# kernels the probe walk and the write lane must launch (the walk's
# intersections; the ingest's sketch folds, intersections and ledger sync)
SERVE_PROBE_PATH = ("combine64",)
SERVE_INGEST_PATH = ("cms_update", "combine64", "tri_decode", "radix_sort",
                     "radix_digit_counts")
# the LM engine: tinyllama-1.1b as published, 16 requests of 2-32 prompt
# tokens over 8 slots, 32 new tokens each; admission prefills one token a
# step, so the shared pos stays well under max_len
LM_ARCH = "tinyllama-1.1b"
LM_SLOTS = 8
LM_REQUESTS = 16
LM_MAX_NEW = 32
LM_MAX_LEN = 1024
# the cuda == cpu check: the same widths at 2 layers in float32, TF32 off;
# first-step logits within 1e-3 (float32 products summed in another order
# over d_model 2048 and d_ff 5632)
LM_CHECK_LAYERS = 2
LM_LOGIT_ATOL = 1e-3


def serve_answers(svc):
    """The service's probe responses in uid order: (statuses, the
    comparable arrays of every answered row)."""
    from repro_torch.serving import smoke as serve_smoke
    resp = sorted(svc.probe_responses, key=lambda r: r.uid)
    rows = [row for r in resp for row in serve_smoke.result_arrays(r.results)]
    return [r.status for r in resp], rows


def serve50k():
    """SERVE50K at benchmarks/bench_serving.py's defaults: returns
    ``service(device, n_shards=1)``, a DedupeService with the 50,000-record
    store queued on its write lane, and ``probes(svc, b, rows)``, which
    submits the first ``rows`` probe rows in client batches of ``b`` and
    runs the service; and the probe rows (numpy u64 keys, validity)."""
    from repro_torch.core import hdb, u64
    from repro_torch.serving import DedupeService, ServiceConfig
    cfg = hdb.HDBConfig(max_block_size=64, max_iterations=6, cms_width=1 << 16)
    base = ServiceConfig(probe_slots=64, ingest_slots=1 << 20, max_read_queue=1 << 20,
                         max_write_queue=64)
    n, p = SERVE_RECORDS, SERVE_PROBES
    keys, valid = stream_keys(0, n + p, n + p)
    keys, valid = u64.to_numpy_u64(keys), valid.cpu().numpy()
    probe_k, probe_v = keys[n:], valid[n:]

    def service(device, n_shards=1):
        svc = DedupeService(cfg, dataclasses.replace(base, n_shards=n_shards),
                            device=device)
        svc.add_tenant("t")
        svc.submit_ingest("t", keys[:n], valid[:n])
        return svc

    def probes(svc, b, rows=p):
        for off in range(0, rows, b):
            svc.submit_probe("t", probe_k[off:off + b], probe_v[off:off + b])
        svc.run()

    return service, probes, probe_k, probe_v


def serving_service(kernels):
    """Phase 8a. The store built through the write lane (launches counted),
    a warm-up round a batch size, then the timed pass of every batch size
    (launch counts zeroed before and read after each); returns the summed
    probe launches and the ingest's."""
    from repro_torch.serving import smoke as serve_smoke
    from repro_torch.streaming.delta import probe_jit_cache_sizes
    t_phase = time.perf_counter()
    n, p = SERVE_RECORDS, SERVE_PROBES
    service, probes, probe_k, probe_v = serve50k()

    svc = service("cuda")
    for k in kernels:
        k.launches = 0
    _, build_s = synced(svc.run)
    ingest_launches = {k.name: k.launches for k in kernels}
    store = svc.tenant("t").store
    print(f"serving: a store of {n} records through the write lane, "
          f"{len(store.led_pack)} candidate pairs, build_s={build_s:.4f} "
          f"launches={ingest_launches}", flush=True)
    idle = [name for name in SERVE_INGEST_PATH if ingest_launches[name] == 0]
    if idle:
        raise AssertionError(f"serving: the write lane never launched {idle}")

    for b in SERVE_BATCH_SIZES:
        synced(lambda: probes(svc, b, rows=b))
    shapes_warm = probe_jit_cache_sizes()
    compiles_warm = svc.snapshot()["counters"]["bucket_compiles_total"]
    print(f"serving: warm-up, {compiles_warm} bucket shapes, walk shapes "
          f"{shapes_warm}", flush=True)
    answers, per_batch, new_buckets = {}, {}, 0
    for b in SERVE_BATCH_SIZES:
        svc.metrics.reset()
        svc.probe_responses.clear()
        for k in kernels:
            k.launches = 0
        _, secs = synced(lambda: probes(svc, b))
        per_batch[b] = {k.name: k.launches for k in kernels}
        snap = svc.snapshot()
        # metrics.reset() zeroed the counter: any count is a new shape
        new_buckets += snap["counters"]["bucket_compiles_total"]
        rows = snap["counters"]["probe_rows_total"]
        lat = snap["histograms"]["probe_latency_s"]
        occ = snap["histograms"]["batch_occupancy"]
        print(f"serving,b={b},{rows / secs},{lat['p50'] * 1e3},{lat['p99'] * 1e3},"
              f"{occ['mean']},{snap['counters']['probe_batches_total']}", flush=True)
        statuses, answers[b] = serve_answers(svc)
        if rows != p or len(answers[b]) != p or set(statuses) != {"ok"}:
            raise AssertionError(f"serving b={b}: {rows} rows served of {p}, "
                                 f"statuses {set(statuses)}")
    shapes_end = probe_jit_cache_sizes()
    if shapes_end != shapes_warm or new_buckets:
        raise AssertionError(f"serving: shapes grew after the warm-up: walk "
                             f"{shapes_warm} -> {shapes_end}, {new_buckets} new "
                             "bucket shapes")
    probe_launches = {k.name: sum(c[k.name] for c in per_batch.values()) for k in kernels}
    idle = [name for name in SERVE_PROBE_PATH if probe_launches[name] == 0]
    if idle:
        raise AssertionError(f"serving: the probe walk never launched {idle}")
    print(f"serving: walk shapes {shapes_end} and no new bucket shape after every "
          f"batch size (unchanged since the warm-up); probe launches by batch size "
          f"{per_batch}", flush=True)

    want = answers[SERVE_BATCH_SIZES[0]]
    if any(not serve_smoke.same(answers[b], want) for b in SERVE_BATCH_SIZES):
        raise AssertionError("serving: answers differ between batch sizes")
    blocker = svc.tenant("t").blocker

    def solo():
        for i in range(p):
            got = blocker.query_keys(probe_k[i:i + 1], probe_v[i:i + 1])
            if not serve_smoke.same(serve_smoke.result_arrays(got)[0], want[i]):
                raise AssertionError(f"serving: row {i} differs from a solo query_keys")

    _, solo_s = synced(solo)
    print(f"serving: every row equals a solo query_keys on the card "
          f"({p} solo walks in {solo_s:.1f} s)", flush=True)

    # the checked replay, then the profiled one, of one batch size
    svc.probe_responses.clear()
    checked = check_launches(lambda: probes(svc, SERVE_CHECKED_BATCH), kernels)
    if checked != per_batch[SERVE_CHECKED_BATCH] or not serve_smoke.same(
            serve_answers(svc)[1], want):
        raise AssertionError(f"serving: the checked b={SERVE_CHECKED_BATCH} replay "
                             f"({checked}) differs from the timed pass")
    print(f"serving: b={SERVE_CHECKED_BATCH} replayed, every launch bit-identical "
          f"to its plain version: {checked}", flush=True)
    svc.probe_responses.clear()
    profile_breakdown(lambda: probes(svc, SERVE_CHECKED_BATCH),
                      tag=f"serving b={SERVE_CHECKED_BATCH}")

    # a 4-shard tenant, its ingest checked launch by launch
    sharded = service("cuda", n_shards=4)
    sharded_ingest = check_launches(sharded.run, kernels)
    probes(sharded, 64)
    if not serve_smoke.same(serve_answers(sharded)[1], want):
        raise AssertionError("serving: the 4-shard tenant answers differently")
    if not (np.array_equal(sharded.tenant("t").store.led_pack, store.led_pack)):
        raise AssertionError("serving: the 4-shard tenant's ledger differs")
    print(f"serving: a 4-shard tenant (ingest checked launch by launch: "
          f"{sharded_ingest}) answers all {p} rows equally; snapshot gauges "
          f"{sharded.snapshot()['gauges']}", flush=True)
    del sharded

    # the same service on the cpu; refresh_clusters on both
    cpu = service("cpu")
    _, cpu_s = synced(cpu.run)
    probes(cpu, 64, rows=SERVE_CPU_ROWS)
    if not serve_smoke.same(serve_answers(cpu)[1], want[:SERVE_CPU_ROWS]):
        raise AssertionError("serving: the cpu service answers differently")
    got, refresh_s = synced(lambda: svc.refresh_clusters("t"))
    ref = cpu.refresh_clusters("t")
    if not (np.array_equal(got.label, ref.label)
            and np.array_equal(got.survivors, ref.survivors)
            and (got.converged, got.rounds) == (ref.converged, ref.rounds)):
        raise AssertionError("serving: refresh_clusters differs cuda vs cpu")
    print(f"serving: the cpu service (store built in {cpu_s:.1f} s) answers the first "
          f"{SERVE_CPU_ROWS} rows equally; refresh_clusters on the card "
          f"refresh_s={refresh_s:.4f}: {len(got.survivors)} clusters in {got.rounds} "
          f"rounds (converged {got.converged}), equal to the cpu run; gauges "
          f"{svc.snapshot()['gauges']}", flush=True)
    print(f"phase 8a: phase_s={time.perf_counter() - t_phase:.1f}", flush=True)
    return probe_launches, ingest_launches


def serving_lm():
    """Phase 8b: tinyllama-1.1b at full width (bfloat16, seeded weights on
    the card) through the ServingEngine, timed with CUDA events; then the
    same widths at LM_CHECK_LAYERS layers in float32 on cuda and cpu."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving import smoke as serve_smoke
    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    n_params = sum(w.numel() for w in build_model(cfg, device="meta").parameters())
    want_params = cfg.total_params() + 2 * cfg.num_layers * cfg.d_model + cfg.d_model
    if n_params != want_params:
        raise AssertionError(f"lm: {n_params} parameters, want {want_params}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))
    reqs = serve_smoke.lm_requests(cfg.vocab_size, LM_REQUESTS, LM_MAX_NEW)
    serve_smoke.engine_run(model, [(0, reqs[0][1][:2], 2)], LM_SLOTS, LM_MAX_LEN)
    eng = ServingEngine(model, batch_slots=LM_SLOTS, max_len=LM_MAX_LEN)
    for uid, prompt, max_new in reqs:
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=max_new, eos_id=-1))
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    results = eng.run()
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = eng.pos   # each decode step advances the shared pos by one
    tokens = [t for r in results for t in r.tokens]
    if not (len(results) == LM_REQUESTS and len(tokens) == LM_REQUESTS * LM_MAX_NEW
            and all(0 <= t < cfg.vocab_size for t in tokens) and steps < LM_MAX_LEN):
        raise AssertionError(f"lm: {len(results)} results, {len(tokens)} tokens, "
                             f"pos {steps} of max_len {LM_MAX_LEN}")
    print(f"lm: {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.param_dtype}; {n_params} parameters, equal to "
          f"total_params plus the norms) served {LM_REQUESTS} requests over "
          f"{LM_SLOTS} slots: served_tokens={len(tokens)} decode_steps={steps} "
          f"step_ms={start.elapsed_time(end) / steps} wall_s={wall} "
          f"tokens_per_s={len(tokens) / wall} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()}", flush=True)
    # where a decode step's time goes: ten steps of the full batch, profiled
    tok = torch.ones((LM_SLOTS, 1), dtype=torch.int32, device="cuda")
    profile_breakdown(lambda: [model.decode_step(tok, eng.caches) for _ in range(10)],
                      tag="lm decode x10")
    del model, eng
    torch.cuda.empty_cache()

    small = dataclasses.replace(cfg, num_layers=LM_CHECK_LAYERS, param_dtype="float32",
                                compute_dtype="float32")
    cpu = build_model(small, device="cpu")
    card = build_model(small, device="cuda")
    card.load_state_dict(cpu.state_dict())
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        got = serve_smoke.engine_run(card, reqs, LM_SLOTS, LM_MAX_LEN)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    want, cpu_s = synced(lambda: serve_smoke.engine_run(cpu, reqs, LM_SLOTS, LM_MAX_LEN))
    err = float((got["first_logits"] - want["first_logits"]).abs().max())
    if not (got["tokens"] == want["tokens"] and got["pos"] == want["pos"]
            and err <= LM_LOGIT_ATOL):
        differ = [u for u in want["tokens"] if got["tokens"].get(u) != want["tokens"][u]]
        raise AssertionError(f"lm check: requests {differ} differ cuda vs cpu, first-step "
                             f"logits max_abs_err {err}")
    print(f"lm check: {LM_CHECK_LAYERS} layers at the same widths in float32 (TF32 "
          f"off): the same {LM_REQUESTS} requests give equal tokens on cuda and cpu "
          f"(cpu run {cpu_s:.1f} s); first-step logits max_abs_err={err} "
          f"(tolerance {LM_LOGIT_ATOL})", flush=True)
    print(f"phase 8b: phase_s={time.perf_counter() - t_phase:.1f}", flush=True)


# ---------------------------------------------------------------------------
# phase 9: training (launch/train.py, training/)
# ---------------------------------------------------------------------------

# the launcher on tinyllama-1.1b as published, at its defaults (--dedup of
# 3,000 entities, batch 8, seq 256): 12 steps, a checkpoint every 6, then a
# run resumed from step 6
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_STEPS = 12
TRAIN_CKPT_EVERY = 6
TRAIN_PROFILED_STEPS = 2
# the cuda == cpu check: the same widths at 2 layers in float32, TF32 off,
# wq and wk scaled by 1/8 (wq's init at fan-in d_model: the reference's
# fan-in of 32 heads makes the softmax sharp enough that float32 rounding,
# amplified by AdamW's first update, parts two devices' runs);
# tests/test_torch_training.py's rtol for loss, ce and grad_norm
TRAIN_CHECK_LAYERS = 2
TRAIN_CHECK_STEPS = 3
TRAIN_CHECK_QK_SCALE = 0.125
TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ = 2, 64
TRAIN_RTOL = 1e-4


def training_full_width(kernels):
    """Phase 9a. Returns the first run's dedup launch counts."""
    from repro_torch.launch import train
    from repro_torch.training.train_loop import make_train_step
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    ckpt = os.path.join(root, "ckpt")
    argv = ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--dedup",
            "--ckpt-every", str(TRAIN_CKPT_EVERY), "--ckpt-dir", ckpt]
    try:
        print(f"train: disk free under {root}: {shutil.disk_usage(root).free} bytes",
              flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for k in kernels:
            k.launches = 0
        checked = check_launches(lambda: runs.append(train.main(argv)), kernels)
        launches = {k.name: k.launches for k in kernels}
        peak = torch.cuda.max_memory_allocated()
        if checked != launches:
            raise AssertionError(f"train: checked launches {checked} != counted {launches}")
        run = runs.pop()
        cfg, lcfg = run.model.cfg, run.loader.cfg
        losses = np.asarray(run.losses)
        if not (len(losses) == TRAIN_STEPS and np.isfinite(losses).all()
                and int(run.state["step"]) == TRAIN_STEPS):
            raise AssertionError(f"train: losses {run.losses}, step {int(run.state['step'])}")
        timed = run.step_ms[1:]
        tokens = lcfg.batch_size * lcfg.seq_len
        print(f"train: {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}, "
              f"{cfg.param_dtype}, remat {cfg.remat}) batch {lcfg.batch_size} seq "
              f"{lcfg.seq_len}: {TRAIN_STEPS} steps, loss first={losses[0]} "
              f"last={losses[-1]}; steps 2-{TRAIN_STEPS} step_ms={np.mean(timed)} "
              f"(min {min(timed)} max {max(timed)}) tokens_per_s="
              f"{tokens * len(timed) / (sum(timed) / 1e3)}; first step_ms={run.step_ms[0]}; "
              f"max_memory_allocated={peak}", flush=True)
        print(f"train: dedup launches (each held against its plain version) "
              f"{launches}; not launched: {[n for n, c in launches.items() if c == 0]}",
              flush=True)
        for step, secs, size in run.saves:
            print(f"train: checkpoint at step {step}: {size} bytes saved in {secs} s",
                  flush=True)
        want_batch = run.loader.batch(TRAIN_CKPT_EVERY)
        first_losses = run.losses
        del run
        torch.cuda.empty_cache()

        # killed after step 6's checkpoint: step 12's never written
        shutil.rmtree(os.path.join(ckpt, f"step_{TRAIN_STEPS:010d}"))
        with open(os.path.join(ckpt, "LATEST"), "w") as f:
            f.write(str(TRAIN_CKPT_EVERY))
        for k in kernels:
            k.launches = 0
        checked2 = check_launches(lambda: runs.append(train.main(argv)), kernels)
        run = runs.pop()
        if checked2 != launches:
            raise AssertionError(f"train resume: dedup launches {checked2} != {launches}")
        got_batch = run.loader.batch(TRAIN_CKPT_EVERY)
        if not (run.start == TRAIN_CKPT_EVERY and int(run.state["step"]) == TRAIN_STEPS
                and len(run.losses) == TRAIN_STEPS - TRAIN_CKPT_EVERY
                and np.isfinite(run.losses).all()
                and all(torch.equal(a, b) for a, b in zip(got_batch, want_batch))):
            raise AssertionError(f"train resume: start {run.start}, step "
                                 f"{int(run.state['step'])}, losses {run.losses}")
        print(f"train: resumed from step {run.start} to {int(run.state['step'])}; the "
              f"loader's batch at step {TRAIN_CKPT_EVERY} equals the first run's; losses "
              f"{run.losses} (first run {first_losses[TRAIN_CKPT_EVERY:]})", flush=True)

        step_fn = make_train_step(run.model, run.tcfg)
        state = run.state

        def steps():
            nonlocal state
            for i in range(TRAIN_PROFILED_STEPS):
                x, y = run.loader.batch(TRAIN_STEPS + i)
                state, _ = step_fn(state, {"tokens": x, "targets": y})

        _, wall, busy, n_launch, ranges = profile_breakdown(
            steps, tag=f"train x{TRAIN_PROFILED_STEPS}")
        opt_s = ranges["train.optimizer"]
        print(f"train: a profiled step: wall_ms={wall / TRAIN_PROFILED_STEPS * 1e3} "
              f"device_busy_ms={busy / TRAIN_PROFILED_STEPS * 1e3} "
              f"launches={n_launch / TRAIN_PROFILED_STEPS}; the optimizer's kernels "
              f"device_ms={opt_s / TRAIN_PROFILED_STEPS * 1e3} ({opt_s / busy:.4f} of "
              f"the device time)", flush=True)
        del run, state, step_fn
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"phase 9a: phase_s={time.perf_counter() - t_phase:.1f}", flush=True)  # repro: noqa[R004] phase wall time, printed only
    return launches


def training_check():
    """Phase 9b: cuda == cpu at 2 layers in float32, and the deterministic
    resume in a process of its own."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.training import smoke
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), num_layers=TRAIN_CHECK_LAYERS,
                              param_dtype="float32", compute_dtype="float32")
    init = build_model(cfg, device="cpu").state_dict()
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    errs = {}
    try:
        for scale, n in ((TRAIN_CHECK_QK_SCALE, TRAIN_CHECK_STEPS), (1.0, 1)):
            out = {}
            for dev in ("cuda", "cpu"):
                model = build_model(cfg, device=dev)
                model.load_state_dict(init)
                smoke.scale_qk(model, scale)
                bs = smoke.batches(cfg, n, TRAIN_CHECK_BATCH, TRAIN_CHECK_SEQ, dev)
                out[dev] = smoke.train_steps(model, bs)[1]
                del model
            errs[scale] = [max(abs(g[k] - w[k]) / abs(w[k]) for k in ("loss", "ce", "grad_norm"))
                           for g, w in zip(out["cuda"], out["cpu"])]
            print(f"train check: qk scale {scale}, {n} steps: cuda losses "
                  f"{[m['loss'] for m in out['cuda']]} cpu {[m['loss'] for m in out['cpu']]}; "
                  f"max relative error of loss, ce, grad_norm a step {errs[scale]}", flush=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()
    if max(errs[TRAIN_CHECK_QK_SCALE]) > TRAIN_RTOL:
        raise AssertionError(f"train check: cuda vs cpu {errs[TRAIN_CHECK_QK_SCALE]} over "
                             f"rtol {TRAIN_RTOL}")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.training.smoke", "--arch", TRAIN_ARCH,
         "--layers", str(TRAIN_CHECK_LAYERS)],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"train resume check failed ({proc.returncode}):\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-4000:]}")
    print(f"train check: deterministic resume on the card, bit-identical: "
          f"{proc.stdout.strip().splitlines()[-1]}", flush=True)
    print(f"phase 9b: phase_s={time.perf_counter() - t_phase:.1f}", flush=True)  # repro: noqa[R004] phase wall time, printed only


# ---------------------------------------------------------------------------
# phase 10: host-sync census (repro_torch.analysis.sync_census)
# ---------------------------------------------------------------------------

# sites printed a run, heaviest first
CENSUS_TOP = 10
CENSUS_TRAIN_STEPS = 2


def census(tag, run):
    """One untimed run of ``run`` under the sync census: prints the total,
    the syncs per profiler range and the heaviest sites with their
    inventory reasons; fails when the census saw no sync (the debug mode
    did not report), a sync with no frame in the port, or a site that is
    not in the inventory."""
    from repro_torch.analysis.sync_census import SyncCensus
    torch.cuda.synchronize()
    with SyncCensus() as c:
        run()
    torch.cuda.synchronize()
    for line in c.lines(tag, CENSUS_TOP):
        print(line, flush=True)
    if not c.armed or c.total == 0:
        raise AssertionError(f"census {tag}: {c.total} syncs (armed {c.armed}): the "
                             "sync debug mode reported nothing")
    if c.outside:
        raise AssertionError(f"census {tag}: syncs with no frame in the port at "
                             f"{sorted(c.outside)}")
    c.check()
    return c


def host_sync_census(syn1m):
    """Phase 10: the census over one untimed run of each path: SYN1M
    through dedup_corpus(blocker="hdb"), a STREAM100K delta, a SERVE50K
    probe pass at client batch 8, a TINYLLAMA-SERVE decode step, and
    launch/train.py --dedup for CENSUS_TRAIN_STEPS steps."""
    from repro_torch.configs import get_config
    from repro_torch.core import hdb
    from repro_torch.data import pipeline
    from repro_torch.launch import train
    from repro_torch.models.model import build_model
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving import smoke as serve_smoke
    from repro_torch.streaming import BlockStore, DeltaBlocker
    t_phase = time.perf_counter()
    totals = {}

    corpus = moved(*syn1m, "cuda")[0]
    totals["SYN1M"] = census("SYN1M hdb", lambda: pipeline.dedup_corpus(
        corpus, hdb.HDBConfig(max_block_size=200), blocker="hdb", device="cuda")).total
    del corpus
    torch.cuda.empty_cache()

    n, d = STREAM_RECORDS, STREAM_DELTA
    keys, valid = stream_keys(0, n + 2 * d, n + 2 * d)
    blk = DeltaBlocker(BlockStore(stream100k_config(), device="cuda"))
    blk.ingest_keys(keys[:n], valid[:n])
    blk.ingest_keys(keys[n:n + d], valid[n:n + d])
    totals["STREAM100K"] = census("STREAM100K delta", lambda: blk.ingest_keys(
        keys[n + d:], valid[n + d:])).total
    del blk, keys, valid

    service, probes = serve50k()[:2]
    svc = service("cuda")
    svc.run()
    probes(svc, SERVE_CHECKED_BATCH, rows=SERVE_CHECKED_BATCH)
    totals["SERVE50K"] = census(f"SERVE50K b={SERVE_CHECKED_BATCH}",
                                lambda: probes(svc, SERVE_CHECKED_BATCH)).total
    del svc

    cfg = get_config(LM_ARCH)
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))
    eng = ServingEngine(model, batch_slots=LM_SLOTS, max_len=LM_MAX_LEN)
    for uid, prompt, max_new in serve_smoke.lm_requests(cfg.vocab_size, LM_SLOTS,
                                                         LM_MAX_NEW):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=max_new, eos_id=-1))
    eng.step()  # admits (prefills) every slot
    totals["TINYLLAMA-SERVE"] = census("TINYLLAMA-SERVE decode step", eng.step).total
    del model, eng
    torch.cuda.empty_cache()

    root = tempfile.mkdtemp(prefix="chip_smoke_census_")
    try:
        argv = ["--arch", TRAIN_ARCH, "--steps", str(CENSUS_TRAIN_STEPS), "--dedup",
                "--ckpt-every", str(CENSUS_TRAIN_STEPS + 1), "--ckpt-dir", root]
        totals["TINYLLAMA-TRAIN"] = census(
            f"TINYLLAMA-TRAIN train.main --steps {CENSUS_TRAIN_STEPS} --dedup",
            lambda: train.main(argv)).total
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"census: syncs a run {totals}; every site in the inventory", flush=True)
    print(f"phase 10: phase_s={time.perf_counter() - t_phase:.1f}", flush=True)  # repro: noqa[R004] phase wall time, printed only


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {sorted(libs)} in {time.perf_counter() - t0:.1f} s", flush=True)  # repro: noqa[R004] nvcc builds on the host

    smoke_pipeline()
    kernels = all_kernels()
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
    torch.cuda.empty_cache()
    table2_launches = table2(kernels, syn1m)
    torch.cuda.empty_cache()
    mesh_launches, mesh_gloo_launches = mesh_phase(kernels, syn1m, stream_ref)
    del stream_ref
    torch.cuda.empty_cache()
    serve_probe_launches, serve_ingest_launches = serving_service(kernels)
    serving_lm()
    train_launches = training_full_width(kernels)
    training_check()
    host_sync_census(syn1m)
    del syn1m
    for row in rows:
        row["launches"] = launches[row["name"]]
        row["stream100k_delta_launches"] = stream_launches[row["name"]]
        row["syn_stream_launches"] = syn_launches[row["name"]]
        row["sharded_delta_launches"] = sharded_launches[row["name"]]
        row["table2_syn1m_launches"] = table2_launches[row["name"]]
        row["mesh_launches"] = mesh_launches[row["name"]]
        row["mesh_gloo_launches"] = mesh_gloo_launches[row["name"]]
        row["serving_probe_launches"] = serve_probe_launches[row["name"]]
        row["serving_ingest_launches"] = serve_ingest_launches[row["name"]]
        row["train_dedup_launches"] = train_launches[row["name"]]
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
