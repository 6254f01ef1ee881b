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
      8 slots, 16 new tokens each, max_len 1024, timed with CUDA events;
      ten more decode steps profiled; then the same widths at 2 layers in float32 (TF32 off) on cuda and
      cpu: equal tokens, first-step logits within 1e-3;
   c. the MoE family and MLA: OLMOE-SERVE (olmoe-1b-7b as published) and
      DEEPSEEK-SERVE (deepseek-v3-671b at its published widths cut to 4
      layers: 3 dense-FFN MLA layers, 1 MoE layer, the MTP head), each
      with its parameter count checked on the meta device, phase 8b's
      traffic timed with CUDA events (the dropped tokens summed), ten
      decode steps profiled and one Model.loss forward at full width
      (finite ce, moe_aux, mtp_ce); then cuda == cpu in float32 (TF32
      off) at olmoe's widths on 1 layer and at deepseek's reduced
      config: first-step logits within 1e-3 and equal tokens, or tokens
      that part only after a routing near tie (margin under 1e-5),
      printed;
   d. the recurrent mixers: RWKV6-SERVE (rwkv6-1.6b as published, the
      WKV's step form) and JAMBA-SERVE (jamba-1.5-large-398b at its
      published widths cut to 4 of 72 layers: three Mamba layers, two of
      them with MoE FFNs, and the attention layer), each as 8c's cells
      (parameter count on the meta device, 8b's traffic, the dropped
      tokens, ten profiled decode steps, one full-width Model.loss); then
      cuda == cpu in float32 (TF32 off) at rwkv6's widths on 1 layer
      (equal tokens) and at jamba's reduced config (8c's rule);
   e. the encoder-decoder and VLM families: WHISPER-SERVE (whisper-medium
      as published, its parameter count checked on the meta device): 8
      requests of 1500 seeded frames and 4-token prompts through
      Model.encode, Model.prefill and 16 greedy decode steps with
      {"enc_out"} (the engine cannot serve this family), encode, prefill
      and step ms from CUDA events, ten decode steps profiled, one
      full-size Model.loss; INTERNVL-SERVE (internvl2-76b at its
      published widths cut to 16 of 80 layers) as 8c's cells, then a
      patch prefill of 8 x (256 patches + 16 tokens) and 16 decode
      steps, timed; then cuda == cpu in float32 (TF32 off) at the reduced
      configs: whisper's encode, prefill and 8 decode steps (logits
      within 1e-4 of the largest, equal tokens), internvl's engine
      (8c's rule) and its patch prefill (logits within 1e-3, equal
      tokens);
9. training (``repro_torch.launch.train``, ``repro_torch.training``):
   a. the launcher on tinyllama-1.1b as published (bfloat16, seeded
      weights on the card, remat "full"), --dedup at its defaults (3,000
      entities, batch 8, seq 256), 12 steps with a checkpoint at step 7,
      every dedup kernel launch held against its plain version (launch
      counts zeroed just before and read just after); every loss finite;
      the CUDA-event step time of steps 2-12, tokens/s, peak memory, the
      checkpoint's size and save time; then a second run resumed from
      step 7's checkpoint to step 12 (step counter, the loader's batch at
      step 7 equal to the first run's); two more steps profiled (idle
      share, launches a step, top device kernels) and the optimizer's
      device time;
   b. the same widths at 1 layer in float32 (TF32 off) from the same
      weights on cuda and cpu: 3 train steps with wq and wk scaled by
      1/8 give loss, ce and grad_norm within rtol 1e-4; one step at the
      unscaled init is printed beside them; and, in a process of its own
      with deterministic kernels (``python -m repro_torch.training.smoke``),
      a run resumed from a checkpoint halfway bit-identical to the
      uninterrupted run;
   c. OLMOE-TRAIN: olmoe-1b-7b's widths at 15 of 16 layers (bfloat16,
      remat "full") through the train step on the launcher's deduplicated
      loader (batch 8, seq 256): 6 steps, steps 2-6 timed with CUDA
      events, every loss finite, moe_aux and moe_dropped a step, peak
      memory; two more steps profiled; then both families' reduced
      configs in float32 (TF32 off) on cuda and cpu: 3 train steps give
      loss, ce, moe_aux and grad_norm within rtol 1e-4;
   d. RWKV6-TRAIN: rwkv6-1.6b's widths at 2 of 24 layers through the
      train step as 9c (6 steps, steps 2-6 timed, one more profiled);
      then the reduced rwkv6 and jamba configs cuda == cpu as 9c holds
      its families;
   e. WHISPER-TRAIN: whisper-medium as published through the train step
      (bfloat16, remat "full") on train_batch(cfg, 1500, 8): 6 steps,
      steps 3-6 timed with CUDA events, frames and tokens a second, every
      loss finite, peak memory; one more step profiled; then the reduced
      config cuda == cpu as 9c holds its families;
   f. MESH-OLMOE-TRAIN: olmoe-1b-7b's widths at 4 of 16 layers on four
      gloo ranks spawned on the card, a (2, 2) ("data", "model") mesh
      under production_rules, through launch/train.main(argv, mesh=...)
      with --dedup (every dedup launch held against its plain version on
      each rank): 2 steps, step 2 timed (the slowest rank), tokens a
      second, peak memory a rank, every rank's losses finite; one more
      step, profiled on rank 0 and under the sync census on the others;
      then one batch at capacity factor 8 in float32 by the psum and the
      a2a dispatch and a one-rank meshless model of the same weights: each
      rank's logits within MESH_LOGITS_RTOL of each other, the
      cross-entropies within MESH_CE_RTOL, nothing dropped, and two
      planted faults outside the logits' bound;
   g. every other family on the same ranks and mesh at its published
      widths, cut in depth: DEEPSEEK-MESH-TRAIN (1 layer of MLA and the
      MTP head), JAMBA-MESH-TRAIN (1 Mamba+MoE layer, 2 experts) and
      RWKV6-MESH-TRAIN (2 layers) through the launcher with --dedup
      (every dedup launch held against its plain version on each rank),
      WHISPER-MESH-TRAIN (2 + 2 layers) through make_train_step: 2 steps,
      the first profiled on rank 0, the second timed (the slowest rank),
      tokens (frames) a second, peak memory a rank, losses equal on every
      rank, the sync census on ranks 1-3; then each family's float32
      check at one layer: each rank's logits within FAMILY_LOGITS_RTOL
      (median token FAMILY_TOKEN_RTOL) of a one-rank meshless model, ce
      within MESH_CE_RTOL, and a planted fault outside the bounds;
10. host-sync census (``repro_torch.analysis.sync_census``): one untimed
    run of each path under torch's sync debug mode, none of them timed:
    SYN1M through dedup_corpus(blocker="hdb"), a STREAM100K delta, a
    SERVE50K probe pass at client batch 8, a TINYLLAMA-SERVE decode step,
    launch/train.py --dedup for two TINYLLAMA-TRAIN steps, an OLMOE-SERVE
    and a DEEPSEEK-SERVE decode step, two OLMOE-TRAIN steps, an
    RWKV6-SERVE and a JAMBA-SERVE decode step, two RWKV6-TRAIN steps
    (2 layers), a WHISPER-SERVE decode step, INTERNVL-SERVE's patch
    prefill and two WHISPER-TRAIN steps.
    Each prints its total syncs, the syncs per profiler range and its ten heaviest
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
``train_dedup_launches`` from phase 9a's first run,
``mesh_train_launches`` from rank 0 of phase 9f); the last line is
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
# time on an H100, at 100,000 about 21 s (PERF.md section 4), and 50,000
# since phases 8e and 9e came, 25,000 since phase 9f came; and from ten
# deltas to one: each costs about 20 s at 100,000, twice with its checked
# replay; four kept the script too near its time limit once phases 8d and
# 9d came
SYN_STREAM_ENTITIES = 25_000
SYN_STREAM_DELTAS = 1
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


def profile_breakdown(run, tag="SYN1M", host=True):
    """Run ``run`` under torch.profiler; print the stage ranges, the
    device's busy time and idle share of the wall time, the top device
    kernels and the top host ops, each line marked with ``tag``. Returns
    (run's result, wall seconds, device busy seconds, device launches,
    {range: device seconds of the kernels its ops launched}). Without
    ``host`` only the device is traced (no ranges, no host ops): a run of
    tens of thousands of launches reads back in seconds, not minutes."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU] if host else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
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
    if not host:
        return out, wall, busy, launches, {}
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
# tokens over 8 slots, 16 new tokens each (32 until phase 9g came, for
# the script's time); admission prefills one token a
# step, so the shared pos stays well under max_len
LM_ARCH = "tinyllama-1.1b"
LM_SLOTS = 8
LM_REQUESTS = 16
LM_MAX_NEW = 16
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


def lm_param_count(cfg):
    """``cfg.total_params()`` plus the weights it leaves out: two norms a
    layer and the final one, MLA's q_norm and kv_norm a layer, the MTP
    head (one more layer with the dense FFN, its norms, and the (2d, d)
    ``mtp_proj``), and what it miscounts of the recurrent mixers: it takes
    an RWKV block for ``6d^2 + 2d`` (it holds five (d, d) matrices, the
    decay LoRA and eight vectors of d) and leaves out a Mamba layer's
    ``conv``, ``w_dt``, ``w_dt_out``, ``a_log``, ``dt_bias`` and
    ``d_skip``. For the encdec family: ``total_params()`` plus ``dec_pos``
    (65,536 rows) and the layer norms' weights and biases and the MLP
    biases it leaves out."""
    d = cfg.d_model
    if cfg.family == "encdec":
        return (cfg.total_params() + (1 << 16) * d + cfg.encoder_layers * (5 * d + cfg.d_ff)
                + cfg.decoder_layers * (7 * d + cfg.d_ff) + 4 * d)
    per_layer = 2 * d + (cfg.q_lora_rank + cfg.kv_lora_rank if cfg.use_mla else 0)
    n = cfg.total_params() + cfg.num_layers * per_layer + d
    if cfg.mtp:
        head = dataclasses.replace(cfg, num_layers=1, moe_num_experts=0, vocab_size=0,
                                   mtp=False)
        n += head.total_params() + per_layer + 2 * d * d
    if cfg.family == "ssm":
        lora = max(32, d // 32)
        n += cfg.num_layers * (5 * d * d + 2 * d * lora + 8 * d - (6 * d * d + 2 * d))
    if cfg.family == "hybrid":
        din, rank = cfg.mamba_expand * d, -(-d // 16)
        n_mamba = sum(not cfg.is_attn_layer(i) for i in range(cfg.num_layers))
        n += n_mamba * (cfg.mamba_d_conv * din + 2 * din * rank
                        + din * cfg.mamba_d_state + 2 * din)
    return n


def built_lm(tag, cfg):
    """(model, parameter count): ``cfg``'s model on the card with weights
    from generator seed 0, its parameter count first held on the meta
    device to ``lm_param_count``."""
    from repro_torch.models.model import build_model
    n_params = sum(w.numel() for w in build_model(cfg, device="meta").parameters())
    if n_params != lm_param_count(cfg):
        raise AssertionError(f"{tag}: {n_params} parameters, want {lm_param_count(cfg)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))
    return model, n_params


def serve_timed(tag, model):
    """LM_REQUESTS requests of phase 8b's traffic over LM_SLOTS slots
    through a ServingEngine after a warm-up, timed with CUDA events; every
    request must finish with LM_MAX_NEW tokens in range. Returns (engine,
    served tokens, decode steps, the run's ms, wall seconds)."""
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving import smoke as serve_smoke
    vocab = model.cfg.vocab_size
    reqs = serve_smoke.lm_requests(vocab, LM_REQUESTS, LM_MAX_NEW)
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
            and all(0 <= t < vocab for t in tokens) and steps < LM_MAX_LEN):
        raise AssertionError(f"{tag}: {len(results)} results, {len(tokens)} tokens, "
                             f"pos {steps} of max_len {LM_MAX_LEN}")
    return eng, tokens, steps, start.elapsed_time(end), wall


def serving_lm():
    """Phase 8b: tinyllama-1.1b at full width (bfloat16, seeded weights on
    the card) through the ServingEngine, timed with CUDA events; then the
    same widths at LM_CHECK_LAYERS layers in float32 on cuda and cpu."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving import smoke as serve_smoke
    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    model, n_params = built_lm("lm", cfg)
    reqs = serve_smoke.lm_requests(cfg.vocab_size, LM_REQUESTS, LM_MAX_NEW)
    eng, tokens, steps, ms, wall = serve_timed("lm", model)
    print(f"lm: {cfg.name} ({cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads} heads, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.param_dtype}; {n_params} parameters, equal to "
          f"total_params plus the norms) served {LM_REQUESTS} requests over "
          f"{LM_SLOTS} slots: served_tokens={len(tokens)} decode_steps={steps} "
          f"step_ms={ms / steps} wall_s={wall} "
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
# phase 8c: the MoE family and MLA with MTP (olmoe-1b-7b, deepseek-v3-671b)
# ---------------------------------------------------------------------------

# olmoe-1b-7b as published; deepseek-v3-671b at its published widths cut
# to MLA_SERVE_LAYERS layers, its 3 dense-FFN MLA layers and the first MoE
# one (every layer kind, with the MTP head; 61 layers are 1.34 TB in
# bfloat16). Both take phase 8b's traffic.
MOE_ARCH = "olmoe-1b-7b"
MLA_ARCH = "deepseek-v3-671b"
MLA_SERVE_LAYERS = 4
# Model.loss at full width on one sequence
LOSS_BATCH, LOSS_SEQ = 1, 128
# the cuda == cpu check: olmoe's widths at MOE_CHECK_LAYERS layers and
# deepseek's reduced config in float32, TF32 off, over the first LM_SLOTS
# requests with MOE_CHECK_NEW new tokens each (the cpu run reads olmoe's
# float32 weights every step: at 2 layers it took 48.9 s of the script's
# time, so one layer since phases 8e and 9e came). Routing is discrete: a
# request's tokens may part only where the two devices route a token
# differently and that token's k-th and (k+1)-th router probabilities lie
# within ROUTE_TIE_MARGIN
MOE_CHECK_LAYERS = 1
MOE_CHECK_NEW = 16
ROUTE_TIE_MARGIN = 1e-5


class MoEHooks:
    """Forward hooks on every MoE layer of ``model``: ``dropped`` sums the
    layers' dropped counts on the device; with ``route``, ``calls`` keeps
    each layer call's top-k experts and the margin between each token's
    k-th and (k+1)-th router probability (the router recomputed on the
    layer's input, on its device, as ``moe.route`` computes it)."""

    def __init__(self, model, route=False):
        from repro_torch.models.moe import MoE
        self.route = route
        self.dropped = torch.zeros((), dtype=torch.int64, device=model.device)
        self.calls = []
        self.handles = [m.register_forward_hook(self._hook) for m in model.modules()
                        if isinstance(m, MoE)]

    def _hook(self, m, args, out):
        self.dropped += out[2]
        if self.route:
            x = args[0]
            probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ m.router.float(),
                                  dim=-1)
            p, e = torch.sort(probs, dim=-1, descending=True, stable=True)
            k = m.cfg.moe_top_k
            self.calls.append((e[:, :k], p[:, k - 1] - p[:, k]))

    def remove(self):
        for h in self.handles:
            h.remove()


def moe_widths(cfg):
    """A MoE serving cell's widths, as its line prints them."""
    return (f"{cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} heads, "
            f"{cfg.moe_num_experts} experts top-{cfg.moe_top_k}"
            f"{f' + {cfg.moe_shared_experts} shared' if cfg.moe_shared_experts else ''}, "
            f"expert d_ff {cfg.moe_d_ff}, dense d_ff {cfg.d_ff}, mla {cfg.use_mla}, mtp "
            f"{cfg.mtp}")


def lm_serve_cell(tag, cfg, widths, then=None):
    """One LM serving cell on the card: phase 8b's engine run with the
    MoE layers' dropped count summed over it (0 without MoE layers), ten
    profiled decode steps, and one ``Model.loss`` forward on a
    (LOSS_BATCH, LOSS_SEQ) batch; then ``then(model)``, if given.
    ``widths`` describes ``cfg`` in the printed line."""
    from repro_torch.launch import specs
    model, n_params = built_lm(tag, cfg)
    hooks = MoEHooks(model)
    eng, tokens, steps, ms, wall = serve_timed(tag, model)
    hooks.remove()
    print(f"{tag}: {cfg.name} ({widths}, vocab {cfg.vocab_size}, {cfg.param_dtype}; "
          f"{n_params} parameters, equal to lm_param_count) served {LM_REQUESTS} "
          f"requests over {LM_SLOTS} slots: served_tokens={len(tokens)} "
          f"decode_steps={steps} step_ms={ms / steps} wall_s={wall} "
          f"tokens_per_s={len(tokens) / wall} moe_dropped={int(hooks.dropped)} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()}", flush=True)
    tok = torch.ones((LM_SLOTS, 1), dtype=torch.int32, device="cuda")
    _, wall10, busy10, launches10, _ = profile_breakdown(
        lambda: [model.decode_step(tok, eng.caches) for _ in range(10)],
        tag=f"{tag} decode x10")
    print(f"{tag}: a profiled decode step: wall_ms={wall10 * 100} device_busy_ms="
          f"{busy10 * 100} device_idle_share={1 - busy10 / wall10:.4f} "
          f"launches={launches10 / 10}", flush=True)
    del eng
    batch = specs.train_batch(cfg, LOSS_SEQ, LOSS_BATCH, concrete=True,
                              rng=np.random.default_rng(0), device="cuda")
    with torch.no_grad():
        _, metrics = model.loss(batch)
    metrics = {k: float(v) for k, v in metrics.items()}
    needed = ["ce", "moe_aux"] + (["mtp_ce"] if cfg.mtp else [])
    if not all(np.isfinite(metrics[k]) for k in needed):
        raise AssertionError(f"{tag} loss: {metrics}")
    print(f"{tag}: Model.loss at full width on a ({LOSS_BATCH}, {LOSS_SEQ}) batch: "
          f"{metrics}", flush=True)
    if then is not None:
        then(model)
    del model
    torch.cuda.empty_cache()


def routed_engine_run(model, reqs):
    """``serving.smoke.engine_run`` with each decode step's greedy tokens
    and each MoE layer call's routing kept (on the model's device)."""
    from repro_torch.serving import smoke as serve_smoke
    hooks = MoEHooks(model, route=True)
    steps = []
    decode = model.decode_step

    def logged(token, caches, batch=None):
        logits, caches = decode(token, caches, batch)
        steps.append(logits[:, -1].argmax(-1))
        return logits, caches

    model.decode_step = logged
    try:
        out = serve_smoke.engine_run(model, reqs, LM_SLOTS, LM_MAX_LEN)
    finally:
        del model.decode_step
        hooks.remove()
    out["steps"] = [s.cpu() for s in steps]
    out["calls"] = [(e.cpu(), m.cpu()) for e, m in hooks.calls]
    return out


def tf32_off(run):
    """``run()`` with TF32 off for matmuls and cuDNN, restored after."""
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return run()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def twins(cfg):
    """``cfg``'s model on the cpu and on the card with the same weights."""
    from repro_torch.models.model import build_model
    cpu = build_model(cfg, device="cpu")
    card = build_model(cfg, device="cuda")
    card.load_state_dict(cpu.state_dict())
    return cpu, card


def engine_check(tag, cfg):
    """cuda == cpu for ``cfg`` (float32, TF32 off): the first-step logits
    within LM_LOGIT_ATOL and equal tokens, or tokens that part only after
    a routing near tie (the first routing difference at or before the
    first decode step whose greedy tokens differ, its margin under
    ROUTE_TIE_MARGIN), printed. Without MoE layers the tokens must be
    equal."""
    from repro_torch.serving import smoke as serve_smoke
    reqs = serve_smoke.lm_requests(cfg.vocab_size, LM_SLOTS, MOE_CHECK_NEW)
    cpu, card = twins(cfg)
    got = tf32_off(lambda: routed_engine_run(card, reqs))
    want, cpu_s = synced(lambda: routed_engine_run(cpu, reqs))
    del card, cpu
    torch.cuda.empty_cache()
    err = float((got["first_logits"] - want["first_logits"]).abs().max())
    if not (err <= LM_LOGIT_ATOL and got["pos"] == want["pos"]
            and len(got["calls"]) == len(want["calls"])):
        raise AssertionError(f"{tag} check: first-step logits max_abs_err {err}, pos "
                             f"{got['pos']} / {want['pos']}")
    differ = [u for u in want["tokens"] if got["tokens"][u] != want["tokens"][u]]
    parted = ""
    if differ:
        step = next(i for i, (a, b) in enumerate(zip(got["steps"], want["steps"]))
                    if not torch.equal(a, b))
        n_layers = len(got["calls"]) // len(got["steps"])
        call = next((i for i, ((a, _), (b, _)) in enumerate(zip(got["calls"], want["calls"]))
                     if not torch.equal(a, b)), None)
        if call is None or call // n_layers > step:
            raise AssertionError(f"{tag} check: requests {differ} part at decode step "
                                 f"{step} with no routing difference before it")
        tok = int((got["calls"][call][0] != want["calls"][call][0]).any(-1).nonzero()[0])
        margin = min(float(got["calls"][call][1][tok]), float(want["calls"][call][1][tok]))
        parted = (f"; requests {differ} part at decode step {step}, after the routing of "
                  f"token {tok} at step {call // n_layers} (MoE layer {call % n_layers}) "
                  f"differs, its k-th / (k+1)-th probability margin {margin}")
        if margin >= ROUTE_TIE_MARGIN:
            raise AssertionError(f"{tag} check{parted} (not under {ROUTE_TIE_MARGIN})")
    print(f"{tag} check: {cfg.name} at {cfg.num_layers} layers, d_model {cfg.d_model}, "
          f"float32 (TF32 off): {len(reqs)} requests, {MOE_CHECK_NEW} new tokens each, "
          f"{len(got['steps'])} decode steps on cuda and cpu (cpu run {cpu_s:.1f} s); "
          f"first-step logits max_abs_err={err} (tolerance {LM_LOGIT_ATOL}); tokens "
          f"{'equal' if not differ else 'parted'}{parted}", flush=True)


def serving_moe():
    """Phase 8c: OLMOE-SERVE and DEEPSEEK-SERVE on the card, then cuda ==
    cpu at small size."""
    from repro_torch.configs import get_config, reduced_config
    t_phase = time.perf_counter()
    lm_serve_cell("OLMOE-SERVE", get_config(MOE_ARCH), moe_widths(get_config(MOE_ARCH)))
    deepseek = dataclasses.replace(get_config(MLA_ARCH), num_layers=MLA_SERVE_LAYERS)
    lm_serve_cell("DEEPSEEK-SERVE", deepseek, moe_widths(deepseek))
    engine_check("olmoe", dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_CHECK_LAYERS,
                                              param_dtype="float32", compute_dtype="float32"))
    engine_check("deepseek", reduced_config(MLA_ARCH))
    print(f"phase 8c: phase_s={time.perf_counter() - t_phase:.1f}", flush=True)  # repro: noqa[R004] phase wall time, printed only


# ---------------------------------------------------------------------------
# phase 8d: the recurrent mixers (rwkv6-1.6b, jamba-1.5-large-398b)
# ---------------------------------------------------------------------------

# rwkv6-1.6b as published; jamba-1.5-large-398b at its published widths
# cut to JAMBA_SERVE_LAYERS of 72 layers, (mamba, moe), (mamba, mlp),
# (mamba, moe), (attn, mlp): the fewest leading layers that hold every
# layer kind (one period of 8 is about 90 GB in bfloat16, over the card's
# 80 GB). Both take phase 8b's traffic. The cuda == cpu check: rwkv6's
# widths at RWKV_CHECK_LAYERS layers (two until phases 8e and 9e came) and
# jamba's reduced config (2 full-width layers in float32 would be 42 GB on
# the host), as engine_check holds them
RWKV_ARCH = "rwkv6-1.6b"
JAMBA_ARCH = "jamba-1.5-large-398b"
JAMBA_SERVE_LAYERS = 4
RWKV_CHECK_LAYERS = 1


def rwkv_widths(cfg):
    return (f"{cfg.num_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.d_model // cfg.rwkv_head_dim} RWKV heads of {cfg.rwkv_head_dim} "
            f"({cfg.rwkv_impl} form), d_ff {cfg.d_ff}")


def jamba_widths(cfg):
    return (f"{cfg.num_layers} of 72 layers, d_model {cfg.d_model}, "
            f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim} every "
            f"{cfg.attn_period}th layer, Mamba d_state {cfg.mamba_d_state} d_conv "
            f"{cfg.mamba_d_conv} expand {cfg.mamba_expand}, {cfg.moe_num_experts} experts "
            f"top-{cfg.moe_top_k} every {cfg.moe_layer_period}nd layer, expert d_ff "
            f"{cfg.moe_d_ff}, dense d_ff {cfg.d_ff}")


def jamba_serve_config():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(JAMBA_ARCH), num_layers=JAMBA_SERVE_LAYERS)


def serving_recurrent():
    """Phase 8d: RWKV6-SERVE and JAMBA-SERVE on the card, then cuda == cpu
    at rwkv6's widths on RWKV_CHECK_LAYERS layers and at jamba's reduced
    config."""
    from repro_torch.configs import get_config, reduced_config
    t_phase = time.perf_counter()
    rwkv = get_config(RWKV_ARCH)
    lm_serve_cell("RWKV6-SERVE", rwkv, rwkv_widths(rwkv))
    jamba = jamba_serve_config()
    lm_serve_cell("JAMBA-SERVE", jamba, jamba_widths(jamba))
    engine_check("rwkv6", dataclasses.replace(rwkv, num_layers=RWKV_CHECK_LAYERS,
                                              param_dtype="float32", compute_dtype="float32"))
    engine_check("jamba", reduced_config(JAMBA_ARCH))
    print(f"phase 8d: phase_s={time.perf_counter() - t_phase:.1f}", flush=True)  # repro: noqa[R004] phase wall time, printed only


# ---------------------------------------------------------------------------
# phase 8e: the encoder-decoder and VLM families (whisper-medium,
# internvl2-76b)
# ---------------------------------------------------------------------------

# WHISPER-SERVE: whisper-medium as published, WHISPER_BATCH requests in
# one batch: (8, 1500, 1024) frames from a numpy seed (a 30-second window
# after the stubbed conv front end), 4-token prompts, whisper's 448-token
# decoder context, WHISPER_NEW greedy decode steps (32 until phase 9g
# came, for the script's time). The ServingEngine
# cannot serve this family (ROADMAP Queue C, LM fault 8), so the cell goes
# through Model.encode, Model.prefill (which encodes again and decodes the
# prompt's last token only, LM fault 7) and Model.decode_step with
# {"enc_out": ...}, each step's tokens up from and down to the host as the
# engine's are. Every decode step recomputes each decoder layer's cross
# keys and values from enc_out, as the reference does: 4 * layers * B *
# frames * d_model^2 FLOPs a step.
WHISPER_ARCH = "whisper-medium"
WHISPER_BATCH = 8
WHISPER_FRAMES = 1500
WHISPER_PROMPT = 4
WHISPER_MAX_LEN = 448
WHISPER_NEW = 16
# INTERNVL-SERVE: internvl2-76b at its published widths cut to
# VLM_SERVE_LAYERS of 80 layers (24 since phase 9f came, 16 since phase 9g
# came, for the script's time; 40 were 36.3e9 parameters, 72.7 GB in
# bfloat16; all 80 are 141 GB and wait for the mesh's serving path,
# ROADMAP A10b-6b), phase 8b's engine traffic
# (text only: the engine feeds no patches), then a patch prefill of
# WHISPER_BATCH rows of 256 patch embeddings and PATCH_TEXT tokens into
# the caches and WHISPER_NEW decode steps
VLM_ARCH = "internvl2-76b"
VLM_SERVE_LAYERS = 16
PATCH_TEXT = 16
# the cuda == cpu checks at the reduced configs (float32, TF32 off):
# whisper on CHECK_FRAMES frames with CHECK_NEW decode steps, internvl's
# engine_check and its patch prefill with CHECK_NEW decode steps. The
# encoder output and internvl's logits within LM_LOGIT_ATOL; whisper's
# logits within WHISPER_LOGIT_RTOL of the largest |logit|: its embedding
# is tied and drawn at scale 1 (the reference's init), so the reduced
# model's logits reach 31, and float32 rounding grows with them (the cpu
# tests measure each package 2.5e-4 / 3.3e-4 from float64 on logits of
# 15); an H100 80GB HBM3 run gave 9.8e-4 against 31 (PERF.md section 6)
CHECK_FRAMES = 64
CHECK_NEW = 8
WHISPER_LOGIT_RTOL = 1e-4


def whisper_run(model, frames, prompts, steps, max_len, events=None, keep=False):
    """The WHISPER-SERVE loop: ``Model.encode`` of ``frames``, a prefill of
    the (B, P) ``prompts`` into fresh caches, ``steps`` greedy decode
    steps over ``enc_out``. ``events``: four CUDA events recorded before
    the encode, after it, after the prefill's tokens and after the last
    step. Returns (enc_out, the greedy tokens (B, steps + 1), each step's
    logits on the host with ``keep``, else [])."""
    from repro_torch.serving import smoke as serve_smoke
    mark = (lambda i: events[i].record()) if events else (lambda i: None)
    caches = model.init_caches(frames.shape[0], max_len)
    tok = torch.from_numpy(prompts).to(frames.device)
    mark(0)
    with torch.no_grad():
        enc_out = model.encode(frames)
    mark(1)
    logits, caches = model.prefill({"frames": frames, "tokens": tok}, caches)
    nxt = serve_smoke.greedy(logits)
    mark(2)
    toks, kept = [nxt], [logits.float().cpu()] if keep else []
    for _ in range(steps):
        nxt, logits, caches = serve_smoke.greedy_step(model, nxt, caches,
                                                      {"enc_out": enc_out})
        toks.append(nxt)
        if keep:
            kept.append(logits.float().cpu())
    mark(3)
    return enc_out, np.concatenate(toks, axis=1), kept


def patch_run(model, patches, tokens, steps, max_len, events=None, keep=False):
    """The patch prefill: (B, P) patch embeddings and (B, T) tokens into
    fresh caches in one prefill, then ``steps`` greedy decode steps (no
    patches). ``events``: three CUDA events recorded before the prefill,
    after its tokens and after the last step. Returns (the greedy tokens
    (B, steps + 1), each step's logits on the host with ``keep``)."""
    from repro_torch.serving import smoke as serve_smoke
    mark = (lambda i: events[i].record()) if events else (lambda i: None)
    caches = model.init_caches(patches.shape[0], max_len)
    mark(0)
    logits, caches = model.prefill({"patches": patches, "tokens": tokens}, caches)
    nxt = serve_smoke.greedy(logits)
    mark(1)
    if caches[0]["pos"] != patches.shape[1] + tokens.shape[1]:
        raise AssertionError(f"patch prefill: pos {caches[0]['pos']}")
    toks, kept = [nxt], [logits.float().cpu()] if keep else []
    for _ in range(steps):
        nxt, logits, caches = serve_smoke.greedy_step(model, nxt, caches)
        toks.append(nxt)
        if keep:
            kept.append(logits.float().cpu())
    mark(2)
    return np.concatenate(toks, axis=1), kept


def encdec_inputs(cfg, batch, frames, prompt, device):
    """(frames, prompts) from numpy seed 0: ``train_batch``'s frames
    (``standard_normal`` cast to the compute dtype) and (batch, prompt)
    tokens in 1..vocab-1."""
    from repro_torch.launch import specs
    x = specs.train_batch(cfg, frames, batch, concrete=True, rng=np.random.default_rng(0),
                          device=device)["frames"]
    prompts = np.random.default_rng(1).integers(1, cfg.vocab_size, (batch, prompt))
    return x, prompts.astype(np.int32)


def patch_inputs(cfg, batch, text, device):
    """(patches, tokens) from numpy seed 2: ``train_batch``'s patches and
    (batch, text) tokens."""
    from repro_torch.launch import specs
    b = specs.train_batch(cfg, cfg.num_patches + text, batch, concrete=True,
                          rng=np.random.default_rng(2), device=device)
    return b["patches"], b["tokens"]


def vlm_serve_config():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(VLM_ARCH), num_layers=VLM_SERVE_LAYERS)


def whisper_serve():
    """WHISPER-SERVE on the card: a warm-up, the timed loop, ten profiled
    decode steps and ``Model.loss`` on ``train_batch(cfg, 1500, 8)``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import specs
    from repro_torch.serving import smoke as serve_smoke
    cfg = get_config(WHISPER_ARCH)
    model, n_params = built_lm("WHISPER-SERVE", cfg)
    frames, prompts = encdec_inputs(cfg, WHISPER_BATCH, WHISPER_FRAMES, WHISPER_PROMPT,
                                    "cuda")
    whisper_run(model, frames, prompts, 2, WHISPER_MAX_LEN)
    events = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    enc_out, toks, _ = whisper_run(model, frames, prompts, WHISPER_NEW, WHISPER_MAX_LEN,
                                   events)
    torch.cuda.synchronize()
    encode_ms, prefill_ms, steps_ms = (events[i].elapsed_time(events[i + 1])
                                       for i in range(3))
    if not (toks.shape == (WHISPER_BATCH, WHISPER_NEW + 1)
            and ((0 <= toks) & (toks < cfg.vocab_size)).all()):
        raise AssertionError(f"WHISPER-SERVE: tokens {toks.shape}, {toks.min()}..{toks.max()}")
    d, layers = cfg.d_model, cfg.decoder_layers
    cross_flop = 4 * layers * WHISPER_BATCH * WHISPER_FRAMES * d * d
    new = WHISPER_BATCH * (WHISPER_NEW + 1)
    print(f"WHISPER-SERVE: {cfg.name} ({cfg.encoder_layers}+{layers} layers, d_model {d}, "
          f"{cfg.num_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, {cfg.param_dtype}; {n_params} parameters, equal to "
          f"lm_param_count) {WHISPER_BATCH} requests of {WHISPER_FRAMES} frames and "
          f"{WHISPER_PROMPT}-token prompts, max_len {WHISPER_MAX_LEN}: encode_ms={encode_ms} "
          f"prefill_ms={prefill_ms} step_ms={steps_ms / WHISPER_NEW} over {WHISPER_NEW} "
          f"decode steps; tokens_per_s={new / ((encode_ms + prefill_ms + steps_ms) / 1e3)} "
          f"({new} tokens, encode to last step) decode_tokens_per_s="
          f"{WHISPER_BATCH * WHISPER_NEW / (steps_ms / 1e3)}; cross K/V recompute "
          f"{cross_flop} FLOP a step ({cross_flop / 989e12 * 1e3} ms at the bf16 peak); "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()}", flush=True)
    caches = model.init_caches(WHISPER_BATCH, WHISPER_MAX_LEN)
    _, caches = model.prefill({"frames": frames, "tokens": torch.from_numpy(prompts).cuda()},
                              caches)
    tok = toks[:, -1:]
    batch = {"enc_out": enc_out}
    _, wall10, busy10, launches10, _ = profile_breakdown(
        lambda: [serve_smoke.greedy_step(model, tok, caches, batch) for _ in range(10)],
        tag="WHISPER-SERVE decode x10")
    print(f"WHISPER-SERVE: a profiled decode step: wall_ms={wall10 * 100} device_busy_ms="
          f"{busy10 * 100} device_idle_share={1 - busy10 / wall10:.4f} "
          f"launches={launches10 / 10}", flush=True)
    del caches, enc_out, batch
    train = specs.train_batch(cfg, WHISPER_FRAMES, WHISPER_BATCH, concrete=True,
                              rng=np.random.default_rng(0), device="cuda")
    with torch.no_grad():
        _, metrics = model.loss(train)
    metrics = {k: float(v) for k, v in metrics.items()}
    if not np.isfinite(metrics["ce"]):
        raise AssertionError(f"WHISPER-SERVE loss: {metrics}")
    print(f"WHISPER-SERVE: Model.loss at full size on train_batch(cfg, {WHISPER_FRAMES}, "
          f"{WHISPER_BATCH}) ({tuple(train['tokens'].shape)} decoder tokens): {metrics}",
          flush=True)
    del model, train
    torch.cuda.empty_cache()


def patch_prefill_cell(model):
    """INTERNVL-SERVE's patch prefill on the card: a warm-up, then the
    timed prefill and WHISPER_NEW decode steps."""
    cfg = model.cfg
    patches, tokens = patch_inputs(cfg, WHISPER_BATCH, PATCH_TEXT, "cuda")
    patch_run(model, patches, tokens, 1, LM_MAX_LEN)
    torch.cuda.empty_cache()
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    toks, _ = patch_run(model, patches, tokens, WHISPER_NEW, LM_MAX_LEN, events)
    torch.cuda.synchronize()
    prefill_ms, steps_ms = (events[i].elapsed_time(events[i + 1]) for i in range(2))
    if not ((0 <= toks) & (toks < cfg.vocab_size)).all():
        raise AssertionError("INTERNVL-SERVE patch prefill: tokens out of range")
    rows = cfg.num_patches + PATCH_TEXT
    print(f"INTERNVL-SERVE: patch prefill of {WHISPER_BATCH} x ({cfg.num_patches} patches + "
          f"{PATCH_TEXT} tokens) = {WHISPER_BATCH * rows} rows into the caches: "
          f"prefill_ms={prefill_ms} prefill_rows_per_s={WHISPER_BATCH * rows / (prefill_ms / 1e3)}"
          f"; then step_ms={steps_ms / WHISPER_NEW} over {WHISPER_NEW} decode steps; "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()}", flush=True)


def vlm_widths(cfg):
    return (f"{cfg.num_layers} of 80 layers, d_model {cfg.d_model}, {cfg.num_heads}/"
            f"{cfg.num_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, "
            f"{cfg.num_patches} patches")


def held(tag, got, want, bound=LM_LOGIT_ATOL):
    """The largest |logit| difference over the steps; fails over ``bound``
    or when the greedy tokens differ."""
    (gtok, glog), (wtok, wlog) = got, want
    err = max(float((g - w).abs().max()) for g, w in zip(glog, wlog))
    if not (len(glog) == len(wlog) and err <= bound and np.array_equal(gtok, wtok)):
        raise AssertionError(f"{tag}: logits max_abs_err {err} (bound {bound}), tokens "
                             f"equal {np.array_equal(gtok, wtok)}")
    return err


def encdec_check():
    """cuda == cpu at the reduced whisper and internvl configs (float32,
    TF32 off): whisper's encode, prefill and CHECK_NEW chained decode
    steps; internvl's engine_check and its patch prefill with CHECK_NEW
    decode steps. Logits within LM_LOGIT_ATOL, greedy tokens equal."""
    from repro_torch.configs import reduced_config
    wcfg = reduced_config(WHISPER_ARCH)
    cpu, card = twins(wcfg)
    out = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        frames, prompts = encdec_inputs(wcfg, WHISPER_BATCH, CHECK_FRAMES, WHISPER_PROMPT, dev)
        out[dev] = tf32_off(lambda: whisper_run(model, frames, prompts, CHECK_NEW,
                                                WHISPER_MAX_LEN, keep=True))
    enc_err = float((out["cuda"][0].cpu() - out["cpu"][0]).abs().max())
    scale = max(float(w.abs().max()) for w in out["cpu"][2])
    err = held("whisper check", out["cuda"][1:], out["cpu"][1:],
               WHISPER_LOGIT_RTOL * max(1.0, scale))
    if enc_err > LM_LOGIT_ATOL:
        raise AssertionError(f"whisper check: encode max_abs_err {enc_err}")
    print(f"whisper check: {wcfg.name} reduced ({wcfg.encoder_layers}+{wcfg.decoder_layers} "
          f"layers, d_model {wcfg.d_model}) in float32 (TF32 off), {WHISPER_BATCH} x "
          f"{CHECK_FRAMES} frames, prefill and {CHECK_NEW} decode steps on cuda and cpu: "
          f"encode max_abs_err={enc_err} (tolerance {LM_LOGIT_ATOL}), logits "
          f"max_abs_err={err} of a largest |logit| {scale} (tolerance {WHISPER_LOGIT_RTOL} "
          f"of it), greedy tokens equal", flush=True)
    del cpu, card

    vcfg = reduced_config(VLM_ARCH)
    engine_check("internvl", vcfg)
    cpu, card = twins(vcfg)
    out = {}
    for dev, model in (("cuda", card), ("cpu", cpu)):
        patches, tokens = patch_inputs(vcfg, WHISPER_BATCH, PATCH_TEXT, dev)
        out[dev] = tf32_off(lambda: patch_run(model, patches, tokens, CHECK_NEW,
                                              LM_MAX_LEN, keep=True))
    err = held("internvl patch check", out["cuda"], out["cpu"])
    print(f"internvl patch check: {vcfg.name} reduced ({vcfg.num_layers} layers, "
          f"{vcfg.num_patches} patches) in float32 (TF32 off), a patch prefill of "
          f"{WHISPER_BATCH} x ({vcfg.num_patches} + {PATCH_TEXT}) rows and {CHECK_NEW} "
          f"decode steps on cuda and cpu: logits max_abs_err={err} (tolerance "
          f"{LM_LOGIT_ATOL}), greedy tokens equal", flush=True)
    del cpu, card
    torch.cuda.empty_cache()


def serving_encdec():
    """Phase 8e: WHISPER-SERVE and INTERNVL-SERVE (the engine's traffic,
    then the patch prefill) on the card, then cuda == cpu at the reduced
    configs."""
    t_phase = time.perf_counter()
    whisper_serve()
    vlm = vlm_serve_config()
    lm_serve_cell("INTERNVL-SERVE", vlm, vlm_widths(vlm), then=patch_prefill_cell)
    encdec_check()
    print(f"phase 8e: phase_s={time.perf_counter() - t_phase:.1f}", flush=True)  # repro: noqa[R004] phase wall time, printed only


# ---------------------------------------------------------------------------
# phase 9: training (launch/train.py, training/)
# ---------------------------------------------------------------------------

# the launcher on tinyllama-1.1b as published, at its defaults (--dedup of
# 3,000 entities, batch 8, seq 256): 12 steps, a checkpoint every 7 (one,
# at step 7: since phase 9g came, for the script's time, an 11 GB save
# taking 17-22 s on the H100; every 6 wrote two, and the resumed run a third), then a
# run resumed from step 7
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_STEPS = 12
TRAIN_CKPT_EVERY = 7
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

        # as if killed after step 7's checkpoint, the only one written
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
    """Phase 9b: cuda == cpu at 1 layer in float32, and the deterministic
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


# the MoE train cell OLMOE-TRAIN: olmoe-1b-7b's widths through the train
# step in bfloat16 with remat "full" and the launcher's batch (8 x 256)
# from the loader over phase 9a's deduplicated corpus (launch/train.py
# --dedup at its defaults). Cut to MOE_TRAIN_LAYERS of 16 layers, the
# most that fit on an 80 GB card: at 12 bytes a parameter (bfloat16
# weights and gradients, float32 moments) 16 layers hold 83.0 GB before
# activations; 15 layers peaked at 81.8e9 bytes allocated on an H100 80GB
# HBM3 (PERF.md section 4), and each layer adds 5.0e9. MOE_TRAIN_STEPS
# steps, steps 2 on timed; TRAIN_PROFILED_STEPS more profiled. Then cuda
# == cpu on both families' reduced configs, as phase 9b holds the dense
# decoder
MOE_TRAIN_LAYERS = 15
MOE_TRAIN_STEPS = 6


def train_setup(cfg, steps):
    """(model, state, step function, loader) of a train cell of ``cfg`` on
    the card, with the launcher's optimizer settings over ``steps`` steps
    and its deduplicated loader."""
    from repro_torch.launch import train
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import TrainConfig, init_train_state, make_train_step
    ld = train.make_loader(cfg.vocab_size, "cuda")[0]
    model, _ = built_lm(f"{cfg.name} train", cfg)
    tcfg = TrainConfig(opt=OptimizerConfig(lr=3e-4, warmup_steps=min(20, steps // 4),
                                           total_steps=steps))
    return model, init_train_state(model, tcfg), make_train_step(model, tcfg), ld


def moe_train_config():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE_ARCH), num_layers=MOE_TRAIN_LAYERS)


def train_cell(tag, cfg, steps, profiled_steps, full_layers):
    """``steps`` train steps of ``cfg`` on the card (bfloat16, remat
    "full", the launcher's batch from its deduplicated loader), steps 2 on
    timed with CUDA events, every loss finite; then ``profiled_steps``
    more profiled: the idle share, launches a step and the optimizer's
    share of the device time."""
    model, state, step_fn, ld = train_setup(cfg, steps)
    marks, mets = [], []
    for i in range(steps):
        x, y = ld.batch(i)
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
        state, m = step_fn(state, {"tokens": x, "targets": y})
        end.record()
        marks.append((begin, end))
        mets.append(m)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(b) for a, b in marks]
    mets = [{k: float(v) for k, v in m.items()} for m in mets]
    losses = [m["loss"] for m in mets]
    if not (np.isfinite(losses).all() and int(state["step"]) == steps):
        raise AssertionError(f"{tag}: losses {losses}, step {int(state['step'])}")
    timed = step_ms[1:]
    tokens = ld.tokens_per_batch
    print(f"{tag}: {cfg.name} at {cfg.num_layers} of {full_layers} layers (d_model "
          f"{cfg.d_model}, {cfg.moe_num_experts} experts top-{cfg.moe_top_k}, "
          f"{cfg.param_dtype}, remat {cfg.remat}) batch {ld.cfg.batch_size} seq "
          f"{ld.cfg.seq_len} from the deduplicated loader: {steps} steps, losses {losses}; "
          f"moe_aux {[m['moe_aux'] for m in mets]}; moe_dropped "
          f"{[int(m['moe_dropped']) for m in mets]}; steps 2-{steps} step_ms="
          f"{np.mean(timed)} (min {min(timed)} max {max(timed)}) tokens_per_s="
          f"{tokens * len(timed) / (sum(timed) / 1e3)}; first step_ms={step_ms[0]}; "
          f"max_memory_allocated={peak} of the card's "
          f"{torch.cuda.get_device_properties(0).total_memory}", flush=True)

    def more():
        nonlocal state
        for i in range(profiled_steps):
            x, y = ld.batch(steps + i)
            state, _ = step_fn(state, {"tokens": x, "targets": y})

    _, wall, busy, n_launch, ranges = profile_breakdown(more, tag=f"{tag} x{profiled_steps}")
    opt_s = ranges["train.optimizer"]
    print(f"{tag}: a profiled step: wall_ms={wall / profiled_steps * 1e3} "
          f"device_busy_ms={busy / profiled_steps * 1e3} device_idle_share="
          f"{1 - busy / wall:.4f} launches={n_launch / profiled_steps}; the "
          f"optimizer's kernels device_ms={opt_s / profiled_steps * 1e3} "
          f"({opt_s / busy:.4f} of the device time)", flush=True)
    del model, state, step_fn
    torch.cuda.empty_cache()


def reduced_train_check(tag, archs):
    """Each arch's reduced config in float32 (TF32 off) on cuda and cpu
    from the same weights, the query and key projections scaled by
    TRAIN_CHECK_QK_SCALE: TRAIN_CHECK_STEPS train steps give loss, ce,
    moe_aux (where the family has it) and grad_norm within TRAIN_RTOL."""
    from repro_torch.configs import reduced_config
    from repro_torch.models.model import build_model
    from repro_torch.training import smoke
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        for arch in archs:
            small = reduced_config(arch)
            init = build_model(small, device="cpu").state_dict()
            out = {}
            for dev in ("cuda", "cpu"):
                m = build_model(small, device=dev)
                m.load_state_dict(init)
                smoke.scale_qk(m, TRAIN_CHECK_QK_SCALE)
                bs = smoke.batches(small, TRAIN_CHECK_STEPS, TRAIN_CHECK_BATCH,
                                   TRAIN_CHECK_SEQ, dev)
                out[dev] = smoke.train_steps(m, bs)[1]
            keys = [k for k in ("loss", "ce", "moe_aux", "grad_norm") if k in out["cpu"][0]]
            errs = [max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-30) for k in keys)
                    for g, w in zip(out["cuda"], out["cpu"])]
            print(f"{tag}: {arch} reduced, qk scale {TRAIN_CHECK_QK_SCALE}, "
                  f"{TRAIN_CHECK_STEPS} steps: cuda losses {[m['loss'] for m in out['cuda']]} "
                  f"cpu {[m['loss'] for m in out['cpu']]}; moe_dropped cuda "
                  f"{[m.get('moe_dropped') for m in out['cuda']]} cpu "
                  f"{[m.get('moe_dropped') for m in out['cpu']]}; max relative error of "
                  f"{', '.join(keys)} a step {errs}", flush=True)
            if max(errs) > TRAIN_RTOL:
                raise AssertionError(f"{tag}: {arch} cuda vs cpu {errs} over "
                                     f"rtol {TRAIN_RTOL}")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
    torch.cuda.empty_cache()


def training_moe():
    """Phase 9c: OLMOE-TRAIN on the card, then cuda == cpu at the reduced
    configs of both families."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    train_cell("moe train", moe_train_config(), MOE_TRAIN_STEPS, TRAIN_PROFILED_STEPS,
               get_config(MOE_ARCH).num_layers)
    reduced_train_check("moe train check", (MOE_ARCH, MLA_ARCH))
    print(f"phase 9c: phase_s={time.perf_counter() - t_phase:.1f}", flush=True)  # repro: noqa[R004] phase wall time, printed only


# the recurrent train cell RWKV6-TRAIN: rwkv6-1.6b's widths through the
# train step in bfloat16 with remat "full" and the launcher's batch (8 x
# 256) from the deduplicated loader, RWKV_TRAIN_STEPS steps, steps 2 on
# timed, RWKV_TRAIN_PROFILED_STEPS more profiled; then cuda == cpu on
# both recurrent families' reduced configs, as phase 9c holds the MoE
# ones. The WKV's step form is a Python loop over the 256 positions of
# every layer, in the forward, the recompute and the backward: at all 24
# layers a step took 8.7 s and 276k launches on an H100 80GB HBM3, and
# reading its profile back about 400 s (PERF.md section 4). So the cell is
# cut to RWKV_TRAIN_LAYERS of 24 layers (4 until phase 9g came, for the
# script's time) and one profiled step (RWKV_TRAIN_LAYERS=24 through
# scripts/chip_phases.py runs it whole)
RWKV_TRAIN_LAYERS = 2
RWKV_TRAIN_STEPS = 6
RWKV_TRAIN_PROFILED_STEPS = 1


def rwkv_train_config():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(RWKV_ARCH), num_layers=RWKV_TRAIN_LAYERS)


def training_recurrent():
    """Phase 9d: RWKV6-TRAIN on the card, then cuda == cpu at the reduced
    rwkv6 and jamba configs."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    train_cell("rwkv train", rwkv_train_config(), RWKV_TRAIN_STEPS,
               RWKV_TRAIN_PROFILED_STEPS, get_config(RWKV_ARCH).num_layers)
    reduced_train_check("rwkv train check", (RWKV_ARCH, JAMBA_ARCH))
    print(f"phase 9d: phase_s={time.perf_counter() - t_phase:.1f}", flush=True)  # repro: noqa[R004] phase wall time, printed only


# WHISPER-TRAIN: whisper-medium as published through the train step in
# bfloat16 with remat "full" on train_batch(cfg, 1500, 8): 8 x 1500
# frames and 8 x 187 decoder tokens (a batch a step from numpy seeds 0,
# 1, ...); WHISPER_TRAIN_STEPS steps, the first WHISPER_TRAIN_WARMUP
# untimed, then WHISPER_TRAIN_PROFILED_STEPS more profiled; then cuda ==
# cpu on the reduced config over TRAIN_CHECK_STEPS steps. internvl2-76b
# is not trained on the card (its 40-layer cut alone is 72.7 GB of
# weights); the CPU tests hold its reduced train step to the reference.
WHISPER_TRAIN_STEPS = 6
WHISPER_TRAIN_WARMUP = 2
WHISPER_TRAIN_PROFILED_STEPS = 1


def whisper_train_setup(steps):
    """(model, state, step function) of WHISPER-TRAIN on the card, with the
    launcher's optimizer settings over ``steps`` steps."""
    from repro_torch.configs import get_config
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import TrainConfig, init_train_state, make_train_step
    model, _ = built_lm("WHISPER-TRAIN", get_config(WHISPER_ARCH))
    tcfg = TrainConfig(opt=OptimizerConfig(lr=3e-4, warmup_steps=min(20, steps // 4),
                                           total_steps=steps))
    return model, init_train_state(model, tcfg), make_train_step(model, tcfg)


def whisper_batch(cfg, i):
    from repro_torch.launch import specs
    return specs.train_batch(cfg, WHISPER_FRAMES, WHISPER_BATCH, concrete=True,
                             rng=np.random.default_rng(i), device="cuda")


def training_encdec():
    """Phase 9e: WHISPER-TRAIN on the card, then cuda == cpu at the
    reduced whisper config."""
    t_phase = time.perf_counter()
    steps = WHISPER_TRAIN_STEPS
    model, state, step_fn = whisper_train_setup(steps)
    cfg = model.cfg
    batches = [whisper_batch(cfg, i) for i in range(steps + WHISPER_TRAIN_PROFILED_STEPS)]
    marks, mets = [], []
    for b in batches[:steps]:
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
        state, m = step_fn(state, b)
        end.record()
        marks.append((begin, end))
        mets.append(m)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    step_ms = [a.elapsed_time(b) for a, b in marks]
    losses = [float(m["loss"]) for m in mets]
    if not (np.isfinite(losses).all() and int(state["step"]) == steps):
        raise AssertionError(f"WHISPER-TRAIN: losses {losses}, step {int(state['step'])}")
    timed = step_ms[WHISPER_TRAIN_WARMUP:]
    secs = sum(timed) / 1e3
    frames, tokens = batches[0]["frames"].shape[:2], batches[0]["tokens"].shape
    print(f"WHISPER-TRAIN: {cfg.name} ({cfg.encoder_layers}+{cfg.decoder_layers} layers, "
          f"d_model {cfg.d_model}, {cfg.param_dtype}, remat {cfg.remat}) batch "
          f"{tuple(frames)} frames, {tuple(tokens)} decoder tokens: {steps} steps, losses "
          f"{losses}; steps {WHISPER_TRAIN_WARMUP + 1}-{steps} step_ms={np.mean(timed)} "
          f"(min {min(timed)} max {max(timed)}) frames_per_s="
          f"{frames[0] * frames[1] * len(timed) / secs} tokens_per_s="
          f"{tokens[0] * tokens[1] * len(timed) / secs}; first step_ms={step_ms[0]}; "
          f"max_memory_allocated={peak} of the card's "
          f"{torch.cuda.get_device_properties(0).total_memory}", flush=True)

    def more():
        nonlocal state
        for b in batches[steps:]:
            state, _ = step_fn(state, b)

    n = WHISPER_TRAIN_PROFILED_STEPS
    _, wall, busy, n_launch, ranges = profile_breakdown(more, tag=f"WHISPER-TRAIN x{n}")
    opt_s = ranges["train.optimizer"]
    print(f"WHISPER-TRAIN: a profiled step: wall_ms={wall / n * 1e3} device_busy_ms="
          f"{busy / n * 1e3} device_idle_share={1 - busy / wall:.4f} launches="
          f"{n_launch / n}; the optimizer's kernels device_ms={opt_s / n * 1e3} "
          f"({opt_s / busy:.4f} of the device time)", flush=True)
    del model, state, step_fn, batches
    torch.cuda.empty_cache()
    reduced_train_check("whisper train check", (WHISPER_ARCH,))
    print(f"phase 9e: phase_s={time.perf_counter() - t_phase:.1f}", flush=True)  # repro: noqa[R004] phase wall time, printed only


# the mesh train cell MESH-OLMOE-TRAIN (phase 9f): olmoe-1b-7b's published
# widths (d_model 2048, 16 heads of 128, 64 experts of d_ff 1024 top-8,
# vocab 50304, bfloat16, remat full) cut to MESH_TRAIN_LAYERS of 16 layers
# (at 2, on the H100, the planted faults below moved the logits by only
# 0.035 and 0.012, against bounds of 0.03 and 0.005),
# trained by the launcher's mesh function (launch/train.main(argv,
# mesh=...), --dedup) on MESH_RANKS gloo ranks of the one card, a
# MESH_TRAIN_SHAPE ("data", "model") DeviceMesh under production_rules
# (FSDP over "data"; heads, experts and vocab over "model"), the
# launcher's batch (8 x 256), MESH_TRAIN_STEPS steps (3 until phase 9g came
# into the same spawn, for the script's time) at the published capacity
# factor, step 2 on timed; then one more step, profiled on rank 0
# and under the sync census on the others;
# then one batch at capacity factor MESH_CHECK_CF, where nothing drops,
# from the initial weights in float32 (TF32 off): in bfloat16 the
# products' rounding in other orders flips the top-8 choice of near-tied
# tokens, and the dispatches' logits part by 0.29-0.43 of their norm, as
# far as a planted fault moves them (PR 24's first reading, PERF.md
# section 4). Each rank's rows of the logits by the psum
# and the a2a dispatch, and, on the ranks of the first "model" coordinate,
# by a one-rank meshless model of the same weights, within
# MESH_LOGITS_RTOL of each other (relative Frobenius norm) and the median
# token's logits within MESH_TOKEN_RTOL; the
# cross-entropies within MESH_CE_RTOL; both dispatches' dropped == 0. Two
# planted faults on the meshless model, its experts shifted by one (an
# expert offset off by one) and the other EP rank's experts zeroed (the
# EP reduce skipped), must each land outside both logits bounds of the
# psum logits: the check is shown to see them. The bounds were set from PR 24's
# float32 readings on the card (PERF.md section 4)
MESH_TRAIN_LAYERS = 4
MESH_TRAIN_STEPS = 2
MESH_TRAIN_SHAPE = (2, 2)
MESH_CHECK_CF = 8.0
MESH_LOGITS_RTOL = 3e-2
MESH_TOKEN_RTOL = 5e-3
MESH_CE_RTOL = 1e-4


def mesh_train_config(**changes):
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(MOE_ARCH), num_layers=MESH_TRAIN_LAYERS,
                               **changes)


def mesh_train_rank(rank, world, init, tmp, olmoe=True):
    """One of phase 9f's ranks: with ``olmoe`` the training run (every
    dedup launch held against its plain version), the census of one more
    step, the capacity-factor check; then phase 9g (``family_phase``);
    its results pickled to ``tmp``."""
    import pickle
    import torch.distributed as tdist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.distributed.sharding import production_rules
    # four ranks' caches on one card: freed blocks are given back to the
    # other sizes (9g's 3.7e9-parameter cells ran out of memory without)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    torch.cuda.set_device(0)
    tdist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    out = {}
    try:
        mesh = DeviceMesh("cuda", torch.arange(world).reshape(MESH_TRAIN_SHAPE),
                          mesh_dim_names=("data", "model"))
        rules = production_rules(mesh)
        if olmoe:
            out.update(mesh_olmoe_rank(rank, tmp, mesh, rules))
        out["families"] = family_phase(rank, tmp, mesh, rules, all_kernels())
        tdist.barrier()
    finally:
        tdist.destroy_process_group()
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def mesh_olmoe_rank(rank, tmp, mesh, rules):
    """Phase 9f's MESH-OLMOE-TRAIN on this rank (``mesh_train_rank``)."""
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.launch import train
    from repro_torch.training.train_loop import make_train_step
    out = {}
    cfg = mesh_train_config()
    argv = ["--arch", MOE_ARCH, "--steps", str(MESH_TRAIN_STEPS), "--dedup",
            "--ckpt-every", str(MESH_TRAIN_STEPS + 1),
            "--ckpt-dir", os.path.join(tmp, "ckpt")]
    kernels = all_kernels()
    runs = []
    get_config = train.get_config
    train.get_config = lambda arch: cfg
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    try:
        for k in kernels:
            k.launches = 0
        out["checked"] = check_launches(
            lambda: runs.append(train.main(argv, mesh=mesh)), kernels)
        out["launches"] = {k.name: k.launches for k in kernels}
    finally:
        train.get_config = get_config
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0  # repro: noqa[R004] synchronized on the line above
    out["peak"] = torch.cuda.max_memory_allocated()
    run = runs.pop()
    out.update(metrics=run.metrics, step_ms=run.step_ms,
               tokens=run.loader.cfg.batch_size * run.loader.cfg.seq_len,
               local_params=sum(p.numel() for p in run.model.parameters()))
    step_fn = make_train_step(run.model, run.tcfg)

    def one_step():
        x, y = run.loader.batch(MESH_TRAIN_STEPS)
        with use_rules(rules):
            step_fn(run.state, {"tokens": x, "targets": y})

    # one step: profiled on rank 0, under the census on the others
    if rank == 0:
        out["profile"] = profile_breakdown(one_step, tag="MESH-OLMOE-TRAIN rank 0 x1")[1:4]
    else:
        with quiet_unless(rank):
            out["census"] = census(f"MESH-OLMOE-TRAIN rank {rank} one step",
                                   one_step).total
    batch = dict(zip(("tokens", "targets"), run.loader.batch(0)))
    del run, step_fn
    torch.cuda.empty_cache()
    out["check"] = mesh_check(batch, mesh, rules)
    return out


def mesh_check(batch, mesh, rules):
    """Phase 9f's check on this rank (the comment above MESH_TRAIN_LAYERS):
    {name: (ce, moe_aux, dropped)} of the psum, the a2a and, on the first
    "model" coordinate, the meshless run and the two planted faults, and
    the relative distances of this rank's rows of their logits."""
    from repro_torch.core.routing import linear_shard_index
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.models.model import build_model, cross_entropy, shard_model
    from repro_torch.models.moe import MoE

    def run(model):
        with torch.no_grad():
            logits, aux = model.apply(batch)
            ce = spmd.batch_mean(cross_entropy(logits, spmd.batch_rows(batch["targets"]))[0])
        return logits.float(), (float(ce), float(aux["moe_aux"]), int(aux["moe_dropped"]))

    def dist_(a, b):
        """(the relative distance of the whole, the median token's, the
        share of tokens farther than MESH_TOKEN_RTOL)."""
        tok = (torch.linalg.vector_norm(a - b, dim=-1)
               / torch.linalg.vector_norm(b, dim=-1)).flatten()
        return (float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)),
                float(tok.median()), float((tok > MESH_TOKEN_RTOL).float().mean()))

    torch.backends.cuda.matmul.allow_tf32 = False  # a spawned rank's own setting
    f32 = dict(capacity_factor=MESH_CHECK_CF, param_dtype="float32",
               compute_dtype="float32")
    logits, out = {}, {}
    model = build_model(mesh_train_config(**f32), device="cuda")
    shard_model(model, rules)
    for impl in ("psum", "a2a"):
        for m in model.modules():  # MoE reads its dispatch at each call
            if isinstance(m, MoE):
                m.cfg = dataclasses.replace(m.cfg, moe_impl=impl)
        with use_rules(rules):
            logits[impl], out[impl] = run(model)
    del model
    torch.cuda.empty_cache()
    dists = {"psum~a2a": dist_(logits["a2a"], logits["psum"])}
    if linear_shard_index(mesh, ("model",)) == 0:
        n = batch["tokens"].shape[0] // mesh.size(0)
        first = linear_shard_index(mesh, ("data",)) * n
        rows = slice(first, first + n)
        model = build_model(mesh_train_config(**f32), device="cuda")
        logits["meshless"], out["meshless"] = run(model)
        logits["meshless"] = logits["meshless"][rows]
        dists["psum~meshless"] = dist_(logits["psum"], logits["meshless"])
        dists["a2a~meshless"] = dist_(logits["a2a"], logits["meshless"])
        experts = [m for m in model.modules() if isinstance(m, MoE)]
        with torch.no_grad():
            # a reading, not a check: the meshless logits' move when half
            # the embedding's entries move by one ulp (rounding-sized)
            table = model.embed.table
            kept = table.clone()
            gen = torch.Generator(device=table.device).manual_seed(0)
            flip = torch.rand(table.shape, generator=gen, device=table.device) < 0.5
            table.copy_(torch.where(flip, torch.nextafter(table, torch.full_like(
                table, float("inf"))), table))
            probe, _ = run(model)
            dists["probe:meshless~1ulp"] = dist_(probe[rows], logits["meshless"])
            table.copy_(kept)
            del kept, flip, probe
            for m in experts:  # an expert offset off by one
                for w in (m.w_gate, m.w_up, m.w_down):
                    w.copy_(torch.roll(w, 1, 0))
            fault, out["fault:offset+1"] = run(model)
            dists["psum~fault:offset+1"] = dist_(logits["psum"], fault[rows])
            for m in experts:  # undone; the other EP rank's experts left out
                for w in (m.w_gate, m.w_up, m.w_down):
                    w.copy_(torch.roll(w, -1, 0))
                m.w_down[m.w_down.shape[0] // mesh.size(1):] = 0
            fault, out["fault:no EP reduce"] = run(model)
            dists["psum~fault:no EP reduce"] = dist_(logits["psum"], fault[rows])
        del model, fault
    del logits
    torch.cuda.empty_cache()
    return {"runs": out, "dists": dists}


# phase 9g: every family trains on the mesh, inside phase 9f's spawn (the
# same four gloo ranks, the same (2, 2) ("data", "model") mesh under
# production_rules). Each cell at its published widths, cut in depth
# (PERF.md section 4), bfloat16, remat full, batch 8 x 256 (whisper: 8 x
# 1500 frames, 187 decoder tokens), MESH_TRAIN_STEPS steps: the first
# profiled on rank 0 (untimed: it includes first-call set-up), the second
# timed with CUDA events on the slowest rank (on ranks 1-3 under the
# sync census, which runs from the first step to the end: a few syncs
# a step, each a stack walk). DEEPSEEK-MESH-TRAIN: deepseek-v3-671b's
# first FAMILY_DEEP_LAYERS layers (dense-FFN MLA: moe_first_dense is 3)
# and its MTP head, 3.12e9 parameters at 1; JAMBA-MESH-TRAIN: jamba's
# first FAMILY_DEEP_LAYERS layers (Mamba+MoE, then Mamba+MLP) with its
# 16 experts cut to 2, top-2 kept (one MoE layer at its published widths
# is 9.7e9 parameters, 116 GB with its moments), 2.7e9 parameters at 1.
# At 2 layers each (3.7e9) a deepseek step took 45 s on the H100 through
# gloo's staging (about 0.2 GB/s a rank), more than the script's clock
# allows;
# RWKV6-MESH-TRAIN: rwkv6-1.6b at FAMILY_RWKV_LAYERS of 24 layers, as
# phase 9d (at 4 layers, and whisper at 4 + 4, the phase took 132 s on
# the H100); these three through the launcher (launch/train.main(argv,
# mesh=...), --dedup, every dedup launch held against its plain version).
# WHISPER-MESH-TRAIN: whisper-medium at FAMILY_WHISPER_LAYERS encoder and
# as many decoder layers through make_train_step (the launcher cannot
# train the family: training fault 5). Then each family's float32 check
# (TF32 off) at one layer of its published widths (jamba's 2 experts
# kept): each rank's rows of the logits (and of deepseek's MTP logits)
# against a one-rank meshless model of the same weights within
# FAMILY_LOGITS_RTOL (the relative distance of the whole) and
# FAMILY_TOKEN_RTOL (the median token's), the cross-entropy of the rows
# within MESH_CE_RTOL, and one planted fault on the meshless model
# (FAMILY_FAULTS) outside both logits bounds. The bounds are set from the
# families' own float32 readings on the card (1.3e-6 to 2.3e-5, PERF.md
# section 4): phase 9f's are set for olmoe's routing, and a fault that
# skips one reduce can sit inside them (Mamba's unreduced B/C/dt, 0.023)
FAMILY_LOGITS_RTOL = 1e-4
FAMILY_TOKEN_RTOL = 1e-4
FAMILY_DEEP_LAYERS = 1
FAMILY_RWKV_LAYERS = 2
FAMILY_WHISPER_LAYERS = 2


def family_configs():
    """{cell tag: (config of the cell, its published depth, through the
    launcher)}."""
    from repro_torch.configs import get_config
    w = FAMILY_WHISPER_LAYERS
    return {
        "DEEPSEEK-MESH-TRAIN": (dataclasses.replace(get_config(MLA_ARCH),
                                                    num_layers=FAMILY_DEEP_LAYERS), 61, True),
        "JAMBA-MESH-TRAIN": (dataclasses.replace(get_config(JAMBA_ARCH),
                                                 num_layers=FAMILY_DEEP_LAYERS,
                                                 moe_num_experts=2), 72, True),
        "RWKV6-MESH-TRAIN": (dataclasses.replace(get_config(RWKV_ARCH),
                                                 num_layers=FAMILY_RWKV_LAYERS), 24, True),
        "WHISPER-MESH-TRAIN": (dataclasses.replace(get_config(WHISPER_ARCH),
                                                   num_layers=2 * w, encoder_layers=w,
                                                   decoder_layers=w), 48, False),
    }


def quiet_unless(rank):
    """Print as rank 1 only (the census lines of ranks 2-3 are not shown)."""
    import contextlib
    import io
    return contextlib.nullcontext() if rank == 1 else contextlib.redirect_stdout(
        io.StringIO())


def census_counts(c):
    """(syncs in all, syncs inside a ``train.*`` range) of a census."""
    return c.total, sum(n for r, n in c.ranges.items() if r.startswith("train."))


def first_step_observed(make, rank, tag, out):
    """``make_train_step`` whose first step runs profiled on rank 0; on
    the other ranks the sync census opens at the first step (into
    ``out["census_open"]``; ``family_cell`` closes it), and every rank
    waits for the others after it. RWKV's first step is profiled on the
    device only (``profile_breakdown``'s ``host``)."""
    import torch.distributed as tdist
    from repro_torch.analysis.sync_census import SyncCensus

    def factory(model, tcfg):
        step = make(model, tcfg)
        seen = []

        def observed(state, batch):
            if seen:
                return step(state, batch)
            seen.append(True)
            if rank != 0:
                torch.cuda.synchronize()
                out["census_open"] = SyncCensus().__enter__()
                res = step(state, batch)
            else:
                box = []
                out["profile"] = profile_breakdown(
                    lambda: box.append(step(state, batch)), tag=f"{tag} rank 0 first step",
                    host=model.cfg.family != "ssm")[1:4]
                res = box[0]
            # the second step starts together on every rank, not after rank
            # 0's profile is read back (the RWKV step's 47,017 launches
            # took 47 s to read back with the host ops on the H100's host)
            tdist.barrier()
            return res

        return observed

    return factory


def census_closed(rank, tag, out):
    """Close the census that ``first_step_observed`` opened on this rank
    and check it (``census_checked``): its counts."""
    c = out.pop("census_open")
    c.__exit__(None, None, None)
    torch.cuda.synchronize()
    with quiet_unless(rank):
        return census_counts(census_checked(f"{tag} rank {rank}", c))


def family_cell(tag, cfg, launcher, rank, tmp, mesh, rules, kernels):
    """One phase-9g cell on this rank: its losses, step ms, peak, the
    profile or census of its first step and, through the launcher, its
    checked dedup launches."""
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.launch import train
    from repro_torch.models.model import build_model, shard_model
    from repro_torch.training import train_loop
    from repro_torch.training.optimizer import OptimizerConfig
    steps = MESH_TRAIN_STEPS
    out = {}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # on ranks 1-3 the census runs from the first step to the launcher's
    # end (its metrics' download and its events' synchronize): a step of
    # the dense families makes no host sync that the debug mode sees (gloo
    # stages on threads of its own), and a census that sees none cannot
    # tell it from a disarmed one; the dedup before it is left out, since
    # check_launches runs each kernel's plain version beside it
    observed = first_step_observed(train_loop.make_train_step, rank, tag, out)
    if launcher:
        argv = ["--arch", cfg.name, "--steps", str(steps), "--dedup", "--ckpt-every",
                str(steps + 1), "--ckpt-dir", os.path.join(tmp, f"ckpt-{tag}")]
        runs = []

        def watched():
            runs.append(train.main(argv, mesh=mesh))
            if rank != 0:
                out["census"] = census_closed(rank, f"{tag} steps and launcher's end", out)

        patched = train.get_config, train.make_train_step
        train.get_config, train.make_train_step = (lambda arch: cfg), observed
        try:
            for k in kernels:
                k.launches = 0
            out["checked"] = check_launches(watched, kernels)
            out["launches"] = {k.name: k.launches for k in kernels}
        finally:
            train.get_config, train.make_train_step = patched
        run = runs.pop()
        mets, step_ms = run.metrics, run.step_ms
        out["tokens"] = run.loader.cfg.batch_size * run.loader.cfg.seq_len
        out["local_params"] = sum(p.numel() for p in run.model.parameters())
        del run
    else:
        model = build_model(cfg, device="cuda",
                            generator=torch.Generator(device="cuda").manual_seed(0))
        shard_model(model, rules)
        out["local_params"] = sum(p.numel() for p in model.parameters())
        tcfg = train_loop.TrainConfig(opt=OptimizerConfig(
            lr=3e-4, warmup_steps=min(20, steps // 4), total_steps=steps))
        state = train_loop.init_train_state(model, tcfg)
        step_fn = observed(model, tcfg)
        batches, marks, mets = [], [], []
        with use_rules(rules):
            for i in range(steps):
                # the census (ranks 1-3) takes in the batch's upload
                batches.append(whisper_batch(cfg, i))
                begin = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                begin.record()
                _, m = step_fn(state, batches[-1])
                end.record()
                marks.append((begin, end))
                mets.append(m)
        if rank != 0:
            out["census"] = census_closed(rank, f"{tag} steps", out)
        torch.cuda.synchronize()
        step_ms = [a.elapsed_time(b) for a, b in marks]
        mets = [{k: float(v) for k, v in m.items()}  # repro: noqa[R001] the metrics read once, after the steps
                for m in mets]
        frames, tokens = batches[0]["frames"].shape[:2], batches[0]["tokens"].shape
        out["tokens"] = frames[0] * frames[1]
        out["decoder_tokens"] = tokens[0] * tokens[1]
        del model, state, step_fn, batches
    torch.cuda.synchronize()
    out.update(metrics=mets, step_ms=step_ms, peak=torch.cuda.max_memory_allocated())
    torch.cuda.empty_cache()
    return out


# the planted faults of the float32 checks, each on the meshless model,
# each what one rank of the first "model" coordinate computes when a
# collective of its layer is skipped or misplaced: MLA's query heads
# offset by one block of the 2-way split; Mamba's B, C and dt partial
# sums not reduced (from the first half of the inner channels alone);
# RWKV's w_o reduce skipped (its first block of rows alone); whisper's
# encoder output left unreduced (every encoder layer's attention output
# and MLP down projection from the first block of heads and ffn rows)
def plant_fault(tag, model):
    with torch.no_grad():
        if tag.startswith("DEEPSEEK"):
            for layer in model.stack.layers:
                w = layer.attn.w_uq
                w.copy_(torch.roll(w, w.shape[1] // 2, 1))
        elif tag.startswith("JAMBA"):
            for layer in model.stack.layers:
                if layer.mixer_key == "mamba":
                    for w in (layer.mamba.w_b, layer.mamba.w_c, layer.mamba.w_dt):
                        w[w.shape[0] // 2:] = 0
        elif tag.startswith("RWKV6"):
            for layer in model.stack.layers:
                layer.rwkv.w_o[layer.rwkv.w_o.shape[0] // 2:] = 0
        else:
            for layer in model.enc:
                for w in (layer.attn.wo, layer.mlp.w_down):
                    w[w.shape[0] // 2:] = 0


FAMILY_FAULTS = {"DEEPSEEK-MESH-TRAIN": "MLA heads offset by one block",
                 "JAMBA-MESH-TRAIN": "Mamba B/C/dt partial sums not reduced",
                 "RWKV6-MESH-TRAIN": "RWKV w_o reduce skipped",
                 "WHISPER-MESH-TRAIN": "whisper encoder output left unreduced"}


def family_check(tag, cfg, mesh, rules):
    """Phase 9g's float32 check of one family on this rank: (ce of the
    rows by the mesh, meshless and faulty models, {pair: distances})."""
    from repro_torch.core.routing import linear_shard_index
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.launch import specs
    from repro_torch.models.model import build_model, cross_entropy, shard_model
    import torch.distributed as tdist
    torch.backends.cuda.matmul.allow_tf32 = False  # a spawned rank's own setting
    depth = (dict(num_layers=2, encoder_layers=1, decoder_layers=1)
             if cfg.family == "encdec" else dict(num_layers=1))
    cfg = dataclasses.replace(cfg, param_dtype="float32", compute_dtype="float32", **depth)
    frames = WHISPER_FRAMES if cfg.family == "encdec" else 256
    batch = specs.train_batch(cfg, frames, 8, concrete=True,
                              rng=np.random.default_rng(3), device="cuda")

    def built():
        return build_model(cfg, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(0))

    def run(model, rows):
        """(the logits, the MTP head's after them where there is one; ce)."""
        with torch.no_grad():
            logits, aux = model.apply(rows)
            ce = cross_entropy(logits, spmd.batch_rows(rows["targets"]))[0]
            if "mtp_logits" in aux:
                logits = torch.cat([logits, aux["mtp_logits"]])
        return logits.float(), float(ce)

    def dist_(a, b):
        tok = (torch.linalg.vector_norm(a - b, dim=-1)
               / torch.linalg.vector_norm(b, dim=-1)).flatten()
        return (float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b)),
                float(tok.median()))

    model = built()
    shard_model(model, rules)
    torch.cuda.empty_cache()
    with use_rules(rules):
        mesh_logits, mesh_ce = run(model, batch)
    del model
    torch.cuda.empty_cache()
    ces, dists = {"mesh": mesh_ce}, {}
    if linear_shard_index(mesh, ("model",)) == 0:
        n = batch["tokens"].shape[0] // mesh.size(0)
        first = linear_shard_index(mesh, ("data",)) * n
        rows = {k: v[first:first + n] for k, v in batch.items()}
        model = built()
        logits, ces["meshless"] = run(model, rows)
        dists["mesh~meshless"] = dist_(mesh_logits, logits)
        plant_fault(tag, model)
        fault, ces["fault"] = run(model, rows)
        dists["mesh~fault"] = dist_(mesh_logits, fault)
        del model, logits, fault
    del mesh_logits
    torch.cuda.empty_cache()
    tdist.barrier()
    return {"ce": ces, "dists": dists}


def family_phase(rank, tmp, mesh, rules, kernels):
    """Phase 9g on this rank: {tag: cell results and check}."""
    out = {}
    for tag, (cfg, _, launcher) in family_configs().items():
        t0 = time.perf_counter()
        out[tag] = family_cell(tag, cfg, launcher, rank, tmp, mesh, rules, kernels)
        t1 = time.perf_counter()  # repro: noqa[R004] family_cell synchronizes at its end
        out[tag]["check"] = family_check(tag, cfg, mesh, rules)
        torch.cuda.synchronize()
        t2 = time.perf_counter()  # repro: noqa[R004] synchronized on the line above
        out[tag]["cell_s"], out[tag]["check_s"] = t2 - t0, t2 - t1
    return out


def family_report(ranks):
    """Phase 9g's lines and assertions over every rank's results."""
    for tag, (cfg, depth, launcher) in family_configs().items():
        cells = [r["families"][tag] for r in ranks]
        first = cells[0]
        losses = [[m["loss"] for m in c["metrics"]] for c in cells]
        if any(l != losses[0] for l in losses) or not (
                len(losses[0]) == MESH_TRAIN_STEPS and np.isfinite(losses[0]).all()):
            raise AssertionError(f"{tag}: losses by rank {losses}")
        if launcher:
            for r, c in enumerate(cells):
                if c["checked"] != c["launches"] or not all(c["launches"].values()):
                    raise AssertionError(f"{tag} rank {r}: checked launches "
                                         f"{c['checked']}, counted {c['launches']}")
        timed = max(c["step_ms"][-1] for c in cells)
        m = first["metrics"][-1]
        unit = "frames" if cfg.family == "encdec" else "tokens"
        layers = (f"{cfg.encoder_layers}+{cfg.decoder_layers} of 24+24 layers"
                  if cfg.family == "encdec" else f"{cfg.num_layers} of {depth} layers")
        print(f"{tag}: {cfg.name} at its published widths (d_model {cfg.d_model}, "
              f"vocab {cfg.vocab_size}, {cfg.moe_num_experts} experts, mtp {cfg.mtp}) at "
              f"{layers}, {cfg.param_dtype}, remat {cfg.remat}, on {MESH_RANKS} gloo ranks "
              f"of the card, mesh {dict(zip(('data', 'model'), MESH_TRAIN_SHAPE))} under "
              f"production_rules, {'the launcher with --dedup' if launcher else 'make_train_step'}"
              f": {MESH_TRAIN_STEPS} steps, losses {losses[0]} (equal on every rank); "
              f"last step's metrics {m}", flush=True)
        print(f"{tag}: step {MESH_TRAIN_STEPS} step_ms={timed} (the slowest rank's; by "
              f"rank {[c['step_ms'][-1] for c in cells]}) {unit}_per_s="
              f"{first['tokens'] / (timed / 1e3)}; first step_ms="
              f"{[c['step_ms'][0] for c in cells]}; each rank's max_memory_allocated="
              f"{[c['peak'] for c in cells]}; parameters held a rank "
              f"{[c['local_params'] for c in cells]}; cell_s="
              f"{[round(c['cell_s'], 1) for c in cells]} (rank 0's: set-up and dedup "
              f"{first['cell_s'] - first['check_s'] - sum(first['step_ms']) / 1e3:.1f}, "
              f"steps {sum(first['step_ms']) / 1e3:.1f}, float32 check "
              f"{first['check_s']:.1f}); census syncs (all, inside "
              f"train.* ranges) on ranks 1-{MESH_RANKS - 1} from the first step to "
              f"{'the launcher' + chr(39) + 's end' if launcher else 'the last'} "
              f"{[c['census'] for c in cells[1:]]}", flush=True)
        wall, busy, n_launch = first["profile"]
        print(f"{tag}: the profiled first step on rank 0: wall_ms={wall * 1e3} "
              f"device_busy_ms={busy * 1e3} device_idle_share={1 - busy / wall:.4f} "
              f"launches={n_launch}", flush=True)
        if launcher:
            print(f"{tag}: dedup launches by rank (each held against its plain version) "
                  f"{[c['launches'] for c in cells]}", flush=True)
        checks = [c["check"] for c in cells]
        dists = [d for c in checks for k, d in c["dists"].items() if k == "mesh~meshless"]
        faults = [d for c in checks for k, d in c["dists"].items() if k == "mesh~fault"]
        spread = max(abs(c["ce"]["mesh"] - c["ce"]["meshless"]) / c["ce"]["meshless"]
                     for c in checks if "meshless" in c["ce"])
        print(f"{tag} check: float32 at one layer, ce of each rank's rows {checks}; "
              f"mesh~meshless largest {max(d[0] for d in dists)} (bound "
              f"{FAMILY_LOGITS_RTOL}), median token's {max(d[1] for d in dists)} (bound "
              f"{FAMILY_TOKEN_RTOL}), ce {spread} (bound {MESH_CE_RTOL}); planted fault "
              f"({FAMILY_FAULTS[tag]}) least {min(d[0] for d in faults)} and "
              f"{min(d[1] for d in faults)}", flush=True)
        if (len(dists) != 2 or max(d[0] for d in dists) > FAMILY_LOGITS_RTOL
                or max(d[1] for d in dists) > FAMILY_TOKEN_RTOL or spread > MESH_CE_RTOL):
            raise AssertionError(f"{tag} check: {checks}")
        if len(faults) != 2 or any(d[0] <= FAMILY_LOGITS_RTOL or d[1] <= FAMILY_TOKEN_RTOL
                                   for d in faults):
            raise AssertionError(f"{tag} check: the planted fault within the bound: {checks}")


def training_mesh(olmoe=True):
    """Phase 9f, MESH-OLMOE-TRAIN (``olmoe``), and phase 9g, every family,
    on MESH_RANKS gloo ranks of the card, one spawn.
    Returns rank 0's 9f dedup launches (each rank launches as many), or
    None without ``olmoe``."""
    import pickle
    import torch.multiprocessing as mp
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(mesh_train_rank, args=(MESH_RANKS, f"file://{tmp}/init", tmp,
                                                  olmoe),
                           nprocs=MESH_RANKS, start_method="spawn")
        ranks = []
        for r in range(MESH_RANKS):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                ranks.append(pickle.load(f))
    family_report(ranks)
    print(f"phase 9g: cell_s by cell (rank 0) "
          f"{ {t: round(c['cell_s'], 1) for t, c in ranks[0]['families'].items()} }",
          flush=True)
    if not olmoe:
        print(f"phase 9g: phase_s={time.perf_counter() - t_phase:.1f}", flush=True)  # repro: noqa[R004] phase wall time, printed only
        return None
    cfg = mesh_train_config()
    first = ranks[0]
    for r, got in enumerate(ranks):
        if got["checked"] != got["launches"] or not all(got["launches"].values()):
            raise AssertionError(f"MESH-OLMOE-TRAIN rank {r}: checked launches "
                                 f"{got['checked']}, counted {got['launches']}")
        losses = [m["loss"] for m in got["metrics"]]
        if not (len(losses) == MESH_TRAIN_STEPS and np.isfinite(losses).all()):
            raise AssertionError(f"MESH-OLMOE-TRAIN rank {r}: losses {losses}")
    losses = [m["loss"] for m in first["metrics"]]
    timed = [max(g["step_ms"][i] for g in ranks) for i in range(1, MESH_TRAIN_STEPS)]
    print(f"MESH-OLMOE-TRAIN: {cfg.name} at {cfg.num_layers} of 16 layers (d_model "
          f"{cfg.d_model}, {cfg.num_heads} heads of {cfg.head_dim}, {cfg.moe_num_experts} "
          f"experts of d_ff {cfg.moe_d_ff} top-{cfg.moe_top_k}, vocab {cfg.vocab_size}, "
          f"{cfg.param_dtype}, remat {cfg.remat}, capacity_factor {cfg.capacity_factor}, "
          f"moe_impl {cfg.moe_impl}) on {MESH_RANKS} gloo ranks of the card, mesh "
          f"{dict(zip(('data', 'model'), MESH_TRAIN_SHAPE))} under production_rules; "
          f"batch 8 x 256 from the deduplicated loader: {MESH_TRAIN_STEPS} steps, "
          f"losses {losses} (each rank: {[[m['loss'] for m in g['metrics']] for g in ranks]}); "
          f"moe_aux {[m['moe_aux'] for m in first['metrics']]}; moe_dropped "
          f"{[int(m['moe_dropped']) for m in first['metrics']]}; grad_norm "
          f"{[m['grad_norm'] for m in first['metrics']]}", flush=True)
    print(f"MESH-OLMOE-TRAIN: steps 2-{MESH_TRAIN_STEPS} step_ms={np.mean(timed)} (the "
          f"slowest rank's; min {min(timed)} max {max(timed)}) tokens_per_s="
          f"{first['tokens'] * len(timed) / (sum(timed) / 1e3)}; first step_ms="
          f"{[g['step_ms'][0] for g in ranks]}; each rank's max_memory_allocated="
          f"{[g['peak'] for g in ranks]} of the card's "
          f"{torch.cuda.get_device_properties(0).total_memory}; parameters held a rank "
          f"{[g['local_params'] for g in ranks]}; launcher run_s="
          f"{[round(g['run_s'], 1) for g in ranks]}; census syncs in one step on "
          f"ranks 1-{MESH_RANKS - 1} {[g['census'] for g in ranks[1:]]}", flush=True)
    wall, busy, n_launch = first["profile"]
    print(f"MESH-OLMOE-TRAIN: a profiled step on rank 0: wall_ms={wall * 1e3} "
          f"device_busy_ms={busy * 1e3} device_idle_share={1 - busy / wall:.4f} "
          f"launches={n_launch}", flush=True)
    print(f"MESH-OLMOE-TRAIN: dedup launches by rank (each held against its plain "
          f"version) {[g['launches'] for g in ranks]}", flush=True)
    runs = [g["check"]["runs"] for g in ranks]
    dists = [g["check"]["dists"] for g in ranks]
    print(f"mesh train check: one batch at capacity_factor {MESH_CHECK_CF}, (ce, "
          f"moe_aux, dropped) by rank {runs}; logits' relative distances by rank "
          f"{dists} (bound {MESH_LOGITS_RTOL})", flush=True)
    ces = [r[k][0] for r in runs for k in ("psum", "a2a", "meshless") if k in r]
    ce_spread = (max(ces) - min(ces)) / min(ces)
    within = [v for d in dists for k, v in d.items() if ":" not in k]
    faults = [v for d in dists for k, v in d.items() if k.startswith("psum~fault")]
    print(f"mesh train check: ce spread {ce_spread} (bound {MESH_CE_RTOL}); largest "
          f"logits distance {max(v[0] for v in within)} (bound {MESH_LOGITS_RTOL}), "
          f"median token's {max(v[1] for v in within)} (bound {MESH_TOKEN_RTOL}); the "
          f"planted faults' least {min(v[0] for v in faults)} and "
          f"{min(v[1] for v in faults)}", flush=True)
    if (max(v[0] for v in within) > MESH_LOGITS_RTOL
            or max(v[1] for v in within) > MESH_TOKEN_RTOL or ce_spread > MESH_CE_RTOL
            or any(r[k][2] != 0 for r in runs for k in ("psum", "a2a", "meshless")
                   if k in r)):
        raise AssertionError(f"mesh train check: {runs} {dists}")
    if len(faults) != 4 or any(v[0] <= MESH_LOGITS_RTOL or v[1] <= MESH_TOKEN_RTOL
                               for v in faults):
        raise AssertionError(f"mesh train check: a planted fault within the bound: {dists}")
    print(f"phase 9f and 9g: phase_s="
          f"{time.perf_counter() - t_phase:.1f}", flush=True)  # repro: noqa[R004] phase wall time, printed only
    return first["launches"]


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
    return census_checked(tag, c)


def census_checked(tag, c):
    """``census``'s lines and checks of a finished census ``c``."""
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
    probe pass at client batch 8, a TINYLLAMA-SERVE decode step,
    launch/train.py --dedup for CENSUS_TRAIN_STEPS steps, an OLMOE-SERVE
    and a DEEPSEEK-SERVE decode step, CENSUS_TRAIN_STEPS OLMOE-TRAIN
    steps, an RWKV6-SERVE and a JAMBA-SERVE decode step,
    CENSUS_TRAIN_STEPS RWKV6-TRAIN steps, a WHISPER-SERVE decode step,
    INTERNVL-SERVE's patch prefill and CENSUS_TRAIN_STEPS WHISPER-TRAIN
    steps."""
    from repro_torch.core import hdb
    from repro_torch.data import pipeline
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
    lm_census(totals)
    print(f"census: syncs a run {totals}; every site in the inventory", flush=True)
    print(f"phase 10: phase_s={time.perf_counter() - t_phase:.1f}", flush=True)  # repro: noqa[R004] phase wall time, printed only


def decode_census(totals, tag, cfg):
    """One decode step of ``cfg``'s engine (every slot admitted by the step
    before) under the census, its total into ``totals``."""
    from repro_torch.models.model import build_model
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving import smoke as serve_smoke
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))
    eng = ServingEngine(model, batch_slots=LM_SLOTS, max_len=LM_MAX_LEN)
    for uid, prompt, max_new in serve_smoke.lm_requests(cfg.vocab_size, LM_SLOTS,
                                                         LM_MAX_NEW):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=max_new, eos_id=-1))
    eng.step()  # admits (prefills) every slot
    totals[tag] = census(f"{tag} decode step", eng.step).total
    del model, eng
    torch.cuda.empty_cache()


def train_census(totals, tag, cfg):
    """CENSUS_TRAIN_STEPS train steps of ``cfg``'s train cell under the
    census, the total into ``totals``."""
    model, state, step_fn, ld = train_setup(cfg, CENSUS_TRAIN_STEPS)

    def steps():
        nonlocal state
        for i in range(CENSUS_TRAIN_STEPS):
            x, y = ld.batch(i)
            state, _ = step_fn(state, {"tokens": x, "targets": y})

    totals[tag] = census(f"{tag} {CENSUS_TRAIN_STEPS} train steps", steps).total
    del model, state, step_fn
    torch.cuda.empty_cache()


def lm_census(totals):
    """Phase 10's LM runs, each total into ``totals``: a TINYLLAMA-SERVE
    decode step, launch/train.py --dedup for CENSUS_TRAIN_STEPS steps, an
    OLMOE-SERVE and a DEEPSEEK-SERVE decode step, CENSUS_TRAIN_STEPS
    OLMOE-TRAIN steps, then ``recurrent_census`` and ``encdec_census``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    decode_census(totals, "TINYLLAMA-SERVE", get_config(LM_ARCH))
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
    decode_census(totals, "OLMOE-SERVE", get_config(MOE_ARCH))
    decode_census(totals, "DEEPSEEK-SERVE", dataclasses.replace(get_config(MLA_ARCH),
                                                                num_layers=MLA_SERVE_LAYERS))
    train_census(totals, "OLMOE-TRAIN", moe_train_config())
    recurrent_census(totals)
    encdec_census(totals)


def recurrent_census(totals):
    """Phase 10's recurrent runs: an RWKV6-SERVE and a JAMBA-SERVE decode
    step, and CENSUS_TRAIN_STEPS RWKV6-TRAIN steps."""
    from repro_torch.configs import get_config
    decode_census(totals, "RWKV6-SERVE", get_config(RWKV_ARCH))
    decode_census(totals, "JAMBA-SERVE", jamba_serve_config())
    train_census(totals, "RWKV6-TRAIN", rwkv_train_config())


def encdec_census(totals):
    """Phase 10's encoder-decoder and VLM runs: a WHISPER-SERVE decode step
    (the tokens up, the argmax down, as the engine's), INTERNVL-SERVE's
    patch prefill with its first tokens downloaded, and CENSUS_TRAIN_STEPS
    WHISPER-TRAIN steps, each batch drawn and uploaded in the step."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving import smoke as serve_smoke
    cfg = get_config(WHISPER_ARCH)
    model = build_model(cfg, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))
    frames, prompts = encdec_inputs(cfg, WHISPER_BATCH, WHISPER_FRAMES, WHISPER_PROMPT,
                                    "cuda")
    enc_out = model.encode(frames)
    caches = model.init_caches(WHISPER_BATCH, WHISPER_MAX_LEN)
    logits, caches = model.prefill({"frames": frames, "tokens": torch.from_numpy(
        prompts).cuda()}, caches)
    tok = serve_smoke.greedy(logits)
    totals["WHISPER-SERVE"] = census("WHISPER-SERVE decode step", lambda: serve_smoke.greedy_step(
        model, tok, caches, {"enc_out": enc_out})).total
    del model, enc_out, caches, logits
    torch.cuda.empty_cache()

    vlm = vlm_serve_config()
    model = build_model(vlm, device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(0))
    patches, tokens = patch_inputs(vlm, WHISPER_BATCH, PATCH_TEXT, "cuda")
    caches = model.init_caches(WHISPER_BATCH, LM_MAX_LEN)
    totals["INTERNVL-SERVE"] = census("INTERNVL-SERVE patch prefill", lambda: serve_smoke.greedy(
        model.prefill({"patches": patches, "tokens": tokens}, caches)[0])).total
    del model, caches
    torch.cuda.empty_cache()

    model, state, step_fn = whisper_train_setup(CENSUS_TRAIN_STEPS)

    def steps():
        nonlocal state
        for i in range(CENSUS_TRAIN_STEPS):
            state, _ = step_fn(state, whisper_batch(model.cfg, i))

    totals["WHISPER-TRAIN"] = census(f"WHISPER-TRAIN {CENSUS_TRAIN_STEPS} train steps",
                                     steps).total
    del model, state, step_fn
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
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
    serving_moe()
    serving_recurrent()
    serving_encdec()
    train_launches = training_full_width(kernels)
    training_check()
    training_moe()
    training_recurrent()
    training_encdec()
    mesh_train_launches = training_mesh()
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
        row["mesh_train_launches"] = mesh_train_launches[row["name"]]
        row["card"] = card
        print(f"kernel {row['name']}: ms={row['ms']:.4f} plain_ms="
              f"{row['plain_ms']:.4f} bound_ms={row['bound_ms']:.4f} "
              f"({row['bound_by']}) library_ms={row['library_ms']} "
              f"call_ms={row['call_ms']:.4f} [{row['shape']}]", flush=True)
        for key in ("compact_scatter_ms", "by_width"):
            if key in row:
                print(f"kernel {row['name']}: {key}={row[key]}", flush=True)
    print(f"chip_smoke: total_s={time.perf_counter() - t_start:.1f}", flush=True)  # repro: noqa[R004] the script's wall time, printed only
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
