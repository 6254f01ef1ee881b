"""Helpers of the port's mesh tests (``tests/test_torch_distributed.py``,
``test_torch_sharded_mesh.py``, ``test_torch_launch.py``).

Two halves, run in separate processes:

- ``run_world(job, world, tmp)`` spawns ``world`` ranks (``spawn`` start
  method) that join one gloo group through ``file://`` (no TCP port, so
  parallel test workers never clash) and run the port's ``job`` on the
  CPU; every rank pickles what it returned to ``tmp``, and the list of
  per-rank results comes back in rank order.
- ``python tests/_torch_mesh_worker.py ref <job> <out>``, started with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=8``, runs the JAX
  package's counterpart on emulated host devices and pickles it to
  ``out``; ``reference_process`` starts it.

The scenarios, seeds and configurations are those of the reference's
``tests/_dist_worker.py`` and ``tests/_shard_worker.py``.
"""
import os
import pickle
import subprocess
import sys
import warnings

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")

# _dist_worker.py: the corpus, HDB config and meshes
SPEC = dict(num_entities=900, seed=11)
HDB_CFG = dict(max_block_size=40, max_iterations=5)
PAD_TO = 8
MESHES = {"flat": ((8,), ("data",)), "pod": ((2, 4), ("pod", "data")),
          "3axis": ((2, 2, 2), ("pod", "data", "model")), "flat4": ((4,), ("data",))}
EXACT_CHUNK, SAMPLED_CHUNK, SAMPLE_SEED, EMPTY_CHUNK = 4096, 1024, 13, 256
# a run on the 4-shard mesh where the CMS over-counts (the Bloom recovers
# right-sized blocks), over-sized blocks repeat and the fixed-capacity
# buffers overflow
STRESS_CFG = dict(max_block_size=5, max_iterations=4, cms_width=1 << 14)
STRESS_DIST = dict(route_slack=0.5, rep_capacity_per_shard=64)
# a slack whose buckets (ceil(chunk / n * slack) lanes) must overflow
OVERFLOW_SLACK = 0.05

# _shard_worker.py: the store config and scenarios
# name: (mesh, n_shards, route_slack, expect_fallback, n, card)
SHARD_CFG = dict(max_block_size=8, max_iterations=5, max_oversize_keys=6,
                 cms_width=1 << 10)
SHARD_SCENARIOS = {"flat": ("flat", 8, 2.0, False, 120, 20),
                   "flat-sub4": ("flat4", 4, 2.0, False, 120, 20),
                   "pod": ("pod", 8, 2.0, False, 120, 20),
                   "3axis": ("3axis", 8, 2.0, False, 120, 20),
                   "overflow": ("flat", 8, 0.01, True, 240, 120)}

# the launcher's arguments (both packages' launch/block.py)
LAUNCH_ARGV = ["--entities", "300", "--max-block-size", "40"]


def stats_rows(stats):
    """IterationStats -> (iterations, fields) int64 rows, in field order."""
    import dataclasses
    return np.array([[getattr(st, f.name) for f in dataclasses.fields(st)]
                     for st in stats], np.int64).reshape(len(stats), -1)


def blocking_out(res):
    return {"rids": np.asarray(res.rids, np.int64), "key_hi": res.key_hi,
            "key_lo": res.key_lo, "stats": stats_rows(res.stats),
            "num_records": res.num_records}


def pairset_out(ps):
    return {"a": np.asarray(ps.a, np.int64), "b": np.asarray(ps.b, np.int64),
            "src_size": np.asarray(ps.src_size, np.int64), "exact": ps.exact,
            "total_slots": ps.total_slots}


def blocks_out(blk):
    return {f: np.asarray(getattr(blk, f))
            for f in ("key_hi", "key_lo", "start", "size", "members")}


def caught_names(caught):
    return sorted(w.category.__name__ for w in caught
                  if not issubclass(w.category, FutureWarning))


def empty_shard_blocks(blocks_cls):
    """One tiny block: a single pair, every other shard idle."""
    return blocks_cls(np.zeros(1, np.uint32), np.zeros(1, np.uint32),
                      np.zeros(1, np.int64), np.array([2], np.int64),
                      np.array([3, 9], np.int64))


# ---------------------------------------------------------------------------
# the port's ranks
# ---------------------------------------------------------------------------


def _port_keys():
    from repro_torch.core import blocks, distributed
    from repro_torch.data import synthetic
    corpus = synthetic.generate(synthetic.SyntheticSpec(**SPEC), device="cpu")
    return distributed.pad_rows(*blocks.build_keys(corpus.columns, corpus.blocking),
                                PAD_TO)


def _mesh(name):
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    shape, axes = MESHES[name]
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=axes), axes


def _routed(blk, mesh, axes, **kw):
    from repro_torch.core import distributed
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ps = distributed.dedupe_pairs_distributed(blk, mesh, axes, device="cpu", **kw)
    return {**pairset_out(ps), "warnings": caught_names(caught)}


def _exchange_rows(mesh, axes):
    """Row p of every exchanged bucket must come from source shard p."""
    import torch
    from repro_torch.core import routing
    from repro_torch.distributed import sharding
    sh = sharding.shards(mesh, axes)
    n, cap = sh.n_shards, 3
    # entry (dst, slot) sent by shard s holds s * 1000 + dst * 10 + slot
    key = torch.arange(n * cap, dtype=torch.int64).view(n, cap)
    sent = sh.shard * 1000 + (key // cap) * 10 + key % cap
    (got,) = routing.exchange(sh.group, sent)
    src = torch.arange(n)[:, None]
    return bool(torch.equal(got, src * 1000 + sh.shard * 10 + torch.arange(cap)[None, :]))


def _pair_runs(blk, mesh, axes, routed, global_run):
    """The routed dedupe variants over ``blk``, through ``routed(blk, **kw)``
    and ``global_run(blk, **kw)``."""
    budget = blk.num_pair_slots // 3
    return {"exact": routed(blk, chunk_per_shard=EXACT_CHUNK),
            "sampled": routed(blk, budget=budget, chunk_per_shard=SAMPLED_CHUNK,
                              sample_seed=SAMPLE_SEED),
            "empty": routed(empty_shard_blocks(type(blk)), chunk_per_shard=EMPTY_CHUNK),
            "overflow": routed(blk, chunk_per_shard=EXACT_CHUNK,
                               route_slack=OVERFLOW_SLACK),
            "global": pairset_out(global_run(blk, chunk_per_shard=EXACT_CHUNK,
                                             dedupe="global"))}


def _stress(run):
    """The stress run's result and the warnings it raised."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        res = run(STRESS_CFG, STRESS_DIST)
    return {**blocking_out(res), "warnings": caught_names(caught)}


def job_hdb(world):
    """Distributed HDB and the routed dedupe on every mesh of ``world``
    ranks, beside the port's single-device results. The pairs' blocks are
    those of the one-dim mesh's result."""
    from repro_torch.core import distributed, hdb, pairs
    keys, valid = _port_keys()
    cfg = hdb.HDBConfig(**HDB_CFG)
    out = {"single": blocking_out(hdb.hashed_dynamic_blocking(keys, valid, cfg,
                                                             device="cpu"))}
    blk = None
    for name, (shape, axes) in MESHES.items():
        if int(np.prod(shape)) != world:
            continue
        mesh, axes = _mesh(name)
        states = []
        got = distributed.distributed_hashed_dynamic_blocking(
            keys, valid, cfg, mesh, axes, device="cpu",
            checkpoint_cb=lambda it, st: states.append(
                (it, tuple(st["keys"].shape), tuple(st["valid"].shape),
                 tuple(st["psize"].shape))))
        out[f"hdb/{name}"] = blocking_out(got)
        out[f"checkpoints/{name}"] = states
        if name == "flat4":
            out["stress/flat4"] = _stress(lambda cfg, dcfg: (
                distributed.distributed_hashed_dynamic_blocking(
                    keys, valid, hdb.HDBConfig(**cfg), mesh, axes,
                    dist=distributed.DistConfig(**dcfg), device="cpu")))
        out[f"exchange/{name}"] = _exchange_rows(mesh, axes)
        if blk is None:
            blk = pairs.build_blocks(got, device="cpu")
            budget = blk.num_pair_slots // 3
            out["blocks"] = blocks_out(blk)
            out["single/exact"] = pairset_out(pairs.dedupe_pairs(blk, device="cpu"))
            out["single/sampled"] = pairset_out(pairs.dedupe_pairs(
                blk, budget=budget, sample_seed=SAMPLE_SEED, device="cpu"))
            out["single/empty"] = pairset_out(pairs.dedupe_pairs(
                empty_shard_blocks(pairs.Blocks), device="cpu"))
            # every variant on the one-dim mesh; the multi-dim meshes run
            # the exact path through dedupe_pairs(backend="distributed")
            out[f"pairs/{name}"] = _pair_runs(
                blk, mesh, axes, lambda b, **kw: _routed(b, mesh, axes, **kw),
                lambda b, **kw: distributed.materialize_pairs_distributed(
                    b, mesh, axes, device="cpu", **kw))
        out[f"backend/{name}"] = pairset_out(pairs.dedupe_pairs(
            blk, backend="distributed", device="cpu", mesh=mesh, axis_names=axes))
    return out


def _store_out(store, blk, caught, queries):
    acc = store.accepted_blocks(1)
    return {"led_pack": store.led_pack, "led_src": store.led_src,
            "accepted": blocks_out(acc),
            "exchange_total": store.router.exchange_total,
            "exchange_fallback_total": store.router.exchange_fallback_total,
            "routed_fallback_total": blk.routed_fallback_total,
            "capacity_warnings": caught, "queries": queries}


def _queries(blk, qk, qv):
    """Both probe modes of the read path."""
    return [[(r.candidates, r.block_sizes) for r in
             blk.query_keys(qk, qv, include_probe=ip)] for ip in (False, True)]


def port_shard_keys(rng, n, k, card):
    from repro_torch.core import u64
    from repro_torch.streaming import smoke
    key, v = smoke.scenario_keys(rng, n, k, card, "cpu")
    return u64.to_numpy_u64(key), v.numpy()


def job_shard(world):
    """The _shard_worker scenarios of ``world`` ranks through the port's
    ShardedBlockStore on a mesh, beside the port's single BlockStore."""
    from repro_torch.core import hdb
    from repro_torch.core.hdb import RepCapacityWarning
    from repro_torch.streaming import BlockStore, DeltaBlocker, ShardedBlockStore
    out = {}
    for tag, (mesh_name, n_shards, slack, _, n, card) in SHARD_SCENARIOS.items():
        if n_shards != world:
            continue
        mesh, axes = _mesh(mesh_name)
        rng = np.random.default_rng(17)
        keys, valid = port_shard_keys(rng, n, 5, card)
        cfg = hdb.HDBConfig(**SHARD_CFG)
        single = DeltaBlocker(BlockStore(cfg, device="cpu"))
        st = ShardedBlockStore(cfg, n_shards=n_shards, mesh=mesh, axis_names=axes,
                               route_slack=slack, device="cpu")
        sblk = DeltaBlocker(st)
        assert sblk.mesh is mesh
        cuts = [0, n // 4 + 1, n // 2, 3 * n // 4 + 1, n]
        caught = 0
        for a, b in zip(cuts[:-1], cuts[1:]):
            single.ingest_keys(keys[a:b], valid[a:b])
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                sblk.ingest_keys(keys[a:b], valid[a:b])
            caught += sum(issubclass(x.category, RepCapacityWarning) for x in w)
        qk, qv = port_shard_keys(rng, 12, 5, 20)
        out[tag] = _store_out(st, sblk, caught, _queries(sblk, qk, qv))
        out[tag]["keys"] = keys
        acc = single.store.accepted_blocks(1)
        out[tag]["single"] = {"led_pack": single.store.led_pack,
                              "led_src": single.store.led_src,
                              "accepted": blocks_out(acc),
                              "queries": _queries(single, qk, qv)}
    return out


def job_launch(world):
    from repro_torch.launch import block
    res = block.main(LAUNCH_ARGV + ["--device", "cpu"])
    return blocking_out(res)


JOBS = {"hdb": job_hdb, "shard": job_shard, "launch": job_launch}


def _rank_main(rank, world, init, tmp, job):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    # torch 2.13 renames all_gather_into_tensor; the port keeps the name
    # the chip's torch 2.11 has
    warnings.filterwarnings("ignore", category=FutureWarning)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        out = JOBS[job](world)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(tmp, f"{job}_{world}_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_world(job, world, tmp):
    """Run ``job`` on ``world`` gloo ranks; the per-rank results in rank order."""
    import torch.multiprocessing as mp
    tmp = str(tmp)
    init = f"file://{os.path.join(tmp, f'{job}_{world}.init')}"
    mp.start_processes(_rank_main, args=(world, init, tmp, job), nprocs=world,
                       start_method="spawn")
    out = []
    for rank in range(world):
        with open(os.path.join(tmp, f"{job}_{world}_{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# ---------------------------------------------------------------------------
# the JAX reference (run with 8 emulated host devices)
# ---------------------------------------------------------------------------


def _jax_mesh(name):
    import jax
    from jax.sharding import Mesh
    shape, axes = MESHES[name]
    devs = np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, axes), axes


def ref_hdb(name):
    """The reference on the one-dim mesh ``name``: distributed HDB, the
    routed dedupe variants over its result's blocks and, on the 4-shard
    mesh, the stress run."""
    import jax.numpy as jnp
    from repro.core import blocks, distributed, hdb, pairs
    from repro.data import synthetic
    corpus = synthetic.generate(synthetic.SyntheticSpec(**SPEC))
    keys, valid = blocks.build_keys(corpus.columns, corpus.blocking)
    pad = (-valid.shape[0]) % PAD_TO
    keys = jnp.concatenate([keys, jnp.full((pad,) + keys.shape[1:], 0xFFFFFFFF,
                                           jnp.uint32)])
    valid = jnp.concatenate([valid, jnp.zeros((pad, valid.shape[1]), bool)])
    cfg = hdb.HDBConfig(**HDB_CFG)
    out = {}
    mesh, axes = _jax_mesh(name)
    res = distributed.distributed_hashed_dynamic_blocking(keys, valid, cfg, mesh, axes)
    out[f"hdb/{name}"] = blocking_out(res)
    if name == "flat4":
        out["stress/flat4"] = _stress(lambda c, d: (
            distributed.distributed_hashed_dynamic_blocking(
                keys, valid, hdb.HDBConfig(**c), mesh, axes,
                dist=distributed.DistConfig(**d))))
    blk = pairs.build_blocks(res)
    out[f"blocks/{name}"] = blocks_out(blk)

    def routed(b, **kw):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ps = distributed.dedupe_pairs_distributed(b, mesh, axes, **kw)
        return {**pairset_out(ps), "warnings": caught_names(caught)}

    out[f"pairs/{name}"] = _pair_runs(
        blk, mesh, axes, routed,
        lambda b, **kw: distributed.materialize_pairs_distributed(b, mesh, axes, **kw))
    return out


def ref_shard_keys(rng, n, k, card):
    import jax.numpy as jnp
    from repro.core import blocks
    from repro_torch.streaming import smoke
    k64, valid = smoke.scenario_key64(rng, n, k, card)
    keys = np.stack([(k64 >> np.uint64(32)).astype(np.uint32),
                     (k64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)], -1)
    h, lo, v = blocks.dedupe_row_keys(jnp.asarray(keys[..., 0]),
                                      jnp.asarray(keys[..., 1]), jnp.asarray(valid))
    return np.stack([np.asarray(h), np.asarray(lo)], -1), np.asarray(v)


def ref_shard():
    from repro.core import hdb
    from repro.core.hdb import RepCapacityWarning
    from repro.streaming.delta import DeltaBlocker
    from repro.streaming.shard import ShardedBlockStore
    out = {}
    for tag, (mesh_name, n_shards, slack, _, n, card) in SHARD_SCENARIOS.items():
        mesh, axes = _jax_mesh(mesh_name)
        rng = np.random.default_rng(17)
        keys, valid = ref_shard_keys(rng, n, 5, card)
        st = ShardedBlockStore(hdb.HDBConfig(**SHARD_CFG), n_shards=n_shards,
                               mesh=mesh, axis_names=axes, route_slack=slack)
        sblk = DeltaBlocker(st)
        cuts = [0, n // 4 + 1, n // 2, 3 * n // 4 + 1, n]
        caught = 0
        for a, b in zip(cuts[:-1], cuts[1:]):
            with warnings.catch_warnings(record=True) as w:
                warnings.simplefilter("always")
                sblk.ingest_keys(keys[a:b], valid[a:b])
            caught += sum(issubclass(x.category, RepCapacityWarning) for x in w)
        out[tag] = _store_out(st, sblk, caught,
                              _queries(sblk, *ref_shard_keys(rng, 12, 5, 20)))
        out[tag]["keys"] = ((keys[..., 0].astype(np.uint64) << np.uint64(32))
                            | keys[..., 1].astype(np.uint64))
    return out


def ref_launch(n_dev):
    """The reference launcher's computation on ``n_dev`` devices, and the
    line it prints."""
    import contextlib
    import io
    import jax
    import jax.numpy as jnp
    from repro.core import blocks, distributed, hdb
    from repro.data import synthetic
    from repro.launch import block
    args = dict(zip(LAUNCH_ARGV[::2], LAUNCH_ARGV[1::2]))
    cfg = hdb.HDBConfig(max_block_size=int(args["--max-block-size"]))
    corpus = synthetic.generate(synthetic.SyntheticSpec(
        num_entities=int(args["--entities"]), seed=3))
    keys, valid = blocks.build_keys(corpus.columns, corpus.blocking)
    if n_dev > 1:
        pad = (-valid.shape[0]) % n_dev
        keys = jnp.concatenate([keys, jnp.full((pad,) + keys.shape[1:], 0xFFFFFFFF,
                                               jnp.uint32)])
        valid = jnp.concatenate([valid, jnp.zeros((pad, valid.shape[1]), bool)])
        res = distributed.distributed_hashed_dynamic_blocking(
            keys, valid, cfg, jax.make_mesh((n_dev,), ("data",)), ("data",))
    else:
        res = hdb.hashed_dynamic_blocking(keys, valid, cfg)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        block.main(LAUNCH_ARGV)
    return {**blocking_out(res), "printed": printed.getvalue()}


# one JAX run a shard count (the result depends on the count, not the
# mesh's shape; the reference's own tests hold the routed dedupe equal on
# every mesh), two processes that run side by side
REFS = {"hdb8": lambda: ref_hdb("flat"), "hdb4": lambda: ref_hdb("flat4"),
        "shard": ref_shard,
        "launch2": lambda: ref_launch(2), "launch1": lambda: ref_launch(1)}


def reference_process(job, out, n_dev=8):
    """Start the JAX reference for ``job`` in a subprocess on ``n_dev``
    emulated host devices; ``wait_reference`` reads its result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={n_dev}",
               PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"),
                                           os.environ.get("PYTHONPATH", "")]))
    return subprocess.Popen([sys.executable, os.path.abspath(__file__), "ref", job,
                             str(out)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def wait_reference(proc, out, timeout=600):
    log, _ = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"reference run failed ({proc.returncode}):\n{log[-4000:]}")
    with open(out, "rb") as f:
        return pickle.load(f)


if __name__ == "__main__":
    assert sys.argv[1] == "ref", sys.argv
    sys.path.insert(0, os.path.join(ROOT, "src"))
    result = REFS[sys.argv[2]]()
    with open(sys.argv[3], "wb") as f:
        pickle.dump(result, f)
