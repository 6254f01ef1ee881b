"""Helpers of the port's mesh tests (``tests/test_torch_distributed.py``,
``test_torch_sharded_mesh.py``, ``test_torch_launch.py``,
``test_torch_training.py``, ``test_torch_mesh_models.py``).

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
``tests/_dist_worker.py`` and ``tests/_shard_worker.py``; the mesh
models' (``job_mesh_models``, ``ref_mesh_models``) run on the reference's
``tests/_moe_worker.py`` mesh, (2, 2, 2) ``("pod", "data", "model")``,
under ``production_rules``, from inputs that ``mesh_model_inputs`` draws
with the JAX package and pickles beside the results.
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


# compressed_psum_grads over a data-parallel group: each rank's gradient
# and error-feedback leaves (float32, per-row scales over the last axis)
COMPRESS_SHAPES = {"w": (6, 16), "b": (16,), "t": (2, 3, 8)}


def compress_inputs(rank):
    """Rank ``rank``'s (grads, error_fb) as numpy float32 trees."""
    rng = np.random.default_rng(100 + rank)
    grads = {k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 1)).astype(np.float32)
             for k, s in COMPRESS_SHAPES.items()}
    efb = {k: (rng.standard_normal(s) * 1e-3).astype(np.float32)
           for k, s in COMPRESS_SHAPES.items()}
    return grads, efb


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


def job_launch_ckpt(world):
    """The launcher with --ckpt-dir, each save recorded; then each kept
    checkpoint restored and held to the rank-local state of a direct run
    that hands every iteration's state to its callback."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.core import blocks, distributed, hdb
    from repro_torch.data import synthetic
    from repro_torch.launch import block
    from repro_torch.training import checkpoint
    ckpt_dir = os.path.join(os.environ["REPRO_TEST_TMP"], "ckpt")
    saved = []
    original = checkpoint.save

    def save(directory, step, tree, **kw):
        saved.append((directory, step))
        return original(directory, step, tree, **kw)

    checkpoint.save = save
    try:
        res = block.main(LAUNCH_ARGV + ["--device", "cpu", "--ckpt-dir", ckpt_dir])
    finally:
        checkpoint.save = original
    args = dict(zip(LAUNCH_ARGV[::2], LAUNCH_ARGV[1::2]))
    corpus = synthetic.generate(synthetic.SyntheticSpec(
        num_entities=int(args["--entities"]), seed=3), device="cpu")
    keys, valid = blocks.build_keys(corpus.columns, corpus.blocking)
    keys, valid = distributed.pad_rows(keys, valid, world)
    states = {}
    mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("data",))
    distributed.distributed_hashed_dynamic_blocking(
        keys, valid, hdb.HDBConfig(max_block_size=int(args["--max-block-size"])),
        mesh, ("data",), device="cpu",
        checkpoint_cb=lambda it, st: states.__setitem__(
            it, {k: v.clone() for k, v in st.items()}))
    rank_dir = os.path.join(ckpt_dir, f"rank_{dist.get_rank()}")
    kept = sorted(int(d[len("step_"):]) for d in os.listdir(rank_dir)
                  if d.startswith("step_"))
    restored_equal = {}
    for it in kept:
        template = {k: torch.zeros_like(v) for k, v in states[it].items()}
        got = checkpoint.restore(rank_dir, template, step=it)
        restored_equal[it] = all(torch.equal(got[k], states[it][k]) for k in got)
    return {"saved": saved, "rank_dir": rank_dir, "n_iterations": len(res.stats),
            "latest": checkpoint.latest_step(rank_dir), "kept": kept,
            "restored_equal": restored_equal}


def job_compress(world):
    """compressed_psum_grads over a mesh dim's process group."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.training.compression import compressed_psum_grads
    grads, efb = compress_inputs(dist.get_rank())
    mesh = DeviceMesh("cpu", torch.arange(world), mesh_dim_names=("data",))
    deq, new_efb = compressed_psum_grads(
        {k: torch.from_numpy(v) for k, v in grads.items()},
        {k: torch.from_numpy(v) for k, v in efb.items()}, group=mesh.get_group("data"))
    return ({k: v.numpy() for k, v in deq.items()},
            {k: v.numpy() for k, v in new_efb.items()})


# the mesh models: MoE dispatches, losses and train steps, the launcher
MOE_CAPACITY_FACTORS = (8.0, 0.5)
MOE_IMPLS = ("psum", "a2a")
# every family: the dense and MoE decoders, MLA with MTP (deepseek), the
# Mamba hybrid (jamba), RWKV-6 and the encoder-decoder (whisper)
MESH_ARCHS = ("tinyllama-1.1b", "olmoe-1b-7b", "deepseek-v3-671b",
              "jamba-1.5-large-398b", "rwkv6-1.6b", "whisper-medium")
MESH_BATCH, MESH_SEQ, MESH_STEPS, MESH_QK_SCALE = 8, 16, 2, 0.25
# the leaves scaled by MESH_QK_SCALE (attention's and MLA's query and key
# projections)
MESH_QK_LEAVES = ("wq", "wk", "w_uq", "w_ukv")
# jamba cut to its reduced config's first 4 layers, which hold every layer
# kind (Mamba+MoE, Mamba+MLP, Mamba+MoE, attention+MLP)
MESH_CUTS = {"jamba-1.5-large-398b": dict(num_layers=4)}
# the families the launcher trains on the mesh (whisper: training fault 5)
MESH_LAUNCH_FAMILIES = ("deepseek-v3-671b", "jamba-1.5-large-398b", "rwkv6-1.6b")
MESH_FAMILY_ARGV = ["--reduced", "--steps", "2", "--ckpt-every", "1", "--batch", "8",
                    "--seq", "32", "--entities", "300"]
# rows that do not divide over the (2, 2, 2) mesh's 4 data ranks: the
# batch is replicated (the reference's rule); the MoE block on the first
# MESH_SMALL_ROWS rows of its x, and REPLICATED_ARCH's loss and one train
# step on a batch of MESH_SMALL_ROWS
MESH_SMALL_ROWS = 2
REPLICATED_ARCH = "olmoe-1b-7b"
MESH_OPT = dict(lr=1e-3, warmup_steps=0, total_steps=100)
# the XLA options of the mesh models' JAX programs (the inputs' draw and
# the reference's processes): the reduced models run in milliseconds and
# their compiles take the time, which LLVM's cheapest settings halve
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}
MESH_LAUNCH_ARGV = ["--arch", "olmoe-1b-7b", "--reduced", "--steps", "2",
                    "--ckpt-every", "1", "--batch", "8", "--seq", "32",
                    "--entities", "300"]


def mesh_config(reduced_config, arch):
    """``arch``'s reduced config (of either package's ``reduced_config``)
    with its ``MESH_CUTS``."""
    import dataclasses
    return dataclasses.replace(reduced_config(arch), **MESH_CUTS.get(arch, {}))


def mesh_model_inputs(path):
    """Draw the mesh models' inputs with the JAX package and pickle them to
    ``path``: the reduced olmoe's ``moe_init(PRNGKey(0))`` block and x of
    ``normal(PRNGKey(1), (4, 8, d))`` (the reference's
    ``tests/_moe_worker.py``); each of ``MESH_ARCHS``'s
    ``init_train_state(PRNGKey(0))`` with ``wq``/``wk`` scaled by
    ``MESH_QK_SCALE`` and ``MESH_STEPS`` train batches; the launcher's
    initial parameters (its arch's, scaled alike, and each of
    ``MESH_LAUNCH_FAMILIES``'); one batch of ``MESH_SMALL_ROWS`` rows for
    ``REPLICATED_ARCH``."""
    import jax
    import jax.numpy as jnp
    from repro.configs import reduced_config
    from repro.launch import specs
    from repro.models import moe
    from repro.models.model import build_model
    from repro.training import optimizer, train_loop
    cfg = reduced_config("olmoe-1b-7b")
    out = {"moe_params": jax.tree.map(np.asarray, moe.moe_init(jax.random.PRNGKey(0),
                                                               cfg)["moe"]),
           "moe_x": np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                                 (4, 8, cfg.d_model), jnp.float32)),
           "models": {}}
    tcfg = train_loop.TrainConfig(opt=optimizer.OptimizerConfig(**MESH_OPT))
    for arch in MESH_ARCHS:
        c = mesh_config(reduced_config, arch)
        # one compile of the whole init, not one a parameter shape
        key = jax.random.PRNGKey(0)
        state = jax.jit(lambda k: train_loop.init_train_state(build_model(c), k, tcfg)).lower(
            key).compile(compiler_options=FAST_COMPILE)(key)
        state["params"] = jax.tree_util.tree_map_with_path(
            lambda p, x: x * MESH_QK_SCALE if p[-1].key in MESH_QK_LEAVES else x,
            state["params"])
        out["models"][arch] = {
            "state": jax.tree.map(np.asarray, state),
            "batches": [specs.train_batch(c, MESH_SEQ, MESH_BATCH, concrete=True,
                                          rng=np.random.default_rng(7 + i))
                        for i in range(MESH_STEPS)]}
    out["launch_params"] = out["models"][MESH_LAUNCH_ARGV[1]]["state"]["params"]
    out["family_params"] = {a: out["models"][a]["state"]["params"]
                            for a in MESH_LAUNCH_FAMILIES}
    out["replicated_batches"] = [specs.train_batch(
        reduced_config(REPLICATED_ARCH), MESH_SEQ, MESH_SMALL_ROWS, concrete=True,
        rng=np.random.default_rng(11))]
    with open(path, "wb") as f:
        pickle.dump(out, f)


def _mesh_inputs():
    with open(os.path.join(os.environ["REPRO_TEST_TMP"], "mesh_inputs.pkl"), "rb") as f:
        return pickle.load(f)


def _port_moe(inputs, mesh, rules):
    """The reduced olmoe's MoE block on this rank's rows, each dispatch and
    capacity factor: (out rows, aux, dropped); under the key
    ``(MESH_SMALL_ROWS, cf, impl)`` the same on that many rows, which every
    rank holds whole."""
    import dataclasses
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.distributed import spmd
    from repro_torch.distributed.sharding import shard_params, use_rules
    from repro_torch.models.moe import MoE
    out = {}
    whole = torch.from_numpy(inputs["moe_x"])
    for cf in MOE_CAPACITY_FACTORS:
        for impl in MOE_IMPLS:
            cfg = dataclasses.replace(reduced_config("olmoe-1b-7b"), capacity_factor=cf,
                                      moe_impl=impl)
            holder = torch.nn.Module()
            holder.moe = MoE(cfg, "cpu", None).requires_grad_(False)
            holder.moe.load_state_dict({k: torch.from_numpy(np.array(v))
                                        for k, v in inputs["moe_params"].items()})
            shard_params(holder, rules)
            for key, x in (((cf, impl), whole),
                           ((MESH_SMALL_ROWS, cf, impl), whole[:MESH_SMALL_ROWS])):
                with use_rules(rules), torch.no_grad():
                    y, aux, dropped = holder.moe(spmd.batch_rows(x))
                out[key] = (y.numpy(), float(aux), int(dropped))
    return out


def _port_train(arch, state, batches, rules):
    """``arch``'s loss on ``batches[0]``, then one train step a batch, from
    the reference's initial ``state``, on this rank; and a digest of each
    parameter the rules replicate, after the steps."""
    import hashlib
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.distributed.sharding import use_rules
    from repro_torch.models import convert
    from repro_torch.models.model import build_model, shard_model
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import (TrainConfig, decayed_names,
                                                 init_train_state, make_train_step)
    cfg = mesh_config(reduced_config, arch)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(convert.params_from_jax(cfg, state["params"]))
    meshless_decayed = decayed_names(model)
    specs = shard_model(model, rules)
    tcfg = TrainConfig(opt=OptimizerConfig(**MESH_OPT))
    state = init_train_state(model, tcfg)
    step = make_train_step(model, tcfg)
    batches = [{k: torch.from_numpy(np.array(v)) for k, v in b.items()} for b in batches]
    with use_rules(rules):
        with torch.no_grad():
            loss, metrics = model.loss(batches[0])
        mets = []
        for b in batches:
            state, met = step(state, b)
            mets.append({k: float(v) for k, v in met.items()})
    replicated = {k: hashlib.sha256(p.detach().numpy().tobytes()).hexdigest()
                  for k, p in model.named_parameters()
                  if all(ax is None for ax in specs[k])}
    return {"loss": float(loss), "metrics": {k: float(v) for k, v in metrics.items()},
            "steps": mets, "replicated": replicated,
            "decayed": (sorted(meshless_decayed), sorted(decayed_names(model)))}


def _port_models(inputs, rules):
    """Each arch's loss on its first batch, then MESH_STEPS train steps'
    metrics; ``REPLICATED_ARCH`` on its batch of ``MESH_SMALL_ROWS``."""
    out = {arch: _port_train(arch, inputs["models"][arch]["state"],
                             inputs["models"][arch]["batches"], rules)
           for arch in MESH_ARCHS}
    out["replicated"] = _port_train(REPLICATED_ARCH,
                                    inputs["models"][REPLICATED_ARCH]["state"],
                                    inputs["replicated_batches"], rules)
    return out


def _port_launch(inputs, mesh):
    """The launcher on ``mesh`` from the reference's initial parameters:
    its losses and its step-1 checkpoint (whole, as numpy); then a copy of
    its checkpoints cut back to step 1 and resumed."""
    from repro_torch.configs import reduced_config
    from repro_torch.launch import train
    from repro_torch.models import convert
    from repro_torch.models.model import build_model
    from repro_torch.training import checkpoint
    from repro_torch.training.optimizer import OptimizerConfig
    from repro_torch.training.train_loop import TrainConfig, init_train_state
    tmp = os.environ["REPRO_TEST_TMP"]
    cfg = reduced_config(MESH_LAUNCH_ARGV[1])
    sd = convert.params_from_jax(cfg, inputs["launch_params"])

    def from_reference(c, device=None, generator=None):
        m = build_model(c, device=device)
        m.load_state_dict(sd)
        return m

    argv = MESH_LAUNCH_ARGV + ["--device", "cpu"]
    original = train.build_model
    train.build_model = from_reference
    try:
        full, resumed = _resumed_from_step_1(
            lambda d: train.main(argv + ["--ckpt-dir", d], mesh=mesh),
            os.path.join(tmp, "launch_a"), os.path.join(tmp, "launch_b"))
    finally:
        train.build_model = original
    same = _same_params(full, resumed)
    template = init_train_state(build_model(cfg, device="cpu"),
                                TrainConfig(opt=OptimizerConfig()))
    checkpoint.restore(os.path.join(tmp, "launch_a"), template, step=1)
    return {"losses": full.losses, "resumed_losses": resumed.losses,
            "resumed_start": resumed.start, "resumed_equal": same,
            "step1": {"params": {k: v.detach().numpy()
                                 for k, v in template["params"].items()},
                      "mu": {k: v.numpy() for k, v in template["opt"]["mu"].items()}}}


def _resumed_from_step_1(main, first, second):
    """``main(first)`` for 2 steps with a checkpoint a step, then a copy
    of its checkpoints in ``second`` cut back to step 1 and resumed by
    ``main(second)``: (the full run, the resumed run)."""
    import shutil
    import torch.distributed as dist
    full = main(first)
    if dist.get_rank() == 0:
        shutil.copytree(first, second)
        shutil.rmtree(os.path.join(second, "step_0000000002"))
        with open(os.path.join(second, "LATEST"), "w") as f:
            f.write("1")
    dist.barrier()
    return full, main(second)


def _same_params(full, resumed):
    """Whether two runs end with bit-equal blocks on this rank."""
    import torch
    return all(torch.equal(resumed.state["params"][k], p)
               for k, p in full.state["params"].items())


def _port_launch_family(inputs, mesh, arch):
    """The launcher on ``mesh`` for ``arch`` (its ``MESH_CUTS`` config)
    from the reference's scaled initial parameters: its losses, and its
    run resumed from the step-1 checkpoint."""
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.launch import train
    from repro_torch.models import convert
    from repro_torch.models.model import build_model
    cfg = mesh_config(reduced_config, arch)
    sd = convert.params_from_jax(cfg, inputs["family_params"][arch])

    def from_reference(c, device=None, generator=None):
        m = build_model(c, device=device)
        m.load_state_dict(sd)
        return m

    argv = ["--arch", arch] + MESH_FAMILY_ARGV + ["--device", "cpu"]
    tmp = os.environ["REPRO_TEST_TMP"]
    originals = train.build_model, train.reduced_config
    train.build_model = from_reference
    train.reduced_config = lambda a: mesh_config(reduced_config, a)
    try:
        run, resumed = _resumed_from_step_1(
            lambda d: train.main(argv + ["--ckpt-dir", d], mesh=mesh),
            os.path.join(tmp, f"family_{arch}_a"), os.path.join(tmp, f"family_{arch}_b"))
    finally:
        train.build_model, train.reduced_config = originals
    return {"losses": run.losses, "finite": bool(all(
        torch.isfinite(p).all() for p in run.state["params"].values())),
            "resumed_start": resumed.start, "resumed_losses": resumed.losses,
            "resumed_equal": _same_params(run, resumed)}


# spmd's sums on the "pod" mesh ((2, 4) ("pod", "data")): a 16-bit sum
# over one 2-rank dim ("pod") goes through gloo in its own type, every
# other sum in float32; the reduce-scatter a slab at a time. Each rank's
# bfloat16 input holds multiples of 1/256 below 1 in magnitude, whose
# float32 sums over up to 8 ranks are exact in any order, so every result
# has one right value: the float32 sum cast to bfloat16. COLLECTIVE_SLAB
# makes the reduce-scatter over "pod" take 3 of its 4 rows a slab (an
# uneven last slab) and over "data" one of its 2
COLLECTIVE_SHAPE = (8, 5, 3)
COLLECTIVE_SLAB = 90
COLLECTIVE_CASES = {"all_reduce pod": ("all_reduce", ("pod",)),
                    "all_reduce data": ("all_reduce", ("data",)),
                    "all_reduce pod data": ("all_reduce", ("pod", "data")),
                    "reduce_scatter pod": ("reduce_scatter", ("pod",)),
                    "reduce_scatter data": ("reduce_scatter", ("data",)),
                    "reduce_scatter pod data": ("reduce_scatter", ("pod", "data"))}


def collective_input(rank):
    """Rank ``rank``'s input to the collectives, as float32 numpy."""
    rng = np.random.default_rng(100 + rank)
    return (rng.integers(-255, 256, COLLECTIVE_SHAPE) / 256).astype(np.float32)


def _port_collectives():
    """{case: (this rank's bfloat16 result as float32, the reduce-scatter's
    result with every row in one slab)}."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import spmd
    mesh, _ = _mesh("pod")
    x = torch.from_numpy(collective_input(dist.get_rank())).to(torch.bfloat16)
    out = {}
    for case, (op, axes) in COLLECTIVE_CASES.items():
        if op == "all_reduce":
            out[case] = (spmd._all_reduce(x, mesh, axes).float().numpy(), None)
            continue
        slab = spmd.SCATTER_SLAB
        spmd.SCATTER_SLAB = COLLECTIVE_SLAB
        try:
            y = spmd._reduce_scatter(x, 0, mesh, axes)
        finally:
            spmd.SCATTER_SLAB = slab
        out[case] = (y.float().numpy(), spmd._reduce_scatter(x, 0, mesh, axes).float().numpy())
    return out


def job_mesh_models(world):
    """The mesh models on the (2, 2, 2) mesh of ``world`` = 8 ranks."""
    import torch
    from repro_torch.core.routing import linear_shard_index
    from repro_torch.distributed.sharding import production_rules
    mesh, _ = _mesh("3axis")
    rules = production_rules(mesh)
    inputs = _mesh_inputs()
    return {"rows": linear_shard_index(mesh, ("pod", "data")),
            "moe": _port_moe(inputs, mesh, rules),
            "models": _port_models(inputs, rules),
            "launch": _port_launch(inputs, mesh),
            "family_launch": {a: _port_launch_family(inputs, mesh, a)
                              for a in MESH_LAUNCH_FAMILIES},
            "collectives": _port_collectives()}


JOBS = {"hdb": job_hdb, "shard": job_shard, "launch": job_launch,
        "launch_ckpt": job_launch_ckpt, "compress": job_compress,
        "mesh_models": job_mesh_models}


def _rank_main(rank, world, init, tmp, job):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    # torch 2.13 renames all_gather_into_tensor; the port keeps the name
    # the chip's torch 2.11 has
    warnings.filterwarnings("ignore", category=FutureWarning)
    os.environ["REPRO_TEST_TMP"] = tmp
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


def ref_compress(n_dev=2):
    """The reference's compressed_psum_grads under shard_map over ``n_dev``
    devices, each device holding one rank's leaves: rank r's (deq, efb)."""
    import jax
    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P
    from repro.training.compression import compressed_psum_grads
    inputs = [compress_inputs(r) for r in range(n_dev)]
    grads = {k: np.stack([g[k] for g, _ in inputs]) for k in COMPRESS_SHAPES}
    efb = {k: np.stack([e[k] for _, e in inputs]) for k in COMPRESS_SHAPES}
    mesh = jax.make_mesh((n_dev,), ("data",))
    f = shard_map(lambda g, e: compressed_psum_grads(g, e, axis="data"), mesh=mesh,
                  in_specs=(P("data"), P("data")), out_specs=(P("data"), P("data")),
                  check_rep=False)
    deq, new_efb = jax.tree.map(np.asarray, f(grads, efb))
    return [({k: v[r] for k, v in deq.items()}, {k: v[r] for k, v in new_efb.items()})
            for r in range(n_dev)]


def _auto_mesh(name):
    """``_jax_mesh`` with Auto axes, which the reference's ``lshard``
    needs (``jax.make_mesh`` makes Explicit ones under jax 0.9)."""
    import jax
    from jax.sharding import AxisType, Mesh
    shape, axes = MESHES[name]
    devs = np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape)
    return Mesh(devs, axes, axis_types=(AxisType.Auto,) * len(axes))


# the reference's half of the mesh models in two processes that run side
# by side (its compiles take most of the test's time): the MoE blocks,
# the olmoe launcher and its checkpoint in the first; each arch's loss
# and train steps and each family's launcher where they balance the two
MESH_REF_PARTS = {
    "mesh_models": dict(base=True, archs=("tinyllama-1.1b", "olmoe-1b-7b",
                                          "deepseek-v3-671b"),
                        launches=("jamba-1.5-large-398b",)),
    "mesh_families": dict(base=False, archs=("jamba-1.5-large-398b", "rwkv6-1.6b",
                                             "whisper-medium"),
                          launches=("deepseek-v3-671b", "rwkv6-1.6b")),
}


def ref_mesh_models(part="mesh_models"):
    """The reference's counterpart of ``job_mesh_models`` on the Auto
    (2, 2, 2) mesh under ``production_rules``: the share of it that
    ``MESH_REF_PARTS[part]`` names. An arch's loss and metrics on its
    first batch are its first train step's (the same function of the
    same parameters), which saves a compile."""
    which = MESH_REF_PARTS[part]
    import contextlib
    import dataclasses
    import io
    import tempfile
    import jax
    from repro.configs import reduced_config
    from repro.distributed.sharding import param_sharding, production_rules, use_rules
    from repro.launch import train
    from repro.models import moe
    from repro.models.model import build_model
    from repro.training import checkpoint, optimizer, train_loop
    from repro_torch.configs import reduced_config as port_config
    from repro_torch.models import convert
    mesh = _auto_mesh("3axis")
    rules = production_rules(mesh)
    inputs = _mesh_inputs()
    out = {"moe": {}, "models": {}, "family_launch": {}}
    for cf in MOE_CAPACITY_FACTORS if which["base"] else ():
        for impl in MOE_IMPLS:
            cfg = dataclasses.replace(reduced_config("olmoe-1b-7b"), capacity_factor=cf,
                                      moe_impl=impl)
            apply = jax.jit(lambda p, x: moe.moe_apply(p, x, cfg))
            x = inputs["moe_x"]
            for key, rows in (((cf, impl), x), ((MESH_SMALL_ROWS, cf, impl),
                                                x[:MESH_SMALL_ROWS])):
                with use_rules(rules):
                    y, aux, dropped = apply(inputs["moe_params"], rows)
                out["moe"][key] = (np.asarray(y), float(aux), int(dropped))
    tcfg = train_loop.TrainConfig(opt=optimizer.OptimizerConfig(**MESH_OPT))

    def run(arch, state, batches):
        model = build_model(mesh_config(reduced_config, arch))
        state = jax.tree.map(jax.numpy.asarray, state)
        with use_rules(rules):
            shard = param_sharding(state["params"], rules)
            for path in (("params",), ("opt", "mu"), ("opt", "nu")):
                tree = state
                for key in path[:-1]:
                    tree = tree[key]
                tree[path[-1]] = jax.device_put(tree[path[-1]], shard)
            step = jax.jit(train_loop.make_train_step(model, tcfg))
            mets = []
            for b in batches:
                state, met = step(state, b)
                mets.append({k: float(v) for k, v in met.items()})
        return {"loss": mets[0]["loss"],
                "metrics": {k: v for k, v in mets[0].items()
                            if k not in ("loss", "grad_norm", "lr")},
                "steps": mets}

    for arch in which["archs"]:
        out["models"][arch] = run(arch, inputs["models"][arch]["state"],
                                  inputs["models"][arch]["batches"])
    if not which["base"]:
        return _ref_family_launches(which["launches"], inputs, mesh, out)
    out["models"]["replicated"] = run(REPLICATED_ARCH,
                                      inputs["models"][REPLICATED_ARCH]["state"],
                                      inputs["replicated_batches"])
    # the launcher, on this mesh in place of the production one, from the
    # scaled initial parameters
    _patch_launcher(inputs, mesh)
    cfg = reduced_config(MESH_LAUNCH_ARGV[1])
    with tempfile.TemporaryDirectory() as d:
        printed = io.StringIO()
        with contextlib.redirect_stdout(printed):
            train.main(MESH_LAUNCH_ARGV + ["--mesh", "single", "--ckpt-dir", d])
        template = jax.eval_shape(lambda: train_loop.init_train_state(
            build_model(cfg), jax.random.PRNGKey(0), train_loop.TrainConfig()))
        restored = checkpoint.restore(d, template, step=1)
        pcfg = port_config(MESH_LAUNCH_ARGV[1])
        out["launch"] = {"printed": printed.getvalue(), "step1": {
            "params": {k: v.numpy() for k, v in convert.params_from_jax(
                pcfg, jax.tree.map(np.asarray, restored["params"])).items()},
            "mu": {k: v.numpy() for k, v in convert.params_from_jax(
                pcfg, jax.tree.map(np.asarray, restored["opt"]["mu"])).items()}}}
    return _ref_family_launches(which["launches"], inputs, mesh, out)


def _patch_launcher(inputs, mesh):
    """The reference launcher on ``mesh`` in place of the production one,
    from the scaled initial parameters of its arch, each config cut as
    ``MESH_CUTS``."""
    import jax
    from repro.configs import reduced_config
    from repro.launch import train
    from repro.training import optimizer
    if getattr(train, "_mesh_test_patched", False):
        return
    train._mesh_test_patched = True
    train.make_production_mesh = lambda multi_pod=False: mesh
    launch_params = {reduced_config(MESH_LAUNCH_ARGV[1]).name: inputs["launch_params"],
                     **{reduced_config(a).name: p
                        for a, p in inputs["family_params"].items()}}

    def init_train_state(m, key, t):
        """``init_train_state``'s state around the given parameters (its
        own draw of them left out: eager, a compile a shape)."""
        assert not t.compress_grads
        params = jax.tree.map(jax.numpy.asarray, launch_params[m.cfg.name])
        return {"params": params, "opt": optimizer.init_opt_state(t.opt, params),
                "step": jax.numpy.zeros((), jax.numpy.int32)}

    train.init_train_state = init_train_state
    train.reduced_config = lambda a: mesh_config(reduced_config, a)


def _ref_family_launches(archs, inputs, mesh, out):
    """What the reference launcher prints for each of ``archs`` on
    ``mesh``, under ``out["family_launch"]``; returns ``out``."""
    import contextlib
    import io
    import tempfile
    from repro.launch import train
    _patch_launcher(inputs, mesh)
    for arch in archs:
        with tempfile.TemporaryDirectory() as d:
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                train.main(["--arch", arch] + MESH_FAMILY_ARGV
                           + ["--mesh", "single", "--ckpt-dir", d])
        out["family_launch"][arch] = printed.getvalue()
    return out


# one JAX run a shard count (the result depends on the count, not the
# mesh's shape; the reference's own tests hold the routed dedupe equal on
# every mesh), two processes that run side by side
REFS = {"hdb8": lambda: ref_hdb("flat"), "hdb4": lambda: ref_hdb("flat4"),
        "shard": ref_shard,
        "launch2": lambda: ref_launch(2), "launch1": lambda: ref_launch(1),
        "compress": ref_compress,
        **{part: (lambda part=part: ref_mesh_models(part)) for part in MESH_REF_PARTS}}


def reference_process(job, out, n_dev=8, fast_compile=False):
    """Start the JAX reference for ``job`` in a subprocess on ``n_dev``
    emulated host devices, its XLA options ``FAST_COMPILE`` with
    ``fast_compile``; ``wait_reference`` reads its result."""
    flags = f"--xla_force_host_platform_device_count={n_dev}"
    if fast_compile:
        flags += "".join(f" --{k}={str(v).lower()}" for k, v in FAST_COMPILE.items())
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS=flags,
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
