"""Training launcher: the HDB-deduplicated loader feeding the train step.

Port of the JAX package's ``launch/train.py``. Wires: the corpus,
deduplicated by ``dedup_corpus`` (``--dedup``: every blocking kernel
runs), -> the deterministic token loader -> the train step (remat,
gradient accumulation, int8 compression) -> checkpoints, resume from
``LATEST``, the straggler monitor and the preemption handler. On the
card by default::

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --steps 12 --dedup --ckpt-dir D

and on the CPU with ``--device cpu`` (``--reduced`` for the tiny
configs). ``main`` returns a ``TrainRun`` with the per-step losses and
times.

``--mesh single|multi`` trains on the production mesh (``launch/mesh``:
256 or 512 ranks, one process a rank started by ``torchrun``; the process
group comes from its environment, NCCL on the card, gloo with
``--device cpu``) under ``production_rules``: every rank builds the same
weights, keeps its block of each parameter and moment (FSDP over "data",
heads, ffn, experts and vocab over "model"), and runs the step on its
rows of each global batch. ``main(argv, mesh=...)`` does the same on a
``DeviceMesh`` the caller built (the tests' and ``chip_smoke.py``'s small
meshes of one process group). Checkpoints hold the whole state either
way; rank 0 prints.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Dict, List, Tuple

import torch
import torch.distributed as dist

from ..configs import get_config, reduced_config
from ..core import hdb
from ..data import loader, pipeline, synthetic
from ..device import resolve_device
from ..distributed.sharding import production_rules, use_rules
from ..models.model import Model, build_model, shard_model
from ..training import checkpoint
from ..training.optimizer import OptimizerConfig
from ..training.stragglers import PreemptionHandler, StragglerMonitor
from ..training.train_loop import TrainConfig, init_train_state, make_train_step
from .mesh import make_production_mesh


# the launcher's corpus and batch defaults
ENTITIES, BATCH, SEQ = 3000, 8, 256


def make_loader(vocab_size: int, device, entities: int = ENTITIES, batch: int = BATCH,
                seq: int = SEQ, dedup: bool = True):
    """The launcher's loader: its synthetic corpus of ``entities``
    (``dup_rate`` 0.5, seed 13), with ``dedup`` deduplicated by
    ``dedup_corpus`` (every blocking kernel), packed into ``batch`` x
    ``seq`` batches over ``vocab_size``. Returns (loader, (records,
    survivors) or None)."""
    corpus = synthetic.generate(synthetic.SyntheticSpec(
        num_entities=entities, dup_rate=0.5, seed=13), device=device)
    survivors, counts = None, None
    if dedup:
        rep = pipeline.dedup_corpus(corpus, hdb.HDBConfig(max_block_size=100),
                                    device=device)
        survivors, counts = rep.survivors, (corpus.num_records, rep.num_survivors)
    ld = loader.TokenStreamLoader(
        corpus, loader.LoaderConfig(batch_size=batch, seq_len=seq, vocab_size=vocab_size),
        survivors=survivors, device=device)
    return ld, counts


@dataclasses.dataclass
class TrainRun:
    """What a run did: its model, train config and state (trained in
    place), the loader, the step it started from, each step's loss and
    milliseconds (CUDA events on the card, the host clock on the CPU),
    each checkpoint save as (step, seconds, bytes of arrays.npz) and each
    step's metrics as floats."""

    model: Model
    tcfg: TrainConfig
    state: Dict
    loader: loader.TokenStreamLoader
    start: int
    losses: List[float]
    step_ms: List[float]
    saves: List[Tuple[int, float, int]]
    metrics: List[Dict[str, float]]


def main(argv=None, mesh=None) -> TrainRun:
    """The launcher; with ``mesh`` (a ``DeviceMesh`` with the production
    dim names) it trains on that mesh whatever ``--mesh`` says."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=BATCH)
    ap.add_argument("--seq", type=int, default=SEQ)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--mesh", default="none", choices=["none", "single", "multi"],
                    help="the production mesh: 256 (single) or 512 (multi) ranks")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_launch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--dedup", action="store_true")
    ap.add_argument("--entities", type=int, default=ENTITIES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if mesh is None and args.mesh != "none":
        if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE", "1")) > 1:
            if dev.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
                dev = resolve_device(args.device)
            dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
        mesh = make_production_mesh(multi_pod=args.mesh == "multi", device_type=dev.type)
    rules = production_rules(mesh) if mesh is not None else None
    talk = rules is None or dist.get_rank() == 0
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, device=dev)
    if rules is not None:
        shard_model(model, rules)
    tcfg = TrainConfig(
        opt=OptimizerConfig(lr=3e-4, warmup_steps=min(20, args.steps // 4),
                            total_steps=args.steps),
        grad_accum=args.grad_accum,
        compress_grads=args.compress_grads)

    ld, counts = make_loader(cfg.vocab_size, dev, args.entities, args.batch, args.seq,
                             args.dedup)
    if counts and talk:
        print(f"[train] dedup {counts[0]} -> {counts[1]}")

    state = init_train_state(model, tcfg)
    start = checkpoint.latest_step(args.ckpt_dir) or 0
    if start:
        checkpoint.restore(args.ckpt_dir, state)
        if talk:
            print(f"[train] resumed from step {start}")
    step_fn = make_train_step(model, tcfg)
    monitor = StragglerMonitor()
    preempt = PreemptionHandler().install()
    on_card = dev.type == "cuda"
    mets, marks, saves = [], [], []
    t0 = time.time()
    try:
        with use_rules(rules):
            for step in range(start, args.steps):
                monitor.start_step()
                inputs, targets = ld.batch(step)
                begin = _mark(on_card)
                state, metrics = step_fn(state, {"tokens": inputs, "targets": targets})
                marks.append((begin, _mark(on_card)))
                mets.append(metrics)
                monitor.end_step(step)
                if step % 10 == 0 and talk:
                    print(f"[train] step {step} loss {float(metrics['loss']):.4f}")  # repro: noqa[R001] the loss printed every 10 steps
                if (step + 1) % args.ckpt_every == 0 or preempt.requested:
                    t_save = time.perf_counter()
                    path = checkpoint.save(args.ckpt_dir, step + 1, state)
                    saves.append((step + 1, time.perf_counter() - t_save,  # repro: noqa[R004] save copies every leaf to the host first
                                  os.path.getsize(os.path.join(path, "arrays.npz"))))
                    if preempt.requested:
                        if talk:
                            print("[train] preempted; checkpoint written")
                        break
    finally:
        preempt.uninstall()
    if mets:
        keys = list(mets[0])
        rows = torch.stack([torch.stack([m[k].to(torch.float64) for k in keys])
                            for m in mets]).tolist()  # repro: noqa[R001] the metrics to floats once, after the loop
        mets = [dict(zip(keys, row)) for row in rows]
    losses = [m["loss"] for m in mets]
    if on_card:
        torch.cuda.synchronize(dev)  # repro: noqa[R001] the step events are read after the loop
        step_ms = [a.elapsed_time(b) for a, b in marks]
    else:
        step_ms = [(b - a) * 1e3 for a, b in marks]
    final = f" final loss {losses[-1]:.4f}" if losses else ""
    if talk:
        print(f"[train] done in {time.time() - t0:.1f}s{final}")
    return TrainRun(model, tcfg, state, ld, start, losses, step_ms, saves, mets)


def _mark(on_card: bool):
    """A step boundary: a recorded CUDA event on the card, the host clock
    on the CPU (where every op is synchronous)."""
    if not on_card:
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


if __name__ == "__main__":
    main()
