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
configs). ``--mesh single|multi`` needs the production mesh and the
logical sharding rules, which wait for ROADMAP A10b. ``main`` returns a
``TrainRun`` with the per-step losses and times.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Dict, List, Tuple

import torch

from ..configs import get_config, reduced_config
from ..core import hdb
from ..data import loader, pipeline, synthetic
from ..device import resolve_device
from ..models.model import Model, build_model
from ..training import checkpoint
from ..training.optimizer import OptimizerConfig
from ..training.stragglers import PreemptionHandler, StragglerMonitor
from ..training.train_loop import TrainConfig, init_train_state, make_train_step


@dataclasses.dataclass
class TrainRun:
    """What a run did: its model, train config and state (trained in
    place), the loader, the step it started from, each step's loss and
    milliseconds (CUDA events on the card, the host clock on the CPU) and
    each checkpoint save as (step, seconds, bytes of arrays.npz)."""

    model: Model
    tcfg: TrainConfig
    state: Dict
    loader: loader.TokenStreamLoader
    start: int
    losses: List[float]
    step_ms: List[float]
    saves: List[Tuple[int, float, int]]


def main(argv=None) -> TrainRun:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--mesh", default="none", choices=["none", "single", "multi"],
                    help="the production mesh (not ported: ROADMAP A10b)")
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_launch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--dedup", action="store_true")
    ap.add_argument("--entities", type=int, default=3000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh != "none":
        raise NotImplementedError(
            "--mesh needs the production mesh and the logical sharding rules "
            "(distributed/sharding.py production_rules, param_sharding, lshard), "
            "which wait for ROADMAP A10b")

    dev = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg, device=dev)
    tcfg = TrainConfig(
        opt=OptimizerConfig(lr=3e-4, warmup_steps=min(20, args.steps // 4),
                            total_steps=args.steps),
        grad_accum=args.grad_accum,
        compress_grads=args.compress_grads)

    corpus = synthetic.generate(synthetic.SyntheticSpec(
        num_entities=args.entities, dup_rate=0.5, seed=13), device=dev)
    survivors = None
    if args.dedup:
        rep = pipeline.dedup_corpus(corpus, hdb.HDBConfig(max_block_size=100),
                                    device=dev)
        survivors = rep.survivors
        print(f"[train] dedup {corpus.num_records} -> {rep.num_survivors}")
    ld = loader.TokenStreamLoader(
        corpus, loader.LoaderConfig(batch_size=args.batch, seq_len=args.seq,
                                    vocab_size=cfg.vocab_size),
        survivors=survivors, device=dev)

    state = init_train_state(model, tcfg)
    start = checkpoint.latest_step(args.ckpt_dir) or 0
    if start:
        checkpoint.restore(args.ckpt_dir, state)
        print(f"[train] resumed from step {start}")
    step_fn = make_train_step(model, tcfg)
    monitor = StragglerMonitor()
    preempt = PreemptionHandler().install()
    on_card = dev.type == "cuda"
    losses, marks, saves = [], [], []
    t0 = time.time()
    try:
        for step in range(start, args.steps):
            monitor.start_step()
            inputs, targets = ld.batch(step)
            begin = _mark(on_card)
            state, metrics = step_fn(state, {"tokens": inputs, "targets": targets})
            marks.append((begin, _mark(on_card)))
            losses.append(metrics["loss"])
            monitor.end_step(step)
            if step % 10 == 0:
                print(f"[train] step {step} loss {float(metrics['loss']):.4f}")  # repro: noqa[R001] the loss printed every 10 steps
            if (step + 1) % args.ckpt_every == 0 or preempt.requested:
                t_save = time.perf_counter()
                path = checkpoint.save(args.ckpt_dir, step + 1, state)
                saves.append((step + 1, time.perf_counter() - t_save,  # repro: noqa[R004] save copies every leaf to the host first
                              os.path.getsize(os.path.join(path, "arrays.npz"))))
                if preempt.requested:
                    print("[train] preempted; checkpoint written")
                    break
    finally:
        preempt.uninstall()
    losses = [float(x) for x in losses]  # repro: noqa[R001] the losses to floats once, after the loop
    if on_card:
        torch.cuda.synchronize(dev)  # repro: noqa[R001] the step events are read after the loop
        step_ms = [a.elapsed_time(b) for a, b in marks]
    else:
        step_ms = [(b - a) * 1e3 for a, b in marks]
    final = f" final loss {losses[-1]:.4f}" if losses else ""
    print(f"[train] done in {time.time() - t0:.1f}s{final}")
    return TrainRun(model, tcfg, state, ld, start, losses, step_ms, saves)


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
