"""Training runs shared by the card tests and ``chip_smoke.py`` phase 9b.

``train_steps`` runs the train step over given batches;
``scale_qk`` scales the attention's initial ``wq`` and ``wk`` (MLA's
``w_uq`` and ``w_ukv``, the MTP layer's included; the
reference's init makes the softmax sharp enough that float32 rounding,
amplified by AdamW's first update, parts two devices' runs after one
step; ``tests/test_torch_training.py`` measures it); ``resume_differs``
holds a run checkpointed halfway, restored into a fresh state and
continued, to the uninterrupted run. On the card that needs
deterministic kernels, chosen before any CUDA call (cuBLAS's workspace
setting, ``torch.use_deterministic_algorithms``), so

    python -m repro_torch.training.smoke --arch tinyllama-1.1b --layers 2

runs the resume on the card in a process of its own, TF32 off, and
prints one JSON line: the state's leaves that differ (none when
bit-identical); it exits 1 if any does.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..configs import get_config, reduced_config
from ..launch import specs
from ..models.config import ModelConfig
from ..models.model import Model, build_model
from . import checkpoint
from .optimizer import OptimizerConfig
from .train_loop import TrainConfig, init_train_state, make_train_step

TCFG = TrainConfig(opt=OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=100))


def batches(cfg: ModelConfig, n: int, batch: int, seq: int, device) -> List[Dict]:
    """``n`` train batches from seeded numpy draws (seeds 0..n-1)."""
    return [specs.train_batch(cfg, seq, batch, concrete=True,
                              rng=np.random.default_rng(i), device=device)
            for i in range(n)]


# the weights whose fan-in quirk sharpens the attention scores: the
# attention's query and key projections, MLA's query and key/value
# up-projections
QK_WEIGHTS = ("wq", "wk", "w_uq", "w_ukv")


@torch.no_grad()
def scale_qk(model: Model, factor: float) -> Model:
    for name, w in model.named_parameters():
        if name.endswith(tuple("attn." + n for n in QK_WEIGHTS)):
            w.mul_(factor)
    return model


def train_steps(model: Model, bs: List[Dict], tcfg: TrainConfig = TCFG
                ) -> Tuple[Dict, List[Dict[str, float]]]:
    """(state, each step's metrics as floats) after a step a batch."""
    state = init_train_state(model, tcfg)
    step = make_train_step(model, tcfg)
    out = []
    for b in bs:
        state, m = step(state, b)
        out.append({k: float(v) for k, v in m.items()})
    return state, out


def resume_differs(cfg: ModelConfig, device, bs: List[Dict], ckpt_dir: str,
                   tcfg: TrainConfig = TCFG) -> Tuple[List[int], int]:
    """(the leaves, by position in flatten order, that differ, the number
    of leaves) between
    ``len(bs)`` uninterrupted steps and a run saved after half of them,
    restored into a freshly built model's state and continued; each model
    is built from generator seed 0."""
    def fresh():
        return build_model(cfg, device=device,
                           generator=torch.Generator(device=device).manual_seed(0))

    half = len(bs) // 2
    full, _ = train_steps(fresh(), bs, tcfg)
    first, _ = train_steps(fresh(), bs[:half], tcfg)
    checkpoint.save(ckpt_dir, half, first)
    del first
    model = fresh()
    state = checkpoint.restore(ckpt_dir, init_train_state(model, tcfg))
    step = make_train_step(model, tcfg)
    for b in bs[half:]:
        state, _ = step(state, b)
    pairs = list(zip(checkpoint.tree_leaves(full), checkpoint.tree_leaves(state)))
    return [i for i, (a, b) in enumerate(pairs) if not torch.equal(a, b)], len(pairs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--layers", type=int, default=0,
                    help="the published widths at this depth in float32 "
                         "(0: the reduced config)")
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=64)
    args = ap.parse_args(argv)
    # before the first CUDA call of this process: cuBLAS reads it when it
    # makes its handle
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    cfg = reduced_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(get_config(args.arch), num_layers=args.layers,
                                  param_dtype="float32", compute_dtype="float32")
    bs = batches(cfg, args.steps, args.batch, args.seq, "cuda")
    with tempfile.TemporaryDirectory() as d:
        differ, n_leaves = resume_differs(cfg, torch.device("cuda"), bs, d)
    print(json.dumps({"arch": cfg.name, "layers": cfg.num_layers, "steps": args.steps,
                      "n_leaves": n_leaves, "differing_leaves": differ}))
    return 1 if differ else 0


if __name__ == "__main__":
    raise SystemExit(main())
