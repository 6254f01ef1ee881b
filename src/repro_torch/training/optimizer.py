"""AdamW with a warmup-cosine schedule, as plain functions on dicts of
tensors.

Port of the JAX package's ``training/optimizer.py``, formula for
formula: the gradients clipped by their global norm, bias-corrected
moments in float32, decoupled weight decay on tensors of two or more
dims only (in the reference's tree: ``decayed`` names them where the
port's shapes differ, see ``train_loop.decayed_names``), each parameter
cast to float32, updated and cast back to its own dtype (no float32
master copy: the reference keeps none), the moments stored in
``moment_dtype``. ``torch.optim.AdamW`` is not used:
its decoupled decay rounds differently.

The reference returns new trees; here ``adamw_update`` writes the
parameters, the moments and the step counter in place (a full-width
state is 13 GB on the card) and returns the same dicts.

On a mesh each parameter is this rank's block (``distributed.sharding.
shard_params``): the moments are blocks of the same layout, as the
reference's ``device_put`` of the moments with the parameters' sharding
makes them, the update is elementwise, and the global norm sums each
block once over the mesh (``spmd.global_sq_norm``) before the clip.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Collection, Dict, Iterable, Optional, Tuple

import torch

from ..distributed import spmd
from ..distributed.sharding import mark, sharding_of


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


def schedule(cfg: OptimizerConfig, step) -> torch.Tensor:
    """Float32 learning rate at ``step`` (an integer tensor or int)."""
    step = torch.as_tensor(step)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def init_opt_state(cfg: OptimizerConfig, params: Dict[str, torch.Tensor]) -> Dict:
    """Zeroed moments beside each parameter (blocks of its layout on a
    mesh), and an int32 step counter on the parameters' device."""
    dt = torch.bfloat16 if cfg.moment_dtype == "bfloat16" else torch.float32
    device = next(iter(params.values())).device

    def moments():
        return {k: mark(torch.zeros(p.shape, dtype=dt, device=p.device), sharding_of(p))
                for k, p in params.items()}

    return {"mu": moments(), "nu": moments(),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def global_norm(leaves: Iterable[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves))


@torch.no_grad()
def adamw_update(cfg: OptimizerConfig, params: Dict[str, torch.Tensor],
                 grads: Dict[str, torch.Tensor], state: Dict,
                 decayed: Optional[Collection[str]] = None
                 ) -> Tuple[Dict, Dict, Dict[str, torch.Tensor]]:
    """One AdamW step in place: (params, state, {"grad_norm", "lr"}), the
    norm reported before clipping. ``decayed``: the names that take weight
    decay; None decays each tensor of two or more dims."""
    step = state["step"] + 1
    if any(sharding_of(p) is not None for p in params.values()):
        gnorm = torch.sqrt(spmd.global_sq_norm(grads, params))
    else:
        gnorm = global_norm(grads.values())
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** step.to(torch.float32)
    bc2 = 1 - b2 ** step.to(torch.float32)
    for k, p in params.items():
        mu, nu = state["mu"][k], state["nu"][k]
        g = grads[k].to(torch.float32) * scale
        mu32 = mu.to(torch.float32) * b1 + (1 - b1) * g
        nu32 = nu.to(torch.float32) * b2 + (1 - b2) * g * g
        update = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + cfg.eps)
        # decay matrices only (standard practice)
        if (p.ndim >= 2) if decayed is None else (k in decayed):
            update = update + cfg.weight_decay * p.to(torch.float32)
        p.copy_(p.to(torch.float32) - lr * update)
        mu.copy_(mu32)
        nu.copy_(nu32)
    state["step"].copy_(step)
    return params, state, {"grad_norm": gnorm, "lr": lr}
