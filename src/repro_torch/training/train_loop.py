"""Train step: gradients of the model's loss + AdamW, with microbatch
gradient accumulation and optional int8 gradient compression with error
feedback.

Port of the JAX package's ``training/train_loop.py``. The state is a
dict of tensors in the reference's layout::

    {"params": {name: tensor}, "opt": {"mu": {...}, "nu": {...}, "step"},
     "step": int32 tensor, "error_fb": {...}}   # error_fb: compress_grads

keyed by the model's ``state_dict`` names (``models.convert`` maps the
reference's tree onto them). ``state["params"]`` holds the model's own
parameters: the step differentiates ``model.loss`` with respect to them
(autograd, the reference's ``value_and_grad``) and the optimizer updates
them in place, so the model always carries the trained weights, and a
restore (``checkpoint.restore``) fills them in place.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Set

import torch
from torch.profiler import record_function

from ..distributed.sharding import sharding_of
from .compression import compressed_psum_grads
from .optimizer import OptimizerConfig, adamw_update, init_opt_state


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptimizerConfig = OptimizerConfig()
    grad_accum: int = 1           # microbatches per step
    compress_grads: bool = False  # int8 + error feedback DP sync
    # process group of the explicit all-reduce (the reference's
    # compress_axis); None quantizes and dequantizes only
    compress_group: Optional[object] = None


def init_train_state(model, tcfg: TrainConfig) -> Dict[str, Any]:
    """The train state over ``model``'s parameters, whose gradients are
    turned on (``build_model`` returns them frozen)."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    state = {"params": params, "opt": init_opt_state(tcfg.opt, params),
             "step": torch.zeros((), dtype=torch.int32, device=model.device)}
    if tcfg.compress_grads:
        if any(sharding_of(p) is not None for p in params.values()):
            raise ValueError("int8 gradient compression quantizes whole rows; "
                             "sharded parameters hold blocks")
        state["error_fb"] = {k: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device)
                             for k, p in params.items()}
    return state


def decayed_names(model) -> Set[str]:
    """The parameters AdamW decays: those of two or more dims in the
    reference's tree, where each stacked leaf carries one more (the stack
    axis, ``model.stacked``). So with ``scan_layers`` a unit layer's
    vectors (its norms, RWKV's ``decay_base``, ``bonus`` and ``ln_x``,
    Mamba's ``dt_bias`` and ``d_skip``) are decayed, and unscanned they
    are not; every encoder and decoder layer's norms and MLP biases are
    decayed, the final norms of the encdec family not (ROADMAP Queue C,
    training fault 4)."""
    return {k for k, p in model.named_parameters() if p.ndim + model.stacked(k) >= 2}


def make_train_step(model, tcfg: TrainConfig):
    """Returns ``train_step(state, batch) -> (state, metrics)``, the state
    updated in place. Metrics (0-dim tensors, nothing read back): loss,
    ce, moe_aux, moe_dropped, grad_norm, lr."""
    names = [k for k, _ in model.named_parameters()]
    decayed = decayed_names(model)

    def grad_of(params, batch):
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, [params[k] for k in names])
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(names, grads)))

    def compute_grads(params, batch):
        if tcfg.grad_accum == 1:
            return grad_of(params, batch)
        n = tcfg.grad_accum
        loss_sum = torch.zeros((), dtype=torch.float32, device=model.device)
        grads_sum = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for k, p in params.items()}
        for i in range(n):
            micro = {k: x.reshape(n, x.shape[0] // n, *x.shape[1:])[i]
                     for k, x in batch.items()}
            loss, metrics, grads = grad_of(params, micro)
            loss_sum = loss_sum + loss
            for k, g in grads.items():
                grads_sum[k] += g
        # the metrics of the last microbatch, as the reference's scan
        return loss_sum / n, metrics, {k: g / n for k, g in grads_sum.items()}

    def train_step(state, batch):
        params = state["params"]
        if any(params[k] is not p for k, p in model.named_parameters()):
            raise ValueError("state['params'] are not the model's parameters: "
                             "build the state with init_train_state(model, ...)")
        # record_function ranges name the parts in a profiler trace
        with record_function("train.grads"):
            loss, metrics, grads = compute_grads(params, batch)
        if tcfg.compress_grads:
            with record_function("train.compress"):
                grads, new_efb = compressed_psum_grads(grads, state["error_fb"],
                                                       group=tcfg.compress_group)
                for k, e in new_efb.items():
                    state["error_fb"][k].copy_(e)
        with record_function("train.optimizer"):
            _, _, opt_metrics = adamw_update(tcfg.opt, params, grads, state["opt"],
                                              decayed)
        state["step"] += 1
        return state, {"loss": loss, **metrics, **opt_metrics}

    return train_step
