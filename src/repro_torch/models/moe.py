"""Mixture-of-Experts: top-k routing, capacity-bounded dispatch, SwiGLU
experts, and optional shared experts.

Port of the JAX package's ``models/moe.py`` on one device (its
``moe_apply`` with no sharding rules): ``route``, ``expert_ranks`` and
the local dispatch of ``_moe_local`` with every expert local. The mesh
dispatches (psum partials, all-to-all) wait for ROADMAP A10b-5.

Dispatch is index-based, as in the reference: an assignment's slot in
the ``(E, C, d)`` buffer is ``expert * C + rank``, its rank within its
expert from a stable sort; assignments ranked at or past the capacity
``C`` are dropped and counted. The buffer runs every expert over ``C``
rows whatever the routing (the reference's shape, kept). The reference
writes dropped rows to the out-of-range index ``E * C`` with
``mode="drop"``; here the buffer has that one extra row, which takes
them and is cut off. Nothing reads back to the host: the aux loss and
the dropped count stay on the device.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
from torch import nn

from .config import ModelConfig
from .layers import dense_param


def route(logits: torch.Tensor, cfg: ModelConfig
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(top_w, top_e, aux) of router logits (T, E): the float32 softmax's
    top-k, renormalised with a floor of 1e-9, and the load-balancing loss
    ``E * sum_e f_e * P_e`` (f the share of assignments, P the mean
    probability). The top-k is the head of a stable descending sort, so a
    tie picks the lower expert, as ``lax.top_k`` does (``torch.topk``
    promises no order among ties)."""
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    top_w, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_w, top_e = top_w[:, :cfg.moe_top_k], top_e[:, :cfg.moe_top_k]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)
    e = cfg.moe_num_experts
    flat = top_e.reshape(-1)
    f = torch.zeros(e, dtype=torch.float32, device=logits.device).scatter_add_(
        0, flat, torch.ones(flat.shape, dtype=torch.float32, device=logits.device))
    f = f / torch.clamp_min(f.sum(), 1.0)
    aux = e * torch.sum(f * probs.mean(dim=0))
    return top_w, top_e, aux


def expert_ranks(flat_e: torch.Tensor) -> torch.Tensor:
    """Rank of each assignment among those of its expert, in assignment
    order (a stable sort, then the first index of each run)."""
    n = flat_e.shape[0]
    sorted_e, order = torch.sort(flat_e, stable=True)
    rank_sorted = (torch.arange(n, device=flat_e.device)
                   - torch.searchsorted(sorted_e, sorted_e, side="left"))
    return torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)


def capacity(tokens: int, cfg: ModelConfig) -> int:
    """Rows an expert takes: the reference's float arithmetic, in order."""
    return int(math.ceil(tokens * cfg.moe_top_k / cfg.moe_num_experts
                         * cfg.capacity_factor))


class MoE(nn.Module):
    """Routed SwiGLU experts ``w_gate``/``w_up (E, d, ff)``, ``w_down
    (E, ff, d)``, a float32 ``router (d, E)``, and with
    ``moe_shared_experts`` a shared SwiGLU of ``ff * n_shared``."""

    def __init__(self, cfg: ModelConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        d, e, ff = cfg.d_model, cfg.moe_num_experts, cfg.moe_d_ff
        self.router = dense_param((d, e), torch.float32, device, generator, scale=0.02)
        self.w_gate = dense_param((e, d, ff), cfg.pdtype, device, generator)
        self.w_up = dense_param((e, d, ff), cfg.pdtype, device, generator)
        self.w_down = dense_param((e, ff, d), cfg.pdtype, device, generator)
        if cfg.moe_shared_experts:
            sff = ff * cfg.moe_shared_experts
            self.shared_gate = dense_param((d, sff), cfg.pdtype, device, generator)
            self.shared_up = dense_param((d, sff), cfg.pdtype, device, generator)
            self.shared_down = dense_param((sff, d), cfg.pdtype, device, generator)

    def forward(self, x: torch.Tensor):
        """x (B,S,d) -> (out (B,S,d), aux float32 scalar, dropped int32
        scalar)."""
        cfg = self.cfg
        c = cfg.cdtype
        b, s, d = x.shape
        t, k, e = b * s, cfg.moe_top_k, cfg.moe_num_experts
        cap = capacity(t, cfg)
        xf = x.reshape(t, d)
        logits = xf.to(torch.float32) @ self.router.to(torch.float32)
        top_w, top_e, aux = route(logits, cfg)
        flat_e = top_e.reshape(t * k)
        flat_w = top_w.reshape(t * k).to(xf.dtype)
        rank = expert_ranks(flat_e)
        kept = rank < cap
        dropped = torch.sum(~kept, dtype=torch.int32)
        slot = flat_e * cap + rank
        # dispatch: kept assignments to their slots, dropped ones to the
        # extra last row; assignment j is token j // k's (the reference's
        # xf[token_of], as a broadcast, whose backward is a sum over k)
        x_tok = xf[:, None, :].expand(t, k, d).reshape(t * k, d)
        x_e = torch.zeros((e * cap + 1, d), dtype=xf.dtype, device=x.device).index_copy(
            0, torch.where(kept, slot, e * cap), x_tok)
        x_e = x_e[:e * cap].reshape(e, cap, d)
        h = torch.einsum("ecd,edf->ecf", x_e, self.w_gate.to(c))
        u = torch.einsum("ecd,edf->ecf", x_e, self.w_up.to(c))
        y = torch.einsum("ecf,efd->ecd", nn.functional.silu(h) * u, self.w_down.to(c))
        # combine: each assignment gathers its slot's output, weighted
        contrib = y.reshape(e * cap, d)[torch.clamp(slot, 0, e * cap - 1)]
        contrib = torch.where(kept[:, None], contrib * flat_w[:, None], 0)
        contrib = contrib.reshape(t, k, d)
        # a token's k contributions summed in slot order, as the
        # reference's scatter-add from zeros adds them (fixed order, unlike
        # index_add_'s atomics on the card)
        out = contrib[:, 0]
        for j in range(1, k):
            out = out + contrib[:, j]
        out = out.reshape(b, s, d)
        if cfg.moe_shared_experts:
            g = x @ self.shared_gate.to(c)
            u = x @ self.shared_up.to(c)
            out = out + (nn.functional.silu(g) * u) @ self.shared_down.to(c)
        return out, aux, dropped
