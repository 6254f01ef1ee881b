"""Mixture-of-Experts: top-k routing, capacity-bounded dispatch, SwiGLU
experts, and optional shared experts.

Port of the JAX package's ``models/moe.py``: ``route``, ``expert_ranks``,
the local dispatch of ``_moe_local`` (``local_dispatch``), ``_expert_ffn``
and ``moe_apply``'s two expert-parallel dispatches on a mesh.

Without sharding rules every expert is local. Under rules
(``distributed.sharding.use_rules``, the parameters sharded by
``shard_params``) the experts split over the rules' "experts" dim (the
EP group) and each rank holds its rows of the batch (all of them where
the rows do not divide over the batch dims: ``spmd.batch_rows``), as the
reference's ``shard_map`` bodies do, with ``moe_impl``:

- ``"psum"``: each rank dispatches its rows to its own experts with the
  capacity of one data shard's tokens, and the partial outputs are summed
  over the EP group in the compute dtype;
- ``"a2a"`` (when the rows divide over the group): each rank routes its
  slice of the rows, sends them to the experts' owners and back with two
  ``all_to_all_single`` exchanges each way, at the reference's fixed
  buffer sizes (``capacity_factor`` is not read), and the slices are
  gathered.

``aux`` and ``dropped`` are what the reference returns through its
``P()`` out-spec: the first data shard's values (every rank gets them),
``aux`` averaged and ``dropped`` summed over the EP group. So the psum
dispatch reports ``n_ep`` times the drops of the first data shard (each
rank counts every expert's), and the a2a one reports only overflows of
its fixed buffers (ROADMAP Queue C, LM faults 9 and 10, both mirrored).
``aux``'s gradient is that of its mean over the data shards, as the
reference's transpose of ``shard_map`` gives it.

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

from ..core.routing import linear_shard_index
from ..distributed import spmd
from ..distributed.sharding import active_rules, axes_of, axis_size
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


def _swiglu_experts(x_e, w_gate, w_up, w_down):
    """(E, C, d) rows through each expert's SwiGLU (weights in the compute
    dtype)."""
    h = torch.einsum("ecd,edf->ecf", x_e, w_gate)
    u = torch.einsum("ecd,edf->ecf", x_e, w_up)
    return torch.einsum("ecf,efd->ecd", nn.functional.silu(h) * u, w_down)


def _combine(contrib, kept, flat_w, t: int, k: int):
    """(T*k, d) per-assignment outputs -> (T, d): a token's k
    contributions, weighted, summed in slot order, as the reference's
    scatter-add from zeros adds them (fixed order, unlike index_add_'s
    atomics on the card)."""
    contrib = torch.where(kept[:, None], contrib * flat_w[:, None], 0)
    contrib = contrib.reshape(t, k, contrib.shape[-1])
    out = contrib[:, 0]
    for j in range(1, k):
        out = out + contrib[:, j]
    return out


def local_dispatch(xf, router_w, w_gate, w_up, w_down, cfg: ModelConfig,
                   e_offset: int, e_local: int, cap: int):
    """The reference's ``_moe_local``: route the rows ``xf (T, d)`` over
    every expert, dispatch the kept assignments of experts ``e_offset ..
    e_offset + e_local`` (this rank's; all of them on one device) to their
    ``cap`` slots, run them and combine (a partial output when the experts
    are split). Returns (out (T, d), aux, dropped): ``dropped`` counts
    every expert's assignments ranked past ``cap``."""
    t, d = xf.shape
    k = cfg.moe_top_k
    logits = xf.to(torch.float32) @ router_w.to(torch.float32)
    top_w, top_e, aux = route(logits, cfg)
    flat_e = top_e.reshape(t * k)
    flat_w = top_w.reshape(t * k).to(xf.dtype)
    rank = expert_ranks(flat_e)
    kept = rank < cap
    dropped = torch.sum(~kept, dtype=torch.int32)
    local = kept & (flat_e >= e_offset) & (flat_e < e_offset + e_local)
    slot = (flat_e - e_offset) * cap + rank
    n = e_local * cap
    # dispatch: kept local assignments to their slots, the others to the
    # extra last row; assignment j is token j // k's (the reference's
    # xf[token_of], as a broadcast, whose backward is a sum over k)
    x_tok = xf[:, None, :].expand(t, k, d).reshape(t * k, d)
    x_e = torch.zeros((n + 1, d), dtype=xf.dtype, device=xf.device).index_copy(
        0, torch.where(local, slot, n), x_tok)
    y = _swiglu_experts(x_e[:n].reshape(e_local, cap, d), w_gate, w_up, w_down)
    # combine: each assignment gathers its slot's output
    contrib = y.reshape(n, d)[torch.clamp(slot, 0, n - 1)]
    return _combine(contrib, local, flat_w, t, k), aux, dropped


def expert_ffn(x_tok, expert_local, valid, w_gate, w_up, w_down, e_local: int,
               cap: int):
    """The reference's ``_expert_ffn``: rows ``x_tok (T, d)`` with a local
    expert id and a validity flag through this rank's experts at ``cap``
    rows each. Returns (out (T, d) aligned with the rows, zero where
    invalid or past capacity; the valid rows dropped)."""
    t, d = x_tok.shape
    eid = torch.where(valid, expert_local, e_local)
    rank = expert_ranks(eid)
    kept = valid & (rank < cap)
    dropped = torch.sum(valid & ~kept, dtype=torch.int32)
    slot = eid * cap + rank
    n = e_local * cap
    x_e = torch.zeros((n + 1, d), dtype=x_tok.dtype, device=x_tok.device).index_copy(
        0, torch.where(kept, slot, n), x_tok)
    y = _swiglu_experts(x_e[:n].reshape(e_local, cap, d), w_gate, w_up, w_down)
    out = torch.where(kept[:, None], y.reshape(n, d)[torch.clamp(slot, 0, n - 1)], 0)
    return out, dropped


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
        """x (B,S,d) (under rules, this rank's rows) -> (out (B,S,d), aux
        float32 scalar, dropped int32 scalar)."""
        cfg = self.cfg
        c = cfg.cdtype
        b, s, d = x.shape
        rules = active_rules()
        ep = axes_of(rules.axis("experts")) if rules is not None else ()
        wg, wu, wd = (spmd.weight(w).to(c) for w in (self.w_gate, self.w_up, self.w_down))
        if not ep:
            out, aux, dropped = local_dispatch(
                x.reshape(b * s, d), spmd.weight(self.router), wg, wu, wd, cfg, 0,
                cfg.moe_num_experts, capacity(b * s, cfg))
            out = out.reshape(b, s, d)
        else:
            out, aux, dropped = self._expert_parallel(x, rules, ep, wg, wu, wd)
        if cfg.moe_shared_experts:
            tp = spmd.tp_axes(self.shared_gate, 1)
            mesh = rules.mesh if tp else None
            xs = spmd.enter(x, mesh, tp)
            g = xs @ spmd.weight(self.shared_gate).to(c)
            u = xs @ spmd.weight(self.shared_up).to(c)
            out = out + spmd.reduce((nn.functional.silu(g) * u)
                                    @ self._shared_down(rules, mesh, tp).to(c), mesh, tp)
        return out, aux, dropped

    def _shared_down(self, rules, mesh, tp):
        """The rows of ``shared_down`` that this rank's ffn columns meet.
        The reference's first matching pattern, ``moe/shared_.*``, gives
        it ``("fsdp", "ffn")``: its d_model columns on the "model" dim,
        not its rows; they are gathered (the gradient reduce-scattered
        where the ranks use different rows of it) and the rows cut."""
        down_tp = spmd.tp_axes(self.shared_down, 1)
        if not down_tp:
            return spmd.part(self.shared_down, 0, tp)
        w = spmd.gather(spmd.weight(self.shared_down), 1, rules.mesh, down_tp,
                        grad="sum" if tp else "slice")
        return spmd.block(w, 0, mesh, tp)

    def _expert_parallel(self, x, rules, ep, wg, wu, wd):
        """``moe_apply``'s sharded branch on this rank's rows ``x``."""
        cfg = self.cfg
        b, s, d = x.shape
        mesh, e, k = rules.mesh, cfg.moe_num_experts, cfg.moe_top_k
        if len(ep) != 1:
            raise ValueError(f"the experts' mesh dim must be one dim, not {ep}")
        n_ep = axis_size(mesh, ep)
        if e % n_ep or wg.shape[0] != e // n_ep:
            raise ValueError(f"{e} experts do not split over {ep} ({n_ep} ranks)")
        ff_axis = rules.axis("moe_ff")
        if ff_axis is not None and cfg.moe_d_ff % axis_size(mesh, ff_axis) == 0:
            raise NotImplementedError("the expert-internal ff split (moe_ff, "
                                      "serving TP) waits for ROADMAP A10b-6b")
        e_local, me = e // n_ep, linear_shard_index(mesh, ep)
        t = b * s  # one data shard's tokens (all, where batch_rows replicated them)
        router = spmd.weight(self.router, split=True)
        xf = spmd.enter(x.reshape(t, d), mesh, ep)
        if cfg.moe_impl == "a2a" and t % n_ep == 0:
            out, aux, dropped = _a2a(xf, router, wg, wu, wd, cfg, mesh, ep[0], me,
                                     n_ep, e_local)
        else:
            out, aux, dropped = local_dispatch(xf, router, wg, wu, wd, cfg,
                                               me * e_local, e_local, capacity(t, cfg))
            # combine in the compute dtype, as the reference's psum
            out = spmd.reduce(out.to(cfg.cdtype), mesh, ep)
        return out.reshape(b, s, d), *_first_shard(aux, dropped, mesh, ep)


def _a2a(xf, router, wg, wu, wd, cfg: ModelConfig, mesh, axis: str, me: int,
         n_ep: int, e_local: int):
    """The reference's ``body_a2a`` on this rank's rows ``xf (T, d)``:
    route this rank's ``T / n_ep`` slice, exchange the assignments with
    the experts' owners at ``ceil(T/n_ep * k / n_ep * 2)`` slots a
    destination, run ``_expert_ffn`` at that total over the local experts
    plus 8, exchange back, combine and gather the slices over the group.
    Returns (out (T, d), aux of the slice, dropped: both overflows)."""
    t, d = xf.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    t_chunk = t // n_ep
    xs = xf[me * t_chunk:(me + 1) * t_chunk]
    logits = xs.to(torch.float32) @ router.to(torch.float32)
    top_w, top_e, aux = route(logits, cfg)
    flat_e = top_e.reshape(t_chunk * k)
    flat_w = top_w.reshape(t_chunk * k).to(xs.dtype)
    dest = flat_e // e_local
    rank = expert_ranks(dest)
    cap = int(math.ceil(t_chunk * k / n_ep * 2.0))
    kept = rank < cap
    n_drop_route = torch.sum(~kept, dtype=torch.int32)
    n = n_ep * cap
    slot = torch.where(kept, dest * cap + rank, n)
    x_tok = xs[:, None, :].expand(t_chunk, k, d).reshape(t_chunk * k, d)
    send_x = torch.zeros((n + 1, d), dtype=xs.dtype, device=xs.device).index_copy(
        0, slot, x_tok)[:n]
    send_e = torch.full((n + 1,), e, dtype=flat_e.dtype, device=xs.device).index_copy(
        0, slot, flat_e)[:n]
    recv_x = spmd.all_to_all(send_x, mesh, axis)
    recv_e = spmd.all_to_all(send_e, mesh, axis)
    e0 = me * e_local
    valid = (recv_e >= e0) & (recv_e < e0 + e_local)
    cap_e = int(math.ceil(n / e_local * 1.0)) + 8
    y, n_drop_cap = expert_ffn(recv_x, recv_e - e0, valid, wg, wu, wd, e_local, cap_e)
    back = spmd.all_to_all(y, mesh, axis)
    contrib = back[torch.clamp(slot, 0, n - 1)]
    out_chunk = _combine(contrib, kept, flat_w, t_chunk, k)
    out = spmd.gather(out_chunk, 0, mesh, (axis,))
    return out, aux, n_drop_route + n_drop_cap


def _first_shard(aux, dropped, mesh, ep):
    """(aux, dropped) as the reference's ``P()`` out-spec returns them
    from its ``pmean``/``psum`` over the EP group: the values at the
    first rank of every other mesh dim (the first data shard), on every
    rank. ``aux``'s gradient is that of the mean over all ranks."""
    per_rank = spmd.gather_mesh(torch.stack([aux.detach().to(torch.float64),
                                             dropped.to(torch.float64)]), mesh)
    i = mesh.mesh_dim_names.index(ep[0])
    first = per_rank.movedim(i, 0).reshape(mesh.size(i), -1, 2)[:, 0]
    aux_first = first[:, 0].to(torch.float32).sum() / mesh.size(i)
    dropped_first = first[:, 1].sum().to(torch.int32)
    mean = spmd.reduce(aux / mesh.size(), mesh, tuple(mesh.mesh_dim_names))
    return mean + (aux_first - mean).detach(), dropped_first
