"""Multi-head Latent Attention (DeepSeek-V2/V3).

Port of the JAX package's ``models/mla.py``. Queries and keys/values are
low-rank compressed (``w_dq`` then ``w_uq``; ``w_dkv`` then ``w_ukv``);
RoPE is decoupled into a per-head rope sub-dim of the queries and one
rope key channel shared by the heads (``w_kr``). Three paths, chosen as
the reference chooses them:

- no cache (training): keys and values expanded from the latent, dense
  causal attention;
- a cache and ``s >= attn_chunk_threshold`` (prefill): the latent written
  to the cache, keys and values expanded over the whole cache, chunked
  attention;
- a cache and a shorter ``s`` (decode): the absorbed form, scores and
  values computed in the latent space. It rounds differently from the
  expanded form and is kept.

A cache is ``{"c_kv": (B,S,kv_rank), "k_rope": (B,S,rope_dim), "pos":
int}``, written in place as the attention's cache is. Quirk of the
reference, mirrored (ROADMAP Queue C, LM fault 5): with no positions the
new keys' rope channel is rotated at ``arange(s)`` (0 in a decode step)
while the queries are rotated at ``pos + arange(s)``.

Under sharding rules (the reference's ``lshard`` of the heads) ``w_uq``,
``w_ukv`` and ``wo`` hold this rank's heads, and ``w_dq``, ``w_dkv`` and
``w_kr`` are whole on every rank of the "model" dim (FSDP on "data"
only): each rank computes the query and KV latents and the shared rope
key alike, splits the heads after them (``spmd.enter``: their gradients,
the rope key's over every head, sum over the dim) and sums the output
projection's parts. The cached paths (serving) do not run on the mesh.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ..distributed import spmd
from ..distributed.sharding import active_rules
from .attention import NEG_INF, _chunked_attend
from .config import ModelConfig
from .layers import apply_rope, dense_param, rms_norm, zeros_param


class MLA(nn.Module):
    """``w_dq (d, q_rank)``, ``q_norm``, ``w_uq (q_rank, H, dn + dr)``,
    ``w_dkv (d, kv_rank)``, ``kv_norm``, ``w_kr (d, dr)``, ``w_ukv
    (kv_rank, H, dn + dv)``, ``wo (H, dv, d)``."""

    def __init__(self, cfg: ModelConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        d, h = cfg.d_model, cfg.num_heads
        qr, kvr = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = cfg.nope_head_dim, cfg.rope_head_dim, cfg.v_head_dim
        pd = cfg.pdtype
        self.w_dq = dense_param((d, qr), pd, device, generator)
        self.q_norm = zeros_param((qr,), pd, device)
        self.w_uq = dense_param((qr, h, dn + dr), pd, device, generator)
        self.w_dkv = dense_param((d, kvr), pd, device, generator)
        self.kv_norm = zeros_param((kvr,), pd, device)
        self.w_kr = dense_param((d, dr), pd, device, generator)
        self.w_ukv = dense_param((kvr, h, dn + dv), pd, device, generator)
        self.wo = dense_param((h, dv, d), pd, device, generator)

    def _project_q(self, x, positions, mesh=None, tp=()):
        cfg = self.cfg
        c, dn = cfg.cdtype, cfg.nope_head_dim
        cq = rms_norm(x @ spmd.weight(self.w_dq).to(c), spmd.weight(self.q_norm),
                      cfg.norm_eps)
        q = torch.einsum("bsr,rhk->bshk", spmd.enter(cq, mesh, tp),
                         spmd.weight(self.w_uq).to(c))
        return q[..., :dn], apply_rope(q[..., dn:], positions, cfg.rope_theta)

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor] = None,
                cache: Optional[Dict] = None):
        """x (B,S,d) -> (y (B,S,d), cache or None)."""
        cfg = self.cfg
        b, s, _ = x.shape
        h, c = cfg.num_heads, cfg.cdtype
        dn, dr = cfg.nope_head_dim, cfg.rope_head_dim
        tp = spmd.tp_axes(self.w_uq, 1)
        mesh = active_rules().mesh if tp else None
        if tp and cache is not None:
            raise NotImplementedError("cached MLA on the mesh (serving) waits for "
                                      "ROADMAP A10b-6b")
        if positions is None:
            positions = torch.arange(s, device=x.device)[None, :]
        scale = 1.0 / math.sqrt(dn + dr)

        c_kv = rms_norm(x @ spmd.weight(self.w_dkv).to(c), spmd.weight(self.kv_norm),
                        cfg.norm_eps)                                      # (B,S,kvr)
        k_rope = (x @ spmd.weight(self.w_kr).to(c))[:, :, None, :]          # (B,S,1,dr)
        k_rope = apply_rope(k_rope, positions, cfg.rope_theta)[:, :, 0, :]
        w_ukv = spmd.weight(self.w_ukv).to(c)

        if cache is None:
            # this rank's heads from here on
            c_kv, k_rope = spmd.enter(c_kv, mesh, tp), spmd.enter(k_rope, mesh, tp)
            q_nope, q_rope = self._project_q(x, positions, mesh, tp)
            kv = torch.einsum("bsr,rhk->bshk", c_kv, w_ukv)
            k_nope, v = kv[..., :dn], kv[..., dn:]
            scores = (torch.einsum("bqhd,bshd->bhqs", q_nope, k_nope)
                      + torch.einsum("bqhd,bsd->bhqs", q_rope, k_rope))
            scores = scores.to(torch.float32) * scale
            ar = torch.arange(s, device=x.device)
            scores = torch.where(ar[:, None] >= ar[None, :], scores, NEG_INF)
            probs = torch.softmax(scores, dim=-1).to(x.dtype)
            out = torch.einsum("bhqs,bshd->bqhd", probs, v)
        else:
            pos = cache["pos"]
            cc, cr = cache["c_kv"], cache["k_rope"]
            s_total = cc.shape[1]
            # dynamic_update_slice clamps its start to max_len - s (ROADMAP
            # Queue C, LM fault 2)
            start = max(min(pos, s_total - s), 0)
            cc[:, start:start + s] = c_kv
            cr[:, start:start + s] = k_rope
            cache["pos"] = pos + s
            q_nope, q_rope = self._project_q(x, pos + positions)
            if s >= cfg.attn_chunk_threshold:
                # prefill: expand k/v over the whole cache once, chunked
                kv = torch.einsum("bsr,rhk->bshk", cc, w_ukv)
                k_nope, v = kv[..., :dn], kv[..., dn:]
                k_full = torch.cat(
                    [k_nope, cr[:, :, None, :].expand(b, s_total, h, dr)], dim=-1)
                out = _chunked_attend(torch.cat([q_nope, q_rope], dim=-1), k_full, v,
                                      scale, pos, cfg.attn_chunk_size)
            else:
                # absorbed decode: scores and values in the latent space
                q_abs = torch.einsum("bqhd,rhd->bqhr", q_nope, w_ukv[..., :dn])
                scores = (torch.einsum("bqhr,bsr->bhqs", q_abs, cc)
                          + torch.einsum("bqhd,bsd->bhqs", q_rope, cr))
                scores = scores.to(torch.float32) * scale
                qpos = pos + torch.arange(s, device=x.device)
                kpos = torch.arange(s_total, device=x.device)
                scores = torch.where(qpos[:, None] >= kpos[None, :], scores, NEG_INF)
                probs = torch.softmax(scores, dim=-1).to(x.dtype)
                out_lat = torch.einsum("bhqs,bsr->bqhr", probs, cc)
                out = torch.einsum("bqhr,rhd->bqhd", out_lat, w_ukv[..., dn:])
        y = torch.einsum("bshd,hdk->bsk", out, spmd.weight(self.wo).to(c))
        return spmd.reduce(y, mesh, tp), cache


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                   dtype=None) -> Dict:
    dtype = dtype or cfg.cdtype
    return {"c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dtype,
                                device=device),
            "k_rope": torch.zeros((batch, max_len, cfg.rope_head_dim), dtype=dtype,
                                  device=device),
            "pos": 0}
