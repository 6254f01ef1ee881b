"""GQA attention: dense and chunked (flash-style) paths, KV-cache decode,
and the encoder-decoder's options: no RoPE, no causal mask, and
cross-attention (keys and values from the encoder output).

Port of the JAX package's ``models/attention.py``. Conventions: x (B,S,D); q (B,S,H,hd); k/v
(B,S,KV,hd); G = H/KV query heads per KV head. The math is plain tensor
ops in the reference's order and dtypes: the score product in the compute
dtype, then float32 times ``1/sqrt(hd)``, masked with ``NEG_INF``, a
float32 softmax cast back to the compute dtype.

A cache is ``{"k": (B,S,KV,hd), "v": (B,S,KV,hd), "pos": int}``, ``pos``
the number of history tokens written; a decode step writes its rows and
advances ``pos`` in place (the reference returns a new cache instead) and
returns the same cache.

Under sharding rules each rank attends with its block of the heads (the
"model" dim), through ``distributed.spmd``: ``wq`` and ``wo`` hold its
query heads, ``wk``/``wv`` its KV heads or, where they do not divide
over the dim, all of them (the GQA repeat then keeps this rank's heads),
and the output projection's parts are summed over the dim. Caches are
not sharded (serving on the mesh is ROADMAP A10b-6b).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ..distributed import spmd
from ..distributed.sharding import active_rules
from .config import ModelConfig
from .layers import apply_rope, dense_param

NEG_INF = -1e30


def _dense_attend(q, k, v, mask, scale):
    """q (B,Sq,H,D), k/v (B,Sk,H,D) (kv pre-repeated to H heads); mask
    broadcastable to (B,H,Sq,Sk), or None."""
    scores = torch.einsum("bqhd,bshd->bhqs", q, k).to(torch.float32) * scale
    if mask is not None:
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", probs, v)


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B,S,KV,D) -> (B,S,KV*G,D): each KV head repeated for its G query
    heads."""
    if groups == 1:
        return k
    b, s, kv, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kv, groups, d).reshape(b, s, kv * groups, d)


def _chunked_attend(q, k, v, scale, q_offset: int, chunk: int, causal: bool = True):
    """Flash-style online-softmax attention over KV chunks per Q chunk;
    causal, query i sits at position ``q_offset + i``.

    q (B,Sq,H,D), k/v (B,Sk,H,D) pre-repeated. Never materialises
    (Sq, Sk); the peak score block is (B,H,Cq,Ck).
    """
    b, sq, h, d = q.shape
    dv = v.shape[-1]
    sk = k.shape[1]
    cq = min(chunk, sq)
    ck = min(chunk, sk)
    nq, nk = sq // cq, sk // ck
    if sq % cq or sk % ck:
        raise ValueError(f"sequence lengths {sq}, {sk} are not multiples of "
                         f"the chunk {chunk}")
    dev = q.device
    outs = []
    for qi in range(nq):
        q_blk = q[:, qi * cq:(qi + 1) * cq].permute(0, 2, 1, 3)   # (b,h,cq,d)
        m = torch.full((b, h, cq), NEG_INF, dtype=torch.float32, device=dev)
        lsum = torch.zeros((b, h, cq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, cq, dv), dtype=torch.float32, device=dev)
        for ki in range(nk):
            k_blk = k[:, ki * ck:(ki + 1) * ck]
            v_blk = v[:, ki * ck:(ki + 1) * ck]
            s = torch.einsum("bhqd,bshd->bhqs", q_blk, k_blk).to(torch.float32) * scale
            if causal:
                qpos = q_offset + qi * cq + torch.arange(cq, device=dev)
                kpos = ki * ck + torch.arange(ck, device=dev)
                s = torch.where(qpos[:, None] >= kpos[None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            lsum = lsum * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqs,bshd->bhqd", p.to(q.dtype), v_blk).to(torch.float32)
            m = m_new
        out = acc / torch.clamp_min(lsum[..., None], 1e-30)
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=2).permute(0, 2, 1, 3)   # (b, sq, h, dv)


class Attention(nn.Module):
    """Self-attention with ``wq (D,H,hd)``, ``wk``/``wv (D,KV,hd)``,
    ``wo (H,hd,D)``."""

    def __init__(self, cfg: ModelConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        h, kv, d, hd = cfg.num_heads, cfg.num_kv_heads, cfg.d_model, cfg.head_dim
        self.wq = dense_param((d, h, hd), cfg.pdtype, device, generator)
        self.wk = dense_param((d, kv, hd), cfg.pdtype, device, generator)
        self.wv = dense_param((d, kv, hd), cfg.pdtype, device, generator)
        self.wo = dense_param((h, hd, d), cfg.pdtype, device, generator)

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor] = None,
                cache: Optional[Dict] = None, causal: bool = True,
                kv_x: Optional[torch.Tensor] = None, use_rope: bool = True):
        """With ``cache``, x is the new-token slice and the cache supplies
        the history (a decode step). With ``kv_x`` (cross-attention, no
        cache), keys and values come from ``kv_x``, unrotated, and no mask
        applies; ``causal=False`` drops the mask of self-attention. Returns
        (y, cache or None)."""
        cfg = self.cfg
        b, sq, d = x.shape
        c = cfg.cdtype
        # this rank's query heads, and whether its KV heads are a block too
        tp, kv_tp = spmd.tp_axes(self.wq, 1), spmd.tp_axes(self.wk, 1)
        mesh = active_rules().mesh if tp else None
        if tp and cache is not None:
            raise NotImplementedError("cached attention on the mesh (serving) "
                                      "waits for ROADMAP A10b-6b")
        wq, wo = spmd.weight(self.wq).to(c), spmd.weight(self.wo).to(c)
        wk = spmd.weight(self.wk, split=bool(tp)).to(c)
        wv = spmd.weight(self.wv, split=bool(tp)).to(c)
        h, kvh, hd = wq.shape[1], wk.shape[1], cfg.head_dim
        g = cfg.num_heads // cfg.num_kv_heads
        x = spmd.enter(x, mesh, tp)
        src = x if kv_x is None else spmd.enter(kv_x, mesh, tp)
        sk = src.shape[1]
        q = (x @ wq.reshape(d, h * hd)).reshape(b, sq, h, hd)
        k = (src @ wk.reshape(d, kvh * hd)).reshape(b, sk, kvh, hd)
        v = (src @ wv.reshape(d, kvh * hd)).reshape(b, sk, kvh, hd)
        if positions is None:
            # the reference rotates at arange(sq) when no positions are
            # given, and its decode step gives none: every decoded token is
            # rotated as position 0 (a fault of the reference, ROADMAP
            # Queue C; mirrored so the port is held to its outputs)
            positions = torch.arange(sq, device=x.device)[None, :]
        if use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            if kv_x is None:
                k = apply_rope(k, positions, cfg.rope_theta)

        scale = 1.0 / math.sqrt(hd)
        if cache is not None:
            pos = cache["pos"]
            ck, cv = cache["k"], cache["v"]
            s_total = ck.shape[1]
            # dynamic_update_slice clamps its start to max_len - sq: once pos
            # reaches max_len every step overwrites the last rows while pos
            # keeps growing (a fault of the reference, ROADMAP Queue C)
            start = max(min(pos, s_total - sq), 0)
            ck[:, start:start + sq] = k
            cv[:, start:start + sq] = v
            cache["pos"] = pos + sq
            if sq >= cfg.attn_chunk_threshold:
                # a prefill into the cache: chunked over the whole cache
                out = _chunked_attend(q, _repeat_kv(ck, g), _repeat_kv(cv, g),
                                      scale, pos, cfg.attn_chunk_size)
            else:
                # decode: attend over the full cache in the grouped layout
                # (each cached KV head read once)
                kpos = torch.arange(s_total, device=x.device)
                qpos = pos + torch.arange(sq, device=x.device)
                mask = kpos[None, :] <= qpos[:, None]            # (sq, S)
                qg = q.reshape(b, sq, kvh, g, hd)
                scores = torch.einsum("bqkgd,bskd->bkgqs", qg, ck).to(torch.float32) * scale
                scores = torch.where(mask, scores, NEG_INF)
                probs = torch.softmax(scores, dim=-1).to(q.dtype)
                out = torch.einsum("bkgqs,bskd->bqkgd", probs, cv).reshape(b, sq, h, hd)
        else:
            use_chunked = (cfg.attn_impl == "chunked" or
                           (cfg.attn_impl == "auto" and sq >= cfg.attn_chunk_threshold))
            k_rep = _repeat_kv(k, g)
            v_rep = _repeat_kv(v, g)
            if tp and not kv_tp:
                # every KV head here, this rank's query heads: keep their
                # repeats
                k_rep, v_rep = (spmd.block(t, 2, mesh, tp) for t in (k_rep, v_rep))
            if use_chunked and kv_x is None:
                out = _chunked_attend(q, k_rep, v_rep, scale, 0, cfg.attn_chunk_size,
                                      causal)
            else:
                # cross-attention is never chunked and never masked
                mask = None
                if causal and kv_x is None:
                    ar = torch.arange(sq, device=x.device)
                    mask = ar[:, None] >= ar[None, :]
                out = _dense_attend(q, k_rep, v_rep, mask, scale)
        y = out.reshape(b, sq, h * hd) @ wo.reshape(h * hd, d)
        return spmd.reduce(y, mesh, tp), cache


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device, dtype=None) -> Dict:
    dtype = dtype or cfg.cdtype
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": 0}
