"""RWKV-6 "Finch" block: token shift and data-dependent-decay linear attention.

Port of the JAX package's ``models/rwkv.py``. Per head of size D the state
S (D_k x D_v) evolves as

    S_t = diag(w_t) S_{t-1} + k_t^T v_t
    y_t = r_t (S_{t-1} + diag(u) k_t^T v_t)

with the decay w_t from the shifted input through a LoRA. Two forms of the
recurrence, chosen as the reference chooses them: the chunked form
(``chunked_wkv``, a Python loop over chunks) only with no cache,
``cfg.rwkv_impl == "chunked"`` and a sequence that is a multiple of
``cfg.rwkv_chunk``; otherwise the step form (``wkv_scan``, a Python loop
over time). The published config runs the step form. The two round
differently (the reference's own test allows 2e-4 between them).

The dtypes are the reference's: r/k/v/g in the compute dtype, r/k/v then
in float32, the decay ``exp(-exp(.))`` in float32, the state in float32,
the output norm and gate back in the compute dtype. A cache is
``{"state": (B,H,D,D) float32, "x_prev": (B,d)}``; a step with a cache
replaces both entries and returns the same dict.

Under sharding rules ``w_r``, ``w_k``, ``w_v`` and ``w_g`` hold this
rank's columns on the "ffn" dim, a block of whole heads, and ``w_o`` the
matching rows, whose parts are summed. The shift mixes ``mu`` and the
decay LoRA's ``w_decay_lora_a`` are replicated and read whole, and
``w_decay_lora_b``, ``decay_base``, ``bonus`` and ``ln_x`` are
replicated and read in this rank's channels (``spmd.part``): each rank's
gradient of them is its part, summed over the dim. The output norm runs
over every head: its sum of squares is summed over the dim
(``spmd.psum``). The cached step (serving) does not run on the mesh.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..distributed import spmd
from ..distributed.sharding import active_rules
from .config import ModelConfig
from .layers import dense_param, rms_norm


def _heads(cfg: ModelConfig) -> int:
    return cfg.d_model // cfg.rwkv_head_dim


def shift(x: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """The x_{t-1} stream: ``last`` (zeros or the cache's) prepended, the
    tail dropped."""
    return torch.cat([last[:, None, :], x[:, :-1, :]], dim=1)


def mix(x: torch.Tensor, x_prev: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x + (x_prev - x) * mu


def wkv_scan(r, k, v, w, u, s0):
    """The step recurrence over time, one token at a time. r/k/v/w
    (B,S,H,D) float32, u (H,D), s0 (B,H,D,D). Returns (state, y (B,S,H,D))."""
    u = u[..., None]
    state, ys = s0, []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]            # (B,H,D,D)
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, t], state + u * kv))
        state = state * w[:, t, :, :, None] + kv
    return state, torch.stack(ys, dim=1)


def chunked_wkv(r, k, v, w, u, s0, chunk: int):
    """The chunked (GLA-style) form: per chunk of C tokens an inter-chunk
    term from the carried state, a strictly causal intra-chunk term with
    decay-ratio weights, and the current token's bonus; log-space
    cumulative decays centred per chunk. Shapes as ``wkv_scan``; returns
    (state, y (B,S,H*D))."""
    b, s, h, dd = r.shape
    n = s // chunk
    logw = torch.log(torch.clamp(w.to(torch.float32), 1e-8, 1.0))
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=r.device),
                        diagonal=-1)
    state, ys = s0, []
    for i in range(n):
        sl = slice(i * chunk, (i + 1) * chunk)
        rr, kk, vv, lw = r[:, sl], k[:, sl], v[:, sl], logw[:, sl]   # (B,C,H,D)
        cum = torch.cumsum(lw, dim=1)                # inclusive log W_t
        cum_prev = cum - lw                          # exclusive log W_{t-1}
        total = cum[:, -1:]                          # log W_end
        center = 0.5 * total
        r_t = rr * torch.exp(cum_prev - center)
        k_t = kk * torch.exp(center - cum)
        a = torch.einsum("bthd,bjhd->bhtj", r_t, k_t)
        a = torch.where(causal, a, 0.0)
        y_intra = torch.einsum("bhtj,bjhd->bthd", a, vv)
        bonus = torch.einsum("bthd,bthd->bth", rr, u * kk)
        y_intra = y_intra + bonus[..., None] * vv
        r_in = rr * torch.exp(cum_prev)
        y_inter = torch.einsum("bthk,bhkv->bthv", r_in, state)
        k_dec = kk * torch.exp(total - cum)
        state = (state * torch.exp(total[:, 0])[..., None]
                 + torch.einsum("bjhk,bjhv->bhkv", k_dec, vv))
        ys.append(y_intra + y_inter)
    return state, torch.cat(ys, dim=1).reshape(b, s, h * dd)


class RWKV(nn.Module):
    """``mu (5,d)`` (the shift mixes of r, k, v, w, g), ``w_r``, ``w_k``,
    ``w_v``, ``w_g``, ``w_o (d,d)``, the decay LoRA ``w_decay_lora_a (d,L)``
    and ``w_decay_lora_b (L,d)`` with ``L = max(32, d // 32)``,
    ``decay_base``, ``bonus`` and ``ln_x (d,)``."""

    def __init__(self, cfg: ModelConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        d, pd = cfg.d_model, cfg.pdtype
        lora = max(32, d // 32)
        self.mu = nn.Parameter(torch.full((5, d), 0.5, dtype=pd, device=device))
        for name in ("w_r", "w_k", "w_v", "w_g", "w_o"):
            setattr(self, name, dense_param((d, d), pd, device, generator))
        self.w_decay_lora_a = dense_param((d, lora), pd, device, generator)
        self.w_decay_lora_b = dense_param((lora, d), pd, device, generator)
        self.decay_base = nn.Parameter(torch.full((d,), -6.0, dtype=pd, device=device))
        self.bonus = nn.Parameter(torch.zeros((d,), dtype=pd, device=device))
        self.ln_x = nn.Parameter(torch.ones((d,), dtype=pd, device=device))

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor] = None,
                cache: Optional[Dict] = None):
        """x (B,S,d) -> (y (B,S,d), cache or None); ``positions`` is
        ignored (the recurrence carries the order)."""
        cfg = self.cfg
        b, s, d = x.shape
        hd, c = cfg.rwkv_head_dim, cfg.cdtype
        tp = spmd.tp_axes(self.w_r, 1)
        mesh = active_rules().mesh if tp else None
        if tp and cache is not None:
            raise NotImplementedError("cached RWKV on the mesh (serving) waits for "
                                      "ROADMAP A10b-6b")
        w_r, w_k, w_v, w_g = (spmd.weight(w).to(c)
                              for w in (self.w_r, self.w_k, self.w_v, self.w_g))
        dl = w_r.shape[1]   # this rank's channels
        if dl % hd:
            raise ValueError(f"{dl} channels a rank do not hold whole heads of {hd}")
        h = dl // hd
        x = spmd.enter(x, mesh, tp)
        last = cache["x_prev"] if cache is not None else x.new_zeros((b, d))
        xp = shift(x, last)
        mu = spmd.weight(self.mu, split=bool(tp)).to(c)
        xr, xk, xv, xw, xg = (mix(x, xp, mu[i]) for i in range(5))
        r = (xr @ w_r).reshape(b, s, h, hd)
        k = (xk @ w_k).reshape(b, s, h, hd)
        v = (xv @ w_v).reshape(b, s, h, hd)
        g = xg @ w_g
        decay = ((xw @ spmd.weight(self.w_decay_lora_a, split=bool(tp)).to(c))
                 @ spmd.part(self.w_decay_lora_b, 1, tp).to(c))
        w = torch.exp(-torch.exp(decay.to(torch.float32)
                                 + spmd.part(self.decay_base, 0, tp).to(torch.float32)))
        w = w.reshape(b, s, h, hd)
        u = spmd.part(self.bonus, 0, tp).to(torch.float32).reshape(h, hd)
        r32, k32, v32 = (t.to(torch.float32) for t in (r, k, v))
        s0 = (cache["state"] if cache is not None
              else torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device))
        if cache is None and cfg.rwkv_impl == "chunked" and s % cfg.rwkv_chunk == 0:
            state, y = chunked_wkv(r32, k32, v32, w, u, s0, cfg.rwkv_chunk)
        else:
            state, y = wkv_scan(r32, k32, v32, w, u, s0)
        y = y.reshape(b, s, dl).to(c)
        ln_x = spmd.part(self.ln_x, 0, tp)
        y = rms_norm(y, ln_x, cfg.norm_eps, mesh, tp)
        y = y * nn.functional.silu(g)
        out = spmd.reduce(y @ spmd.weight(self.w_o).to(c), mesh, tp)
        if cache is not None:
            cache["state"] = state
            cache["x_prev"] = x[:, -1, :].contiguous()
        return out, cache


def init_rwkv_cache(cfg: ModelConfig, batch: int, device, dtype=None) -> Dict:
    dtype = dtype or cfg.cdtype
    h, hd = _heads(cfg), cfg.rwkv_head_dim
    return {"state": torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
            "x_prev": torch.zeros((batch, cfg.d_model), dtype=dtype, device=device)}
