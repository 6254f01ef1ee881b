"""Mamba (S6) selective-SSM block, the mixer of Jamba's non-attention layers.

Port of the JAX package's ``models/mamba.py``. With no cache the sequence
runs in chunks of ``min(cfg.mamba_chunk, S)``: a Python loop over chunks
carries the (B, Din, N) float32 state, and within a chunk the linear
recurrence h_t = a_t * h_{t-1} + b_t is solved by ``associative_scan``,
the even/odd recursion of ``jax.lax.associative_scan`` in tensor ops
(``2 * ceil(log2(chunk))`` levels, where a loop over the chunk would take
``chunk`` steps). The working set is several (B, chunk, Din, N) float32
tensors.

With a cache the block takes one recurrence step, and this keeps a fault
of the reference (ROADMAP Queue C, LM fault 6): given several tokens, the
conv state takes them all, but the SSM state is stepped by the first token
only and that one output is broadcast over the sequence. The serving
engine feeds one token a step and never meets it; ``Model.prefill`` with a
prompt longer than one token does.

A cache is ``{"h": (B,Din,N) float32, "conv": (B,K-1,Din)}``; a step with
a cache replaces both entries and returns the same dict.

Under sharding rules the inner dim Din is split over the "ffn" dim
(the reference's ``lshard`` of ``u`` and ``y``): ``w_in``, ``w_z``,
``conv`` and ``a_log`` hold this rank's channels, and so do ``w_b``,
``w_c`` and ``w_dt``, whose products contract over Din: each rank's B, C
and dt input are partial sums, summed over the dim (one ``spmd.psum``)
before the scan. ``w_dt_out``, ``dt_bias`` and ``d_skip`` are
replicated (no pattern of the reference's names them at their rank) and
read in this rank's channels (``spmd.part``). The conv, the softplus,
the scan and the gate stay local; ``w_out``'s parts are summed. The
cached step (serving) does not run on the mesh.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from ..distributed import spmd
from ..distributed.sharding import active_rules
from .config import ModelConfig
from .layers import dense_param


def _dt_rank(cfg: ModelConfig) -> int:
    return max(1, math.ceil(cfg.d_model / 16))


def causal_conv(u: torch.Tensor, conv_w: torch.Tensor, state=None):
    """Depthwise causal conv along the sequence, u (B,S,Din), conv_w
    (K,Din), as the reference's shifted sum in its order of terms (not
    ``conv1d``, which rounds in another order). Returns (out, the last
    K-1 inputs as the new state)."""
    k = conv_w.shape[0]
    pad = (state if state is not None
           else u.new_zeros((u.shape[0], k - 1, u.shape[2])))
    u_ext = torch.cat([pad, u], dim=1)
    s = u.shape[1]
    out = u_ext[:, 0:s] * conv_w[0]
    for i in range(1, k):
        out = out + u_ext[:, i:i + s] * conv_w[i]
    return out, (u_ext[:, -(k - 1):] if k > 1 else None)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``, no threshold."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def _combine(e1, e2):
    (a1, b1), (a2, b2) = e1, e2
    return a1 * a2, b1 * a2 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor, dim: int) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along ``dim`` (``even`` as long as
    ``odd`` or one longer)."""
    n = odd.shape[dim]
    both = torch.stack([even.narrow(dim, 0, n), odd], dim=dim + 1).flatten(dim, dim + 1)
    if even.shape[dim] > n:
        both = torch.cat([both, even.narrow(dim, n, 1)], dim=dim)
    return both


def associative_scan(a: torch.Tensor, b: torch.Tensor, dim: int = 1):
    """The inclusive scan of ``(a, b)`` under ``(a1*a2, b1*a2 + b2)`` along
    ``dim``, by the recursion ``jax.lax.associative_scan`` uses: combine
    adjacent pairs, scan the half, then fill in the even positions."""
    n = a.shape[dim]
    if n < 2:
        return a, b

    def sl(t, start, stop=None, step=1):
        idx = [slice(None)] * t.dim()
        idx[dim] = slice(start, stop, step)
        return t[tuple(idx)]

    reduced = _combine((sl(a, 0, -1, 2), sl(b, 0, -1, 2)), (sl(a, 1, None, 2), sl(b, 1, None, 2)))
    odd = associative_scan(*reduced, dim=dim)
    rest = (sl(a, 2, None, 2), sl(b, 2, None, 2))
    if n % 2 == 0:
        even = _combine((sl(odd[0], 0, -1), sl(odd[1], 0, -1)), rest)
    else:
        even = _combine(odd, rest)
    even = (torch.cat([sl(a, 0, 1), even[0]], dim=dim),
            torch.cat([sl(b, 0, 1), even[1]], dim=dim))
    return _interleave(even[0], odd[0], dim), _interleave(even[1], odd[1], dim)


class Mamba(nn.Module):
    """``w_in``, ``w_z (d,Din)``, ``conv (K,Din)``, ``w_b``, ``w_c (Din,N)``,
    ``w_dt (Din,R)``, ``w_dt_out (R,Din)``, ``dt_bias (Din,)``, ``a_log
    (Din,N)`` (``log(1..N)`` on every row, not drawn), ``d_skip (Din,)``,
    ``w_out (Din,d)``; Din = expand * d, R = ceil(d / 16)."""

    def __init__(self, cfg: ModelConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        d, pd = cfg.d_model, cfg.pdtype
        din, n, r = cfg.mamba_expand * d, cfg.mamba_d_state, _dt_rank(cfg)
        self.w_in = dense_param((d, din), pd, device, generator)
        self.w_z = dense_param((d, din), pd, device, generator)
        self.conv = dense_param((cfg.mamba_d_conv, din), pd, device, generator)
        self.w_b = dense_param((din, n), pd, device, generator)
        self.w_c = dense_param((din, n), pd, device, generator)
        self.w_dt = dense_param((din, r), pd, device, generator)
        self.w_dt_out = dense_param((r, din), pd, device, generator)
        self.dt_bias = nn.Parameter(torch.full((din,), -4.6, dtype=pd, device=device))
        a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
        self.a_log = nn.Parameter(torch.log(a).repeat(din, 1).to(pd))
        self.d_skip = nn.Parameter(torch.ones((din,), dtype=pd, device=device))
        self.w_out = dense_param((din, d), pd, device, generator)

    def _ssm_params(self, u: torch.Tensor, mesh=None, tp=()):
        """(da, db (B,S,Din,N) float32, cmat (B,S,N)) from the post-conv
        activations u (B,S,Din) (under rules, this rank's channels of
        each)."""
        c = self.cfg.cdtype
        bmat = u @ spmd.weight(self.w_b).to(c)
        cmat = u @ spmd.weight(self.w_c).to(c)
        dt = u @ spmd.weight(self.w_dt).to(c)
        if tp:
            n = bmat.shape[-1]
            both = spmd.psum(torch.cat([bmat, cmat, dt], dim=-1), mesh, tp)
            bmat, cmat, dt = both[..., :n], both[..., n:2 * n], both[..., 2 * n:]
        dt = dt @ spmd.part(self.w_dt_out, 1, tp).to(c)
        dt = softplus(dt.to(torch.float32) + spmd.part(self.dt_bias, 0, tp).to(torch.float32))
        a = -torch.exp(spmd.weight(self.a_log).to(torch.float32))
        da = torch.exp(dt[..., None] * a)
        db = dt[..., None] * bmat[:, :, None, :]
        return da, db, cmat

    def forward(self, x: torch.Tensor, positions: Optional[torch.Tensor] = None,
                cache: Optional[Dict] = None):
        """x (B,S,d) -> (y (B,S,d), cache or None); ``positions`` is
        ignored."""
        cfg = self.cfg
        b, s, d = x.shape
        c = cfg.cdtype
        tp = spmd.tp_axes(self.w_in, 1)
        mesh = active_rules().mesh if tp else None
        if tp and cache is not None:
            raise NotImplementedError("cached Mamba on the mesh (serving) waits for "
                                      "ROADMAP A10b-6b")
        x = spmd.enter(x, mesh, tp)
        u = x @ spmd.weight(self.w_in).to(c)
        z = x @ spmd.weight(self.w_z).to(c)
        conv_w = spmd.weight(self.conv).to(c)
        d_skip = spmd.part(self.d_skip, 0, tp).to(c)
        if cache is not None:
            u, conv_state = causal_conv(u, conv_w, cache["conv"])
            u = nn.functional.silu(u)
            da, db, cmat = self._ssm_params(u)
            # the first token only (LM fault 6)
            h = cache["h"] * da[:, 0] + db[:, 0] * u[:, 0, :, None].to(torch.float32)
            y = torch.einsum("bdn,bn->bd", h, cmat[:, 0].to(torch.float32))[:, None]
            cache["h"], cache["conv"] = h, conv_state
            y = y.to(x.dtype) + u * d_skip
        else:
            u, _ = causal_conv(u, conv_w)
            u = nn.functional.silu(u)
            chunk = min(cfg.mamba_chunk, s)
            if s % chunk:
                raise ValueError(f"sequence {s} is not a multiple of the chunk {chunk}")
            h = torch.zeros((b, u.shape[-1], cfg.mamba_d_state), dtype=torch.float32,
                            device=x.device)
            ys = []
            for i in range(s // chunk):
                uc = u[:, i * chunk:(i + 1) * chunk]
                da, db, cmat = self._ssm_params(uc, mesh, tp)
                bx = db * uc[..., None].to(torch.float32)
                a_cum, b_scan = associative_scan(da, bx, dim=1)
                hs = b_scan + a_cum * h[:, None]            # the carry folded in
                ys.append(torch.einsum("bsdn,bsn->bsd", hs, cmat.to(torch.float32))
                          .to(x.dtype))
                h = hs[:, -1]
            y = torch.cat(ys, dim=1) + u * d_skip
        y = y * nn.functional.silu(z)
        return spmd.reduce(y @ spmd.weight(self.w_out).to(c), mesh, tp), cache


def init_mamba_cache(cfg: ModelConfig, batch: int, device, dtype=None) -> Dict:
    dtype = dtype or cfg.cdtype
    din = cfg.mamba_expand * cfg.d_model
    return {"h": torch.zeros((batch, din, cfg.mamba_d_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, din), dtype=dtype,
                                device=device)}
