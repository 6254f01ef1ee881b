"""Shared layers: RMS and layer norms, RoPE, embeddings, the SwiGLU and
GELU MLPs.

Port of the JAX package's ``models/layers.py``. Weights
keep the reference's orientation (``x @ w``, ``w`` of shape ``(in, out)``)
and its init scales, so ``convert.params_from_jax`` copies arrays as they
are. Each weight is cast to the compute dtype where it is used, as the
reference casts it.

Under sharding rules (``distributed.sharding.use_rules``, the parameters
sharded by ``shard_params``) each layer works on this rank's rows and
its block of each weight, through ``distributed.spmd`` (the reference's
``lshard`` sites): the embedding looks up its vocab rows and sums over
the "model" dim (tokens outside them give zeros), the head gives this
rank's vocab columns and gathers them, an MLP takes its ffn columns (and
the GELU MLP its slice of the replicated ``b_up``) and sums its down
projection over the dim.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.routing import linear_shard_index
from ..distributed import spmd
from ..distributed.sharding import active_rules, axis_size
from .config import ModelConfig


def dense_param(shape, dtype, device, generator, scale: Optional[float] = None
                ) -> nn.Parameter:
    """Normal(0, 1) * scale, drawn in float32 then cast (the reference's
    ``dense_init``; its fan-in is ``shape[-2]`` for any rank >= 2). On the
    meta device nothing is drawn."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    if torch.device(device).type == "meta":
        w = torch.empty(shape, dtype=dtype, device=device)
    else:
        # scaled in place: one float32 temporary (a 256-expert tensor's is
        # 15 GB at deepseek-v3's widths)
        w = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=device).mul_(scale).to(dtype)
    return nn.Parameter(w)


def zeros_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device))


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float, mesh=None,
             tp: spmd.Axes = ()) -> torch.Tensor:
    """Float32 RMS norm scaled by ``1 + weight``, cast back to x's dtype.
    With ``tp``, x's last dim holds this rank's channels of a dim split
    over those mesh dims: each rank's sum of squares is summed over them."""
    dtype = x.dtype
    x = x.to(torch.float32)
    if tp:
        var = spmd.psum(torch.sum(x * x, dim=-1, keepdim=True), mesh, tp) / (
            x.shape[-1] * axis_size(mesh, tp))
    else:
        var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + weight.to(torch.float32))).to(dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """Float32 layer norm (the population variance, ``jnp.var``'s ddof 0),
    then ``x * weight + bias``, cast back to x's dtype."""
    dtype = x.dtype
    x = x.to(torch.float32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.var(x, dim=-1, keepdim=True, unbiased=False)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * weight + bias).to(dtype)


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S). Split-half layout (the first
    and second halves of D are the pair), computed in float32."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


class Embedding(nn.Module):
    def __init__(self, cfg: ModelConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        self.table = dense_param((cfg.vocab_size, cfg.d_model), cfg.pdtype,
                                 device, generator, scale=1.0)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        # the reference's gather; F.embedding's CPU backward sums each row
        # in order, where indexing's accumulates with atomics and so is not
        # reproducible
        table = spmd.weight(self.table).to(self.cfg.cdtype)
        tp = spmd.tp_axes(self.table, 0)
        if not tp:
            return nn.functional.embedding(tokens, table)
        mesh = active_rules().mesh
        lo = linear_shard_index(mesh, tp) * table.shape[0]
        mine = (tokens >= lo) & (tokens < lo + table.shape[0])
        rows = nn.functional.embedding(torch.where(mine, tokens - lo, 0), table)
        return spmd.reduce(torch.where(mine[..., None], rows, 0), mesh, tp)


class LMHead(nn.Module):
    """Untied output projection, ``(d_model, vocab)``."""

    def __init__(self, cfg: ModelConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        self.w = dense_param((cfg.d_model, cfg.vocab_size), cfg.pdtype, device,
                             generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return vocab_logits(x, self.w, 1, self.cfg)


def vocab_logits(x: torch.Tensor, w: torch.Tensor, vocab_dim: int,
                 cfg: ModelConfig) -> torch.Tensor:
    """``x @ w`` (``w`` (d, V), or the tied table (V, d) with
    ``vocab_dim`` 0, transposed) in the compute dtype; under rules each
    rank's vocab columns, gathered over the "model" dim."""
    tp = spmd.tp_axes(w, vocab_dim)
    mesh = active_rules().mesh if tp else None
    w = spmd.weight(w).to(cfg.cdtype)
    logits = spmd.enter(x, mesh, tp) @ (w.T if vocab_dim == 0 else w)
    return spmd.gather(logits, -1, mesh, tp)


class MLP(nn.Module):
    """SwiGLU: ``(silu(x @ w_gate) * (x @ w_up)) @ w_down``."""

    def __init__(self, cfg: ModelConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.d_model, cfg.d_ff
        self.w_gate = dense_param((d, f), cfg.pdtype, device, generator)
        self.w_up = dense_param((d, f), cfg.pdtype, device, generator)
        self.w_down = dense_param((f, d), cfg.pdtype, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg.cdtype
        tp = spmd.tp_axes(self.w_gate, 1)
        mesh = active_rules().mesh if tp else None
        x = spmd.enter(x, mesh, tp)
        h = (nn.functional.silu(x @ spmd.weight(self.w_gate).to(c))
             * (x @ spmd.weight(self.w_up).to(c)))
        return spmd.reduce(h @ spmd.weight(self.w_down).to(c), mesh, tp)


class GeluMLP(nn.Module):
    """Whisper's MLP: ``gelu(x @ w_up + b_up) @ w_down + b_down``, the
    tanh-approximate GELU (``jax.nn.gelu``'s default), the biases added
    in the compute dtype."""

    def __init__(self, cfg: ModelConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        d, f = cfg.d_model, cfg.d_ff
        self.w_up = dense_param((d, f), cfg.pdtype, device, generator)
        self.w_down = dense_param((f, d), cfg.pdtype, device, generator)
        self.b_up = zeros_param((f,), cfg.pdtype, device)
        self.b_down = zeros_param((d,), cfg.pdtype, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Under rules the biases are replicated (no pattern names them):
        each rank adds its ffn slice of ``b_up`` before the GELU, and
        ``b_down`` once, after the down projection's sum."""
        c = self.cfg.cdtype
        tp = spmd.tp_axes(self.w_up, 1)
        mesh = active_rules().mesh if tp else None
        x = spmd.enter(x, mesh, tp)
        h = nn.functional.gelu(x @ spmd.weight(self.w_up).to(c)
                               + spmd.part(self.b_up, 0, tp).to(c), approximate="tanh")
        y = spmd.reduce(h @ spmd.weight(self.w_down).to(c), mesh, tp)
        return y + spmd.weight(self.b_down).to(c)
