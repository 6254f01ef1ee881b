"""Whisper-style encoder-decoder backbone.

Port of the JAX package's ``models/encdec.py``. The conv/mel front end
is a stub: the caller supplies frame embeddings ``(B, S_enc, d_model)``.
Sinusoidal positions on the encoder, learned positions (``dec_pos``,
65,536 rows) on the decoder, pre-LN blocks with GELU MLPs, no RoPE. The
decoder layer's cross-attention sits under the reference's key
``cross``; a decode step recomputes every layer's cross keys and values
from ``enc_out``, as the reference does.

The reference stacks the encoder and decoder layers and scans them,
whatever ``scan_layers`` says; the port keeps one module a layer
(``enc.<i>``, ``dec.<i>``: the reference's stacked leaf sliced at ``i``)
and, while autograd records a forward without caches and ``cfg.remat``
is not ``"none"``, rematerialises each layer whole (the reference's plain
``jax.checkpoint`` of the scan body, for ``"selective"`` too). The decoder
caches are one attention cache a decoder layer; a step reads every
layer's write position from layer 0's.

Under sharding rules (training on the mesh) the self-attention and the
GELU MLP split their heads and ffn columns over "model" as the decoder
stack's do, the embedding and the tied head their vocab rows. Cross
-attention's parameters (under ``cross``) match no pattern of the
reference's table and are replicated: every rank of the dim attends
with every head, over the encoder output it computed alike. The norms,
``dec_pos`` and the layer norms' biases are replicated too. The
recompute of a remat layer re-enters the rules, which autograd's own
thread (the card's) does not see.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

from ..distributed import spmd
from . import attention, layers, transformer
from .config import ModelConfig

# rows of the learned decoder positions (the reference's 1 << 16)
DEC_POSITIONS = 1 << 16


def _sinusoid(length: int, channels: int) -> np.ndarray:
    """(length, channels) float32: sines then cosines of
    ``t * 10000^(-i / (channels/2 - 1))``, computed in float64."""
    log_timescale = np.log(10_000) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    t = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(t), np.cos(t)], axis=1).astype(np.float32)


def sinusoid_table(length: int, channels: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """``_sinusoid`` on ``device`` in ``dtype``. On the card it goes up
    from pinned memory, asynchronously: the host does not wait for the
    stream."""
    table = torch.from_numpy(_sinusoid(length, channels))
    if device.type == "cuda":
        table = table.pin_memory()
    return table.to(device, non_blocking=True).to(dtype)


def _layer_norm(x, weight, bias, eps: float):
    return layers.layer_norm(x, spmd.weight(weight), spmd.weight(bias), eps)


def _ones(cfg: ModelConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.ones((cfg.d_model,), dtype=cfg.pdtype, device=device))


class EncoderLayer(nn.Module):
    """``ln1``/``ln1_b``, non-causal self-attention ``attn``,
    ``ln2``/``ln2_b``, the GELU ``mlp``; each block pre-LN and residual."""

    def __init__(self, cfg: ModelConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        self.ln1 = _ones(cfg, device)
        self.ln1_b = layers.zeros_param((cfg.d_model,), cfg.pdtype, device)
        self.attn = attention.Attention(cfg, device, generator)
        self.ln2 = _ones(cfg, device)
        self.ln2_b = layers.zeros_param((cfg.d_model,), cfg.pdtype, device)
        self.mlp = layers.GeluMLP(cfg, device, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        eps = self.cfg.norm_eps
        y, _ = self.attn(_layer_norm(x, self.ln1, self.ln1_b, eps),
                         causal=False, use_rope=False)
        x = x + y
        return x + self.mlp(_layer_norm(x, self.ln2, self.ln2_b, eps))


class DecoderLayer(EncoderLayer):
    """The encoder layer's blocks with causal self-attention (through the
    cache when one is given), and between them cross-attention ``cross``
    over the encoder output after ``ln_cross``/``ln_cross_b``."""

    def __init__(self, cfg: ModelConfig, device, generator):
        super().__init__(cfg, device, generator)
        self.cross = attention.Attention(cfg, device, generator)
        self.ln_cross = _ones(cfg, device)
        self.ln_cross_b = layers.zeros_param((cfg.d_model,), cfg.pdtype, device)

    def forward(self, x: torch.Tensor, enc_out: torch.Tensor, cache=None):
        eps = self.cfg.norm_eps
        y, cache = self.attn(_layer_norm(x, self.ln1, self.ln1_b, eps),
                             cache=cache, causal=True, use_rope=False)
        x = x + y
        y, _ = self.cross(_layer_norm(x, self.ln_cross, self.ln_cross_b, eps),
                          causal=False, use_rope=False, kv_x=enc_out)
        x = x + y
        return x + self.mlp(_layer_norm(x, self.ln2, self.ln2_b, eps)), cache


class EncDec(nn.Module):
    """The parameters of the reference's ``encdec_init``: ``embed``
    (and ``lm_head`` when untied), ``dec_pos``, the ``enc`` and ``dec``
    layers, ``enc_ln``/``enc_ln_b`` and ``dec_ln``/``dec_ln_b``; with
    ``encode``, ``decode_train``, ``decode`` (the reference's
    ``decode_step``) and ``init_dec_caches``."""

    def __init__(self, cfg: ModelConfig, device: torch.device, generator):
        super().__init__()
        self.cfg = cfg
        self.device = device
        self.embed = layers.Embedding(cfg, device, generator)
        self.lm_head = (None if cfg.tie_embeddings
                        else layers.LMHead(cfg, device, generator))
        self.dec_pos = layers.dense_param((DEC_POSITIONS, cfg.d_model), cfg.pdtype,
                                          device, generator, scale=0.01)
        self.enc = nn.ModuleList(EncoderLayer(cfg, device, generator)
                                 for _ in range(cfg.encoder_layers))
        self.dec = nn.ModuleList(DecoderLayer(cfg, device, generator)
                                 for _ in range(cfg.decoder_layers))
        self.enc_ln = _ones(cfg, device)
        self.enc_ln_b = layers.zeros_param((cfg.d_model,), cfg.pdtype, device)
        self.dec_ln = _ones(cfg, device)
        self.dec_ln_b = layers.zeros_param((cfg.d_model,), cfg.pdtype, device)

    def _remat(self) -> bool:
        return (self.cfg.remat != "none" and torch.is_grad_enabled()
                and any(p.requires_grad for p in self.parameters()))

    def _head(self, x: torch.Tensor) -> torch.Tensor:
        x = _layer_norm(x, self.dec_ln, self.dec_ln_b, self.cfg.norm_eps)
        if self.lm_head is None:
            return layers.vocab_logits(x, self.embed.table, 0, self.cfg)
        return self.lm_head(x)

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, S_enc, d_model) frame embeddings -> the encoder output, in
        the compute dtype."""
        cfg = self.cfg
        x = frames.to(cfg.cdtype) + sinusoid_table(frames.shape[1], cfg.d_model,
                                                   frames.device, cfg.cdtype)[None]
        remat = self._remat()
        for layer in self.enc:
            x = transformer._remat(layer, "full", x) if remat else layer(x)
        return _layer_norm(x, self.enc_ln, self.enc_ln_b, cfg.norm_eps)

    def decode_train(self, tokens: torch.Tensor, enc_out: torch.Tensor) -> torch.Tensor:
        """(B, S) tokens, teacher-forced from position 0, over ``enc_out``
        -> (B, S, V) logits."""
        s = tokens.shape[1]
        x = self.embed(tokens) + spmd.weight(self.dec_pos)[:s].to(self.cfg.cdtype)[None]
        remat = self._remat()
        for layer in self.dec:
            x = (transformer._remat(layer, "full", x, enc_out)[0] if remat
                 else layer(x, enc_out)[0])
        return self._head(x)

    def decode(self, token: torch.Tensor, enc_out: torch.Tensor, caches: List[Dict]):
        """(B, s) tokens through the decoder caches (written in place) at
        layer 0's ``pos``: (logits, caches). The learned positions are read
        from ``pos``, the start clamped at ``DEC_POSITIONS - s`` as
        ``dynamic_slice_in_dim`` clamps it."""
        s = token.shape[1]
        start = min(max(caches[0]["pos"], 0), DEC_POSITIONS - s)
        x = self.embed(token) + self.dec_pos[start:start + s].to(self.cfg.cdtype)[None]
        for layer, cache in zip(self.dec, caches):
            x, _ = layer(x, enc_out, cache=cache)
        return self._head(x), caches

    def init_dec_caches(self, batch: int, max_len: int, device=None) -> List[Dict]:
        """One zeroed attention cache a decoder layer, on ``device`` (None:
        the model's)."""
        device = self.device if device is None else device
        return [attention.init_cache(self.cfg, batch, max_len, device)
                for _ in range(self.cfg.decoder_layers)]
