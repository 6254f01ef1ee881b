"""Decoder-only layer stack.

Port of the JAX package's ``models/transformer.py`` for the dense
decoder. ``layer_specs`` and ``split_prefix_unit`` are the reference's
(the decomposition is what ``convert`` needs to read its parameter and
cache trees); the port supports only the ``("attn", "mlp")`` layer kind,
and any other kind raises ``NotImplementedError`` (ROADMAP A10b).

Eager PyTorch has no scan, so the port keeps one ``nn.ModuleList`` of
layers in layer order (prefix, then the unit repeated ``n_repeat``
times); ``cfg.scan_layers`` changes nothing here. ``cfg.remat`` is the
reference's rematerialisation of each unit, per layer (every unit of
the ported layer kind is one layer) while autograd records a forward
without caches: ``"full"`` keeps only the layer's input
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``);
``"selective"`` also keeps the outputs of the weight products
(``aten.mm``: dots with no batch dims, the reference's
``dots_with_no_batch_dims_saveable``) and recomputes the rest. Remat
changes memory, not values.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from . import attention, layers
from .config import ModelConfig

LayerSpec = Tuple[str, str]  # (mixer_kind, ffn_kind)
SUPPORTED: LayerSpec = ("attn", "mlp")


def layer_specs(cfg: ModelConfig) -> List[LayerSpec]:
    specs = []
    for i in range(cfg.num_layers):
        if cfg.family == "ssm":
            mixer = "rwkv"
        elif cfg.family == "hybrid" and not cfg.is_attn_layer(i):
            mixer = "mamba"
        elif cfg.use_mla:
            mixer = "mla"
        else:
            mixer = "attn"
        ffn = "moe" if cfg.is_moe_layer(i) else "mlp"
        specs.append((mixer, ffn))
    return specs


def split_prefix_unit(specs: List[LayerSpec]) -> Tuple[List[LayerSpec], List[LayerSpec], int]:
    """Minimal (prefix, unit, n_repeat) with tail = unit * n_repeat."""
    n = len(specs)
    for prefix_len in range(0, min(8, n)):
        tail = specs[prefix_len:]
        for unit_len in (1, 2, 4, 8, 16):
            if len(tail) % unit_len:
                continue
            unit = tail[:unit_len]
            if all(tail[i] == unit[i % unit_len] for i in range(len(tail))):
                return specs[:prefix_len], unit, len(tail) // unit_len
    return specs, [], 0  # fully unrolled fallback


def _save_weight_products(ctx, op, *args, **kwargs):
    """Selective remat policy: keep the non-batched products (``x @ w``
    reaches ``aten.mm``; attention's batched einsums reach ``aten.bmm``)."""
    if op is torch.ops.aten.mm.default:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(layer: nn.Module, remat: str, x: torch.Tensor, positions):
    if remat == "full":
        return ckpt.checkpoint(layer, x, positions, use_reentrant=False)
    if remat == "selective":
        return ckpt.checkpoint(
            layer, x, positions, use_reentrant=False,
            context_fn=functools.partial(ckpt.create_selective_checkpoint_contexts,
                                         _save_weight_products))
    raise ValueError(f"remat {remat!r}: none, full or selective")


class DecoderLayer(nn.Module):
    """Pre-norm attention then pre-norm SwiGLU MLP, each residual."""

    def __init__(self, cfg: ModelConfig, device, generator):
        super().__init__()
        self.cfg = cfg
        self.pre_norm = layers.zeros_param((cfg.d_model,), cfg.pdtype, device)
        self.attn = attention.Attention(cfg, device, generator)
        self.post_norm = layers.zeros_param((cfg.d_model,), cfg.pdtype, device)
        self.mlp = layers.MLP(cfg, device, generator)

    def forward(self, x, positions=None, cache=None):
        eps = self.cfg.norm_eps
        y, cache = self.attn(layers.rms_norm(x, self.pre_norm, eps),
                             positions=positions, cache=cache)
        x = x + y
        return x + self.mlp(layers.rms_norm(x, self.post_norm, eps)), cache


class Stack(nn.Module):
    """The layers in order: ``prefix``, then ``unit`` ``n_repeat`` times."""

    def __init__(self, cfg: ModelConfig, device, generator):
        super().__init__()
        specs = layer_specs(cfg)
        unsupported = sorted(set(specs) - {SUPPORTED})
        if unsupported:
            raise NotImplementedError(
                f"{cfg.name}: layer kinds {unsupported} are not ported; the "
                "port builds ('attn', 'mlp') layers only (ROADMAP A10b)")
        self.cfg = cfg
        self.prefix, self.unit, self.n_repeat = split_prefix_unit(specs)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device, generator)
                                    for _ in specs)

    def forward(self, x: torch.Tensor, positions=None,
                caches: Optional[List] = None):
        """``caches``: one cache a layer, in layer order, or None."""
        recording = torch.is_grad_enabled() and any(p.requires_grad
                                                    for p in self.parameters())
        if caches is None and self.cfg.remat != "none" and recording:
            for layer in self.layers:
                x, _ = _remat(layer, self.cfg.remat, x, positions)
            return x, None
        new_caches = [] if caches is not None else None
        for i, layer in enumerate(self.layers):
            x, c = layer(x, positions=positions,
                         cache=caches[i] if caches is not None else None)
            if caches is not None:
                new_caches.append(c)
        return x, new_caches

    def init_caches(self, batch: int, max_len: int, device) -> List:
        return [attention.init_cache(self.cfg, batch, max_len, device)
                for _ in self.layers]
