"""Decoder-only layer stack.

Port of the JAX package's ``models/transformer.py`` for the dense, MoE,
hybrid, ssm and vlm families. ``layer_specs`` and ``split_prefix_unit``
are the reference's (the decomposition is what ``convert`` needs to read
its parameter and cache trees). The port builds every layer kind
``(mixer, ffn)`` the reference builds: mixer ``"attn"``
(``attention.Attention``), ``"mla"`` (``mla.MLA``), ``"mamba"``
(``mamba.Mamba``) or ``"rwkv"`` (``rwkv.RWKV``), with ffn ``"mlp"``
(``layers.MLP``) or ``"moe"`` (``moe.MoE``). A layer holds its mixer
under the reference's key: ``attn`` for attention and MLA, ``mamba``,
``rwkv``.

Eager PyTorch has no scan, so the port keeps one ``nn.ModuleList`` of
layers in layer order (prefix, then the unit repeated ``n_repeat``
times); ``cfg.scan_layers`` changes nothing here. ``cfg.remat`` is the
reference's rematerialisation of each unit, done per layer while
autograd records a forward without caches: ``"full"`` keeps only the
layer's input (``torch.utils.checkpoint``, the reference's
``jax.checkpoint``); ``"selective"`` also keeps the outputs of the
weight products (``aten.mm``: dots with no batch dims, the reference's
``dots_with_no_batch_dims_saveable``) and recomputes the rest. Remat
changes memory, not values.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..distributed import spmd
from ..distributed.sharding import active_rules, use_rules
from . import attention, layers, mamba, mla, moe, rwkv
from .config import ModelConfig

LayerSpec = Tuple[str, str]  # (mixer_kind, ffn_kind)


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


@contextlib.contextmanager
def _within(*contexts):
    with contextlib.ExitStack() as stack:
        for c in contexts:
            stack.enter_context(c)
        yield


def _remat(layer: nn.Module, remat: str, *args):
    """``layer(*args)`` rematerialised as ``remat`` says (``encdec`` uses
    it too). The recompute runs under the forward's sharding rules:
    autograd may run it on a thread of its own (the card's), where the
    rules' context variable is unset."""
    rules = active_rules()
    if remat == "full":
        def contexts():
            return contextlib.nullcontext(), use_rules(rules)
    elif remat == "selective":
        def contexts():
            fwd, rec = ckpt.create_selective_checkpoint_contexts(_save_weight_products)
            return fwd, _within(rec, use_rules(rules))
    else:
        raise ValueError(f"remat {remat!r}: none, full or selective")
    return ckpt.checkpoint(layer, *args, use_reentrant=False, context_fn=contexts)


_MIXERS = {"attn": attention.Attention, "mla": mla.MLA, "mamba": mamba.Mamba,
           "rwkv": rwkv.RWKV}
# the mixer's key in the reference's layer tree
_MIXER_KEYS = {"attn": "attn", "mla": "attn", "mamba": "mamba", "rwkv": "rwkv"}
_FFNS = {"mlp": layers.MLP, "moe": moe.MoE}


class DecoderLayer(nn.Module):
    """Pre-norm mixer (``attn``: attention or MLA; ``mamba``; ``rwkv``)
    then a pre-norm FFN (``mlp`` or ``moe``), each residual. Returns (x,
    cache, aux, dropped): the MoE's aux loss (float32) and dropped count
    (int32), or None after a dense FFN. The recurrent mixers ignore
    ``positions``."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, device, generator):
        super().__init__()
        self.cfg = cfg
        self.spec = spec
        mixer, ffn = spec
        self.pre_norm = layers.zeros_param((cfg.d_model,), cfg.pdtype, device)
        self.mixer_key = _MIXER_KEYS[mixer]
        setattr(self, self.mixer_key, _MIXERS[mixer](cfg, device, generator))
        self.post_norm = layers.zeros_param((cfg.d_model,), cfg.pdtype, device)
        setattr(self, ffn, _FFNS[ffn](cfg, device, generator))

    def forward(self, x, positions=None, cache=None):
        eps = self.cfg.norm_eps
        y, cache = getattr(self, self.mixer_key)(
            layers.rms_norm(x, spmd.weight(self.pre_norm), eps),
            positions=positions, cache=cache)
        x = x + y
        h = layers.rms_norm(x, spmd.weight(self.post_norm), eps)
        if self.spec[1] == "moe":
            y, aux, dropped = self.moe(h)
            return x + y, cache, aux, dropped
        return x + self.mlp(h), cache, None, None


class Stack(nn.Module):
    """The layers in order: ``prefix``, then ``unit`` ``n_repeat`` times."""

    def __init__(self, cfg: ModelConfig, device, generator):
        super().__init__()
        specs = layer_specs(cfg)
        self.cfg = cfg
        self.specs = specs
        self.prefix, self.unit, self.n_repeat = split_prefix_unit(specs)
        self.layers = nn.ModuleList(DecoderLayer(cfg, spec, device, generator)
                                    for spec in specs)

    def forward(self, x: torch.Tensor, positions=None,
                caches: Optional[List] = None):
        """``caches``: one cache a layer, in layer order, or None. Returns
        (x, caches, aux, dropped), the MoE aux losses and dropped counts
        summed in the reference's order: each prefix layer's into the
        total, each repeat's unit summed and then added. A dense layer's
        zeros are left out of the sums (adding 0.0 changes no value)."""
        recording = torch.is_grad_enabled() and any(p.requires_grad
                                                    for p in self.parameters())
        remat = caches is None and self.cfg.remat != "none" and recording
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
        dropped_total = torch.zeros((), dtype=torch.int32, device=x.device)
        new_caches = [] if caches is not None else None
        n_prefix, n_unit = len(self.prefix), len(self.unit)
        for i, layer in enumerate(self.layers):
            if remat:
                x, c, aux, dropped = _remat(layer, self.cfg.remat, x, positions)
            else:
                x, c, aux, dropped = layer(
                    x, positions=positions,
                    cache=caches[i] if caches is not None else None)
            if caches is not None:
                new_caches.append(c)
            if i < n_prefix:
                if aux is not None:
                    aux_total = aux_total + aux
                    dropped_total = dropped_total + dropped
                continue
            j = (i - n_prefix) % n_unit
            if j == 0:
                aux_u = dropped_u = None
            if aux is not None:
                aux_u = aux if aux_u is None else aux_u + aux
                dropped_u = dropped if dropped_u is None else dropped_u + dropped
            if j == n_unit - 1 and aux_u is not None:
                aux_total = aux_total + aux_u
                dropped_total = dropped_total + dropped_u
        return x, new_caches, aux_total, dropped_total

    def stacked(self, i: int) -> bool:
        """Whether layer ``i``'s leaves carry the stack axis in the
        reference's tree (a repeat of a scanned unit)."""
        return self.cfg.scan_layers and i >= len(self.prefix)

    def init_caches(self, batch: int, max_len: int, device) -> List:
        """One zeroed cache a layer, of its mixer's kind (a recurrent
        state has no ``max_len``)."""
        cfg = self.cfg

        def one(mixer):
            if mixer == "attn":
                return attention.init_cache(cfg, batch, max_len, device)
            if mixer == "mla":
                return mla.init_mla_cache(cfg, batch, max_len, device)
            if mixer == "mamba":
                return mamba.init_mamba_cache(cfg, batch, device)
            return rwkv.init_rwkv_cache(cfg, batch, device)

        return [one(mixer) for mixer, _ in self.specs]
