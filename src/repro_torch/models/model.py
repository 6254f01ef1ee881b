"""Model facade: the decoder-only families from their ModelConfig.

Port of the JAX package's ``models/model.py`` for the dense family
(tinyllama-1.1b, internlm2-20b, mistral-nemo-12b, stablelm-3b), the MoE
family, with MLA and multi-token prediction (olmoe-1b-7b,
deepseek-v3-671b), the hybrid family (jamba-1.5-large-398b: Mamba layers
with an attention layer in every ``attn_period``) and the ssm family
(rwkv6-1.6b: RWKV-6 layers):

    model = build_model(cfg, device="cuda", generator=g)  # seeded weights
    logits, aux = model.apply(batch)                      # forward
    loss, metrics = model.loss(batch)                     # training fwd
    caches = model.init_caches(batch_size, max_len)       # serving
    logits, caches = model.prefill(batch, caches)
    logits, caches = model.decode_step(token, caches)

The model carries its weights and device (the reference passes a params
tree to pure functions; ``convert.params_from_jax`` loads one). Batch
dict: ``tokens`` (B,S) and ``targets`` (B,S) integer tensors. ``aux``
holds the stack's summed MoE aux loss and dropped count (zeros for a
dense stack) and, with ``cfg.mtp``, the multi-token-prediction logits:
one more layer over ``cat([h_t, embed(target_t)]) @ mtp_proj`` predicts
token t+2, and ``loss`` adds 0.3 of its cross-entropy.
``build_model`` returns the weights frozen (``requires_grad`` off), so
``apply`` and ``loss`` build no graph; ``training.train_loop`` turns
gradients on and differentiates ``loss``. ``prefill`` and
``decode_step`` (serving) always run without autograd. The enc-dec and
vlm families raise ``NotImplementedError`` (ROADMAP A10b-4).
The reference's sharding annotations (``lshard``) have no counterpart on
one card.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from . import layers, transformer
from .config import ModelConfig

# the families build_model builds
FAMILIES = ("dense", "moe", "hybrid", "ssm")


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor):
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return (lse - gold).mean(), lse


class Model(nn.Module):
    """Embedding, the layer stack, the final norm, the LM head, and with
    ``cfg.mtp`` the MTP layer and its input projection."""

    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.cfg = cfg
        self.device = device
        self.embed = layers.Embedding(cfg, device, generator)
        self.lm_head = (None if cfg.tie_embeddings
                        else layers.LMHead(cfg, device, generator))
        self.stack = transformer.Stack(cfg, device, generator)
        self.final_norm = layers.zeros_param((cfg.d_model,), cfg.pdtype, device)
        if cfg.mtp:
            self.mtp = transformer.DecoderLayer(
                cfg, ("mla" if cfg.use_mla else "attn", "mlp"), device, generator)
            self.mtp_proj = layers.dense_param((2 * cfg.d_model, cfg.d_model),
                                               cfg.pdtype, device, generator)

    def _backbone(self, tokens, caches=None, positions=None):
        x = self.embed(tokens)
        x, new_caches, aux, dropped = self.stack(x, positions=positions, caches=caches)
        return (layers.rms_norm(x, self.final_norm, self.cfg.norm_eps), new_caches,
                aux, dropped)

    def _head(self, x):
        if self.lm_head is None:
            return x @ self.embed.table.to(self.cfg.cdtype).T
        return self.lm_head(x)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B,S) tokens -> (B,S,V) logits in the compute dtype."""
        return self._head(self._backbone(tokens)[0])

    def apply(self, batch: Dict) -> tuple:
        """(logits, aux) as the reference's ``apply``: ``moe_aux``,
        ``moe_dropped`` and, with MTP (which reads ``batch["targets"]``),
        ``mtp_logits``. (This name shadows ``nn.Module.apply(fn)``, which
        the port does not use.)"""
        x, _, aux, dropped = self._backbone(batch["tokens"])
        out = {"moe_aux": aux, "moe_dropped": dropped}
        if self.cfg.mtp:
            fused = (torch.cat([x, self.embed(batch["targets"])], dim=-1)
                     @ self.mtp_proj.to(self.cfg.cdtype))
            out["mtp_logits"] = self._head(self.mtp(fused)[0])
        return self._head(x), out

    def loss(self, batch: Dict) -> tuple:
        """Cross-entropy plus the reference's z-loss (1e-4 mean lse^2), 1e-2
        of the MoE aux loss and, with MTP, 0.3 of the t+2 cross-entropy
        (targets rolled by one, the last position left out): (total,
        metrics)."""
        logits, aux = self.apply(batch)
        ce, lse = cross_entropy(logits, batch["targets"])
        total = ce + 1e-2 * aux["moe_aux"] + 1e-4 * torch.mean(lse ** 2)
        metrics = {"ce": ce, "moe_aux": aux["moe_aux"],
                   "moe_dropped": aux["moe_dropped"]}
        if self.cfg.mtp:
            t2 = torch.roll(batch["targets"], -1, dims=1)
            mtp_ce, _ = cross_entropy(aux["mtp_logits"][:, :-1], t2[:, :-1])
            total = total + 0.3 * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        return total, metrics

    def init_caches(self, batch: int, max_len: int) -> List:
        """One zeroed cache a layer (KV for attention, latent for MLA, the
        recurrent state for Mamba and RWKV), in layer order, on the model's
        device."""
        return self.stack.init_caches(batch, max_len, self.device)

    @torch.no_grad()
    def prefill(self, batch: Dict, caches: List) -> tuple:
        """The whole prompt through the caches at once; logits of the last
        position. Positions are rotated from 0, as in the reference. A
        Mamba layer steps its state by the prompt's first token only
        (ROADMAP Queue C, LM fault 6), as the reference's does."""
        x, caches, _, _ = self._backbone(batch["tokens"], caches=caches)
        return self._head(x[:, -1:]), caches

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: List, batch=None) -> tuple:
        """(B,1) tokens through the caches (written in place): (logits,
        caches). Like the reference's, it passes no positions, so RoPE
        rotates the new token's keys at position 0 (ROADMAP Queue C)."""
        x, caches, _, _ = self._backbone(token, caches=caches, positions=None)
        return self._head(x), caches


def build_model(cfg: ModelConfig, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None) -> Model:
    """The decoder of ``cfg`` (dense, MoE, hybrid or ssm; with attention,
    MLA, Mamba or RWKV mixers; with or without MTP) with seeded random weights on ``device`` (None means the
    card; ``"meta"`` allocates nothing), frozen. ``generator`` must live
    on that device; None seeds one with 0."""
    if cfg.family not in FAMILIES:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported; the port builds "
            f"{FAMILIES} (ROADMAP A10b-4)")
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    return Model(cfg, dev, generator).eval().requires_grad_(False)
