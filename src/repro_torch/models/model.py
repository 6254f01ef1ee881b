"""Model facade: the dense decoder from its ModelConfig.

Port of the JAX package's ``models/model.py`` for the dense family
(tinyllama-1.1b, internlm2-20b, mistral-nemo-12b, stablelm-3b):

    model = build_model(cfg, device="cuda", generator=g)  # seeded weights
    logits, aux = model.apply(batch)                      # forward
    loss, metrics = model.loss(batch)                     # training fwd
    caches = model.init_caches(batch_size, max_len)       # serving
    logits, caches = model.prefill(batch, caches)
    logits, caches = model.decode_step(token, caches)

The model carries its weights and device (the reference passes a params
tree to pure functions; ``convert.params_from_jax`` loads one). Batch
dict: ``tokens`` (B,S) and ``targets`` (B,S) integer tensors.
``build_model`` returns the weights frozen (``requires_grad`` off), so
``apply`` and ``loss`` build no graph; ``training.train_loop`` turns
gradients on and differentiates ``loss``. ``prefill`` and
``decode_step`` (serving) always run without autograd. Multi-token prediction, MoE, MLA, hybrid, ssm, enc-dec and vlm raise
``NotImplementedError`` (ROADMAP A10b). The reference's sharding
annotations (``lshard``) have no counterpart on one card.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from . import layers, transformer
from .config import ModelConfig


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor):
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return (lse - gold).mean(), lse


class Model(nn.Module):
    """Embedding, the layer stack, the final norm and the LM head."""

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

    def _backbone(self, tokens, caches=None, positions=None):
        x = self.embed(tokens)
        x, new_caches = self.stack(x, positions=positions, caches=caches)
        return layers.rms_norm(x, self.final_norm, self.cfg.norm_eps), new_caches

    def _head(self, x):
        if self.lm_head is None:
            return x @ self.embed.table.to(self.cfg.cdtype).T
        return self.lm_head(x)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B,S) tokens -> (B,S,V) logits in the compute dtype."""
        x, _ = self._backbone(tokens)
        return self._head(x)

    def apply(self, batch: Dict) -> tuple:
        """(logits, aux) as the reference's ``apply``; a dense model's MoE
        aux loss and dropped count are zeros. (This name shadows
        ``nn.Module.apply(fn)``, which the port does not use.)"""
        logits = self(batch["tokens"])
        zero = torch.zeros((), device=logits.device)
        return logits, {"moe_aux": zero,
                        "moe_dropped": torch.zeros((), dtype=torch.int32,
                                                   device=logits.device)}

    def loss(self, batch: Dict) -> tuple:
        """Cross-entropy plus the reference's z-loss (1e-4 mean lse^2) and
        MoE aux term (zero here): (total, metrics)."""
        logits, aux = self.apply(batch)
        ce, lse = cross_entropy(logits, batch["targets"])
        total = ce + 1e-2 * aux["moe_aux"] + 1e-4 * torch.mean(lse ** 2)
        return total, {"ce": ce, "moe_aux": aux["moe_aux"],
                       "moe_dropped": aux["moe_dropped"]}

    def init_caches(self, batch: int, max_len: int) -> List:
        """One zeroed KV cache a layer, in layer order, on the model's device."""
        return self.stack.init_caches(batch, max_len, self.device)

    @torch.no_grad()
    def prefill(self, batch: Dict, caches: List) -> tuple:
        """The whole prompt through the caches at once; logits of the last
        position. Positions are rotated from 0, as in the reference."""
        x, caches = self._backbone(batch["tokens"], caches=caches)
        return self._head(x[:, -1:]), caches

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: List, batch=None) -> tuple:
        """(B,1) tokens through the caches (written in place): (logits,
        caches). Like the reference's, it passes no positions, so RoPE
        rotates the new token at position 0 (ROADMAP Queue C)."""
        x, caches = self._backbone(token, caches=caches, positions=None)
        return self._head(x), caches


def build_model(cfg: ModelConfig, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None) -> Model:
    """The dense decoder of ``cfg`` with seeded random weights on
    ``device`` (None means the card; ``"meta"`` allocates nothing), frozen.
    ``generator`` must live on that device; None seeds one with 0."""
    if cfg.family != "dense" or cfg.mtp or cfg.use_mla or cfg.moe_num_experts:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (mtp={cfg.mtp}, mla={cfg.use_mla}, "
            f"experts={cfg.moe_num_experts}) is not ported; the port builds the "
            "dense decoder only (ROADMAP A10b)")
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    return Model(cfg, dev, generator).eval().requires_grad_(False)
