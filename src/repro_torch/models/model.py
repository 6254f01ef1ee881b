"""Model facade: every family from its ModelConfig.

Port of the JAX package's ``models/model.py`` for the dense family
(tinyllama-1.1b, internlm2-20b, mistral-nemo-12b, stablelm-3b), the MoE
family, with MLA and multi-token prediction (olmoe-1b-7b,
deepseek-v3-671b), the hybrid family (jamba-1.5-large-398b: Mamba layers
with an attention layer in every ``attn_period``), the ssm family
(rwkv6-1.6b: RWKV-6 layers), the vlm family (internvl2-76b: the dense
decoder behind a prefix of patch embeddings) and the encdec family
(whisper-medium, ``EncDecModel``):

    model = build_model(cfg, device="cuda", generator=g)  # seeded weights
    logits, aux = model.apply(batch)                      # forward
    loss, metrics = model.loss(batch)                     # training fwd
    caches = model.init_caches(batch_size, max_len)       # serving
    logits, caches = model.prefill(batch, caches)
    logits, caches = model.decode_step(token, caches, extras)

The model carries its weights and device (the reference passes a params
tree to pure functions; ``convert.params_from_jax`` loads one). Batch
dict: ``tokens`` (B,S) and ``targets`` (B,S) integer tensors, and per
modality ``frames`` (B, S_enc, d_model), the encoder's stub front end,
or ``patches`` (B, P, d_model), the stub vision tower's. ``aux`` holds
the stack's summed MoE aux loss and dropped count (zeros for a dense
stack) and, with ``cfg.mtp``, the multi-token-prediction logits: one
more layer over ``cat([h_t, embed(target_t)]) @ mtp_proj`` predicts
token t+2, and ``loss`` adds 0.3 of its cross-entropy.
``build_model`` returns the weights frozen (``requires_grad`` off), so
``apply`` and ``loss`` build no graph; ``training.train_loop`` turns
gradients on and differentiates ``loss``. ``prefill`` and
``decode_step`` (serving) always run without autograd.

On a mesh (``shard_model``, then ``distributed.sharding.use_rules``),
``apply`` and ``loss`` take the global batch on every rank, keep this
rank's rows of it and run the layers on this rank's parameter blocks;
the layers make the collectives the reference's ``lshard`` constraints
imply (``distributed.spmd``), and ``loss`` returns the global loss and
metrics on every rank. ``apply``'s logits are this rank's rows. Every
family trains there: attention, MLA, Mamba and RWKV mixers, MLP and MoE
FFNs, MTP (its projection replicated, its logits through the same
vocab-parallel head, its cross-entropy averaged as ``ce`` is) and the
encoder-decoder. Serving on the mesh (``prefill``, ``decode_step``)
waits for ROADMAP A10b-6b.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..distributed import sharding, spmd
from . import encdec, layers, transformer
from .config import ModelConfig


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

    def _backbone(self, tokens, extra=None, caches=None, positions=None, x=None):
        """``extra`` (the vlm's patch embeddings) is cast to the compute
        dtype and put ahead of the token embeddings; ``x``, when given, is
        those embeddings already looked up."""
        if x is None:
            x = self.embed(spmd.batch_rows(tokens))
        if extra is not None:
            x = torch.cat([spmd.batch_rows(extra).to(self.cfg.cdtype), x], dim=1)
        x, new_caches, aux, dropped = self.stack(x, positions=positions, caches=caches)
        return (layers.rms_norm(x, spmd.weight(self.final_norm), self.cfg.norm_eps),
                new_caches, aux, dropped)

    def _head(self, x):
        if self.lm_head is None:
            return layers.vocab_logits(x, self.embed.table, 0, self.cfg)
        return self.lm_head(x)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B,S) tokens -> (B,S,V) logits in the compute dtype."""
        return self._head(self._backbone(tokens)[0])

    def apply(self, batch: Dict) -> tuple:
        """(logits, aux) as the reference's ``apply``: ``moe_aux``,
        ``moe_dropped`` and, with MTP (which reads ``batch["targets"]``),
        ``mtp_logits``. With ``batch["patches"]`` the patch rows go
        through the stack (RoPE positions run over patches and tokens) and
        are cut before the head. (This name shadows ``nn.Module.apply(fn)``,
        which the port does not use.)"""
        extra = batch.get("patches")
        if not self.cfg.mtp:
            x, _, aux, dropped = self._backbone(batch["tokens"], extra)
            if extra is not None:
                x = x[:, extra.shape[1]:]
            return self._head(x), {"moe_aux": aux, "moe_dropped": dropped}
        # the tokens and the targets looked up at once, and the two heads
        # taken at once: on a mesh the table and the head are gathered
        # once a step, not twice
        rows = spmd.batch_rows(batch["tokens"])
        emb, emb_next = self.embed(torch.cat([rows, spmd.batch_rows(batch["targets"])])
                                   ).split(rows.shape[0])
        x, _, aux, dropped = self._backbone(None, extra, x=emb)
        if extra is not None:
            x = x[:, extra.shape[1]:]
        fused = (torch.cat([x, emb_next], dim=-1)
                 @ spmd.weight(self.mtp_proj).to(self.cfg.cdtype))
        logits, mtp_logits = self._head(torch.cat([x, self.mtp(fused)[0]])).split(x.shape[0])
        return logits, {"moe_aux": aux, "moe_dropped": dropped, "mtp_logits": mtp_logits}

    def loss(self, batch: Dict) -> tuple:
        """Cross-entropy plus the reference's z-loss (1e-4 mean lse^2), 1e-2
        of the MoE aux loss and, with MTP, 0.3 of the t+2 cross-entropy
        (targets rolled by one, the last position left out): (total,
        metrics)."""
        logits, aux = self.apply(batch)
        ce, lse = cross_entropy(logits, spmd.batch_rows(batch["targets"]))
        ce = spmd.batch_mean(ce)
        total = ce + 1e-2 * aux["moe_aux"] + 1e-4 * spmd.batch_mean(torch.mean(lse ** 2))
        metrics = {"ce": ce, "moe_aux": aux["moe_aux"],
                   "moe_dropped": aux["moe_dropped"]}
        if self.cfg.mtp:
            t2 = torch.roll(spmd.batch_rows(batch["targets"]), -1, dims=1)
            mtp_ce, _ = cross_entropy(aux["mtp_logits"][:, :-1], t2[:, :-1])
            mtp_ce = spmd.batch_mean(mtp_ce)
            total = total + 0.3 * mtp_ce
            metrics["mtp_ce"] = mtp_ce
        return total, metrics

    def stacked(self, name: str) -> bool:
        """Whether parameter ``name``'s leaf carries the stack axis in the
        reference's tree (a layer of a scanned unit)."""
        parts = name.split(".")
        return parts[:2] == ["stack", "layers"] and self.stack.stacked(int(parts[2]))

    def init_caches(self, batch: int, max_len: int, device=None) -> List:
        """One zeroed cache a layer (KV for attention, latent for MLA, the
        recurrent state for Mamba and RWKV), in layer order, on ``device``
        (None: the model's)."""
        return self.stack.init_caches(batch, max_len,
                                      self.device if device is None else device)

    @torch.no_grad()
    def prefill(self, batch: Dict, caches: List) -> tuple:
        """The whole prompt (after ``batch["patches"]``, if given) through
        the caches at once; logits of the last position. Positions are
        rotated from 0, as in the reference. A Mamba layer steps its state
        by the prompt's first token only (ROADMAP Queue C, LM fault 6), as
        the reference's does."""
        _no_mesh("prefill")
        x, caches, _, _ = self._backbone(batch["tokens"], batch.get("patches"),
                                         caches=caches)
        return self._head(x[:, -1:]), caches

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: List, batch=None) -> tuple:
        """(B,1) tokens through the caches (written in place): (logits,
        caches). Like the reference's, it passes no positions, so RoPE
        rotates the new token's keys at position 0 (ROADMAP Queue C), and
        takes no patches."""
        _no_mesh("decode_step")
        x, caches, _, _ = self._backbone(token, caches=caches, positions=None)
        return self._head(x), caches


def _no_mesh(what: str):
    if sharding.active_rules() is not None:
        raise NotImplementedError(f"{what} on the mesh (serving) waits for "
                                  f"ROADMAP A10b-6b")


def shard_model(model, rules: sharding.ShardingRules):
    """Keep this rank's block of each of ``model``'s parameters
    (``sharding.shard_params``; every rank built the same weights) for
    runs under ``use_rules(rules)``; returns the specs."""
    return sharding.shard_params(model, rules)


class EncDecModel(encdec.EncDec):
    """The encdec family behind the facade (the reference's
    ``_encdec_model``). ``apply`` encodes ``batch["frames"]`` and decodes
    ``batch["tokens"]`` teacher-forced; ``loss`` is the cross-entropy
    alone. ``prefill`` encodes the frames and runs one decode step on the
    prompt's last token only, so the earlier prompt tokens never reach
    the caches (ROADMAP Queue C, LM fault 7); it does not return the
    encoder output, which ``decode_step`` reads from
    ``batch["enc_out"]`` (``encode`` computes it). The ``ServingEngine``
    passes no batch, so it cannot serve this family (LM fault 8)."""

    def stacked(self, name: str) -> bool:
        """Every encoder and decoder leaf: the reference stacks both
        whatever ``scan_layers`` says."""
        return name.split(".")[0] in ("enc", "dec")

    def apply(self, batch: Dict) -> tuple:
        """Under rules, on this rank's rows of the frames and tokens."""
        logits = self.decode_train(spmd.batch_rows(batch["tokens"]),
                                   self.encode(spmd.batch_rows(batch["frames"])))
        return logits, {"moe_aux": torch.zeros((), dtype=torch.float32, device=self.device),
                        "moe_dropped": torch.zeros((), dtype=torch.int32,
                                                   device=self.device)}

    def loss(self, batch: Dict) -> tuple:
        """(ce, {"ce": ce}): no z-loss and no aux term."""
        ce, _ = cross_entropy(self.apply(batch)[0], spmd.batch_rows(batch["targets"]))
        ce = spmd.batch_mean(ce)
        return ce, {"ce": ce}

    def init_caches(self, batch: int, max_len: int, device=None) -> List:
        return self.init_dec_caches(batch, max_len, device)

    @torch.no_grad()
    def prefill(self, batch: Dict, caches: List) -> tuple:
        _no_mesh("prefill")
        return self.decode(batch["tokens"][:, -1:], self.encode(batch["frames"]), caches)

    @torch.no_grad()
    def decode_step(self, token: torch.Tensor, caches: List, batch=None) -> tuple:
        _no_mesh("decode_step")
        return self.decode(token, batch["enc_out"], caches)


def build_model(cfg: ModelConfig, device: DeviceLike = None,
                generator: Optional[torch.Generator] = None):
    """The model of ``cfg`` (a ``Model``: dense, MoE, hybrid, ssm or vlm,
    with attention, MLA, Mamba or RWKV mixers, with or without MTP; an
    ``EncDecModel`` for encdec) with seeded random weights on ``device``
    (None means the card; ``"meta"`` allocates nothing), frozen.
    ``generator`` must live on that device; None seeds one with 0."""
    dev = resolve_device(device)
    if generator is None and dev.type != "meta":
        generator = torch.Generator(device=dev).manual_seed(0)
    cls = EncDecModel if cfg.family == "encdec" else Model
    return cls(cfg, dev, generator).eval().requires_grad_(False)
