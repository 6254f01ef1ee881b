"""Unified model configuration covering all 10 assigned architectures.

Port of the JAX package's ``models/config.py``: the same fields, defaults
and parameter counts; the dtype names map to torch dtypes. ``remat``,
``scan_layers`` and ``moe_impl`` are kept so that configs compare field
for field; the port's eager stack does not read them.
"""
from __future__ import annotations

import dataclasses

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # --- MoE ---
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_shared_experts: int = 0
    moe_d_ff: int = 0
    moe_layer_period: int = 1     # every k-th layer is MoE (1 = all)
    moe_first_dense: int = 0      # first k layers use a dense FFN
    capacity_factor: float = 1.25
    moe_impl: str = "psum"        # "psum" (partial-sum EP) | "a2a" (optimized)

    # --- MLA (DeepSeek) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    rope_head_dim: int = 0
    nope_head_dim: int = 0
    v_head_dim: int = 0
    mtp: bool = False             # multi-token-prediction auxiliary head

    # --- hybrid (Jamba) ---
    attn_period: int = 0          # one attention layer per k layers (0 = all attn)
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_chunk: int = 256

    # --- rwkv ---
    rwkv_head_dim: int = 64
    rwkv_impl: str = "scan"     # "scan" (step recurrence) | "chunked" (§Perf)
    rwkv_chunk: int = 64

    # --- enc-dec (whisper) ---
    encoder_layers: int = 0
    decoder_layers: int = 0
    encoder_seq_ratio: int = 1    # encoder frames per decoder token (shape spec)

    # --- vlm ---
    num_patches: int = 0          # prepended stub patch embeddings

    # --- common ---
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"

    # --- runtime / perf knobs (hillclimbed in §Perf) ---
    remat: str = "full"           # none | full | selective
    scan_layers: bool = True
    attn_impl: str = "auto"       # dense | chunked | auto (chunked >= this len)
    attn_chunk_threshold: int = 8192
    attn_chunk_size: int = 1024

    @property
    def pdtype(self):
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self):
        return _DTYPES[self.compute_dtype]

    @property
    def q_dim(self) -> int:
        if self.use_mla:
            return self.num_heads * (self.nope_head_dim + self.rope_head_dim)
        return self.num_heads * self.head_dim

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe_num_experts == 0:
            return False
        if layer_idx < self.moe_first_dense:
            return False
        return (layer_idx - self.moe_first_dense) % self.moe_layer_period == 0

    def is_attn_layer(self, layer_idx: int) -> bool:
        """Hybrid archs: attention every `attn_period` layers, else mamba."""
        if self.family != "hybrid":
            return True
        return layer_idx % self.attn_period == (self.attn_period - 1) // 2

    def active_params(self) -> int:
        """~Active parameter count (MoE counts top_k+shared experts)."""
        return _count_params(self, active_only=True)

    def total_params(self) -> int:
        return _count_params(self, active_only=False)


def _ffn_params(d_model: int, d_ff: int) -> int:
    return 3 * d_model * d_ff  # SwiGLU: gate, up, down


def _count_params(cfg: ModelConfig, active_only: bool) -> int:
    total = cfg.vocab_size * cfg.d_model  # embedding
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * cfg.d_model
    if cfg.family == "encdec":
        layers = [("attn", "ffn")] * cfg.encoder_layers
        layers += [("attn", "cross", "ffn")] * cfg.decoder_layers
        for parts in layers:
            for p in parts:
                if p in ("attn", "cross"):
                    total += cfg.d_model * (cfg.num_heads * cfg.head_dim) * 2
                    total += cfg.d_model * (cfg.num_kv_heads * cfg.head_dim) * 2
                else:
                    total += 2 * cfg.d_model * cfg.d_ff  # whisper MLP (gelu)
        return total
    for li in range(cfg.num_layers):
        if cfg.family == "ssm":
            d_att = cfg.d_model
            total += 6 * cfg.d_model * d_att + 2 * cfg.d_model  # rwkv blocks, approx
            total += _ffn_params(cfg.d_model, cfg.d_ff)
            continue
        if cfg.is_attn_layer(li):
            if cfg.use_mla:
                total += cfg.d_model * cfg.q_lora_rank
                total += cfg.q_lora_rank * cfg.q_dim
                total += cfg.d_model * (cfg.kv_lora_rank + cfg.rope_head_dim)
                total += cfg.kv_lora_rank * cfg.num_heads * (cfg.nope_head_dim + cfg.v_head_dim)
                total += cfg.num_heads * cfg.v_head_dim * cfg.d_model
            else:
                total += cfg.d_model * cfg.num_heads * cfg.head_dim * 2
                total += cfg.d_model * cfg.num_kv_heads * cfg.head_dim * 2
        else:  # mamba layer
            d_inner = cfg.mamba_expand * cfg.d_model
            total += 2 * cfg.d_model * d_inner + d_inner * cfg.mamba_d_state * 2
            total += d_inner * cfg.d_model
        if cfg.is_moe_layer(li):
            n_exp = (cfg.moe_top_k + cfg.moe_shared_experts if active_only
                     else cfg.moe_num_experts + cfg.moe_shared_experts)
            total += n_exp * _ffn_params(cfg.d_model, cfg.moe_d_ff)
            total += cfg.d_model * cfg.moe_num_experts  # router
        else:
            total += _ffn_params(cfg.d_model, cfg.d_ff)
    return total
