"""Jamba-1.5-Large 398B [arXiv:2403.19887; hf] — Mamba+attn 1:7 interleave,
MoE 16e top-2 every other layer. Assigned: 72L d_model=8192 64H (kv=8)
d_ff=24576 vocab=65536. Runs long_500k (hybrid => sub-quadratic)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    attn_period=8,             # 1 attention layer per 8 (1:7)
    moe_num_experts=16,
    moe_top_k=2,
    moe_d_ff=24576,
    moe_layer_period=2,        # every other layer
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=8, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=256, moe_num_experts=4, moe_top_k=2,
        moe_d_ff=64, mamba_d_state=8, mamba_chunk=16,
        param_dtype="float32", compute_dtype="float32")
