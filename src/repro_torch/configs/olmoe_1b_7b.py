"""OLMoE-1B-7B [arXiv:2409.02060; hf] — 64 experts top-8, every layer MoE.
Assigned: 16L d_model=2048 16H (kv=16) d_ff(expert)=1024 vocab=50304."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    num_layers=16,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50304,
    moe_num_experts=64,
    moe_top_k=8,
    moe_d_ff=1024,
    moe_layer_period=1,
    rope_theta=10_000.0,
    param_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=64, vocab_size=256, moe_num_experts=8, moe_top_k=2,
        moe_d_ff=32, param_dtype="float32", compute_dtype="float32")
