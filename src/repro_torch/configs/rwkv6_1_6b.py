"""RWKV-6 "Finch" 1.6B [arXiv:2404.05892] — attention-free, data-dependent
decay. Assigned: 24L d_model=2048 d_ff=7168 vocab=65536.
Runs long_500k (O(1)-state decode)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,              # 2048 / 64 rwkv heads
    num_kv_heads=32,
    head_dim=64,
    rwkv_head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    param_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, rwkv_head_dim=16, d_ff=128, vocab_size=256,
        param_dtype="float32", compute_dtype="float32")
