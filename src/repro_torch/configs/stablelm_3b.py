"""StableLM-3B [hf:stabilityai/stablelm-2-1_6b family] — dense MHA.
Assigned: 32L d_model=2560 32H (kv=32) d_ff=6912 vocab=50304."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50304,
    rope_theta=10_000.0,
    param_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=8, num_kv_heads=8,
        head_dim=8, d_ff=128, vocab_size=256,
        param_dtype="float32", compute_dtype="float32")
