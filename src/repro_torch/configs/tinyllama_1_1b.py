"""TinyLlama-1.1B [arXiv:2401.02385; hf] — llama2-arch small.
Assigned: 22L d_model=2048 32H (kv=4) d_ff=5632 vocab=32000."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32000,
    rope_theta=10_000.0,
    param_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=8, num_kv_heads=2,
        head_dim=8, d_ff=128, vocab_size=256,
        param_dtype="float32", compute_dtype="float32")
