"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407] — dense GQA,
128k ctx. Assigned: 40L d_model=5120 32H (kv=8) d_ff=14336 vocab=131072."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=8, num_kv_heads=2,
        head_dim=8, d_ff=128, vocab_size=256,
        param_dtype="float32", compute_dtype="float32")
