"""InternVL2-76B [arXiv:2404.16821] — InternViT (STUB: input_specs supplies
projected patch embeddings) + llama3-70b-class language backbone.
Assigned: 80L d_model=8192 64H (kv=8) d_ff=28672 vocab=128256, 256 patches."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab_size=128256,
    num_patches=256,
    rope_theta=500_000.0,
    param_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=8, num_kv_heads=2,
        head_dim=8, d_ff=128, vocab_size=256, num_patches=4,
        param_dtype="float32", compute_dtype="float32")
