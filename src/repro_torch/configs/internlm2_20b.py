"""InternLM2-20B [arXiv:2403.17297; hf] — dense GQA.
Assigned: 48L d_model=6144 48H (kv=8) d_ff=16384 vocab=92544."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=92544,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, num_heads=8, num_kv_heads=2,
        head_dim=8, d_ff=128, vocab_size=256,
        param_dtype="float32", compute_dtype="float32")
