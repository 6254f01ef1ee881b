"""Whisper-medium [arXiv:2212.04356] — enc-dec; conv frontend is a STUB
(input_specs supplies precomputed frame embeddings). Assigned: 24L
d_model=1024 16H d_ff=4096 vocab=51865. Decoder token length is
seq_len // 8 of the assigned shape (frames dominate whisper sequences);
decoder positions are extended past 448 to cover assigned shapes."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=48,            # 24 encoder + 24 decoder
    encoder_layers=24,
    decoder_layers=24,
    encoder_seq_ratio=8,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51865,
    tie_embeddings=True,
    param_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=4, encoder_layers=2, decoder_layers=2, d_model=64,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, vocab_size=256,
        param_dtype="float32", compute_dtype="float32")
