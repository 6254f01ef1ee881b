"""DeepSeek-V3 671B [arXiv:2412.19437; hf] — MLA, 1 shared + 256 routed
top-8, MTP. Assigned: 61L d_model=7168 128H d_ff(expert)=2048 vocab=129280.
First 3 layers use a dense FFN (18432) per the HF config."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,          # MLA: latent-compressed, heads share the latent
    head_dim=128,
    d_ff=18432,                # dense FFN of the first 3 layers
    vocab_size=129280,
    moe_num_experts=256,
    moe_top_k=8,
    moe_shared_experts=1,
    moe_d_ff=2048,
    moe_layer_period=1,
    moe_first_dense=3,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    rope_head_dim=64,
    nope_head_dim=128,
    v_head_dim=128,
    mtp=True,
    rope_theta=10_000.0,
    param_dtype="bfloat16",
)


def reduced() -> ModelConfig:
    import dataclasses
    return dataclasses.replace(
        CONFIG, num_layers=5, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=256, moe_num_experts=8, moe_top_k=2,
        moe_d_ff=32, moe_first_dense=2, q_lora_rank=32, kv_lora_rank=16,
        rope_head_dim=8, nope_head_dim=16, v_head_dim=16,
        param_dtype="float32", compute_dtype="float32")
