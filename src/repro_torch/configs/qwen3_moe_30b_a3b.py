"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768
(per expert) vocab=151936, MoE 128 experts top-8, qk-norm, head_dim 128.
[hf:Qwen/Qwen3-30B-A3B]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=128,
    d_ff=768,
    vocab_size=151936,
    qk_norm=True,
    num_experts=128,
    num_experts_per_token=8,
    rope_theta=1000000.0,
)
