"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
(per expert) vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-3b-a800m-base]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    num_experts=40,
    num_experts_per_token=8,
    rope_theta=10000.0,
    tie_embeddings=True,
)
