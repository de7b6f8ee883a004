"""rwkv6-1.6b [ssm]: 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536 -- Finch: data-dependent per-channel decay linear attention,
32 heads of 64, low-rank (32) ddlerp and decay.  [arXiv:2404.05892]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="rwkv",
    num_layers=24,
    d_model=2048,
    num_heads=32,          # d_model / rwkv_head_dim
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    rwkv_head_dim=64,
    rope=False,
)
