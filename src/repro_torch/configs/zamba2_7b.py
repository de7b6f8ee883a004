"""zamba2-7b [hybrid]: 81L d_model=3584 32H (MHA kv=32) d_ff=14336
vocab=32000, ssm_state=64 -- Mamba2 stack + shared attention block every 6
layers (one shared block, as the reference configures it: 13 rounds of a
shared-block invocation and 6 Mamba2 layers, then one invocation and 3
layers).  [arXiv:2411.15242, hf:Zyphra/Zamba2-7B]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    conv_kernel=4,
    attn_every=6,
    rope_theta=10000.0,
)
