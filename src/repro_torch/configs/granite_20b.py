"""granite-20b [dense]: 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152 -- code model (GPT-BigCode lineage: MQA + 2-matrix GELU MLP;
the 2-matrix MLP is what lands the parameter count at ~20B).
[arXiv:2405.04324]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    family="dense",
    num_layers=52,
    d_model=6144,
    num_heads=48,
    num_kv_heads=1,
    d_ff=24576,
    vocab_size=49152,
    mlp_type="gelu",
    rope_theta=10000.0,
)
