"""chameleon-34b [vlm]: 48L d_model=8192 64H (GQA kv=8) d_ff=22016
vocab=65536 -- early-fusion: VQ image tokens share the text vocabulary, so
the backbone is a dense decoder and the VQ tokenizer frontend is a stub
(input_specs provides token ids).  Uses qk-norm per the paper.
[arXiv:2405.09818]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="dense",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
    rope_theta=10000.0,
)
