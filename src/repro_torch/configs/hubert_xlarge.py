"""hubert-xlarge [audio]: 48L d_model=1280 16H (MHA kv=16) d_ff=5120
vocab=504 -- encoder-only; the waveform/CNN frontend is a stub
(input_specs provides precomputed frame embeddings).  [arXiv:2106.07447]"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="encoder",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    d_ff=5120,
    vocab_size=504,
    causal=False,
    rope=False,
)
