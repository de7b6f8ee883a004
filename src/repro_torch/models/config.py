"""Model configuration: the fields the dense decoder family reads.

The reference's MoE, SSM-hybrid, RWKV and encoder fields (and its
``use_pallas`` switch: here attention takes the kernel whenever its
tensors are on the card) come with the families that read them.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.attention import AttentionConfig


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense (moe | hybrid | rwkv | encoder not ported yet)
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // num_heads
    qk_norm: bool = False
    qkv_bias: bool = False
    mlp_type: str = "swiglu"    # swiglu | gelu
    rope: bool = True
    rope_theta: float = 500000.0
    causal: bool = True
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def attention_config(self) -> AttentionConfig:
        return AttentionConfig(
            d_model=self.d_model,
            num_heads=self.num_heads,
            num_kv_heads=self.num_kv_heads,
            head_dim=self.resolved_head_dim,
            qk_norm=self.qk_norm,
            qkv_bias=self.qkv_bias,
            rope=self.rope,
            rope_theta=self.rope_theta,
            causal=self.causal,
            norm_eps=self.norm_eps,
        )
