"""Model configuration: the fields the dense decoder, the MoE decoder, the
zamba2 hybrid, the RWKV6 and the encoder families read, and the
reference's execution switches of training: ``remat`` (each layer's
activations recomputed in the backward), ``k_block`` (the plain flash
backward's key block), ``flat_attention`` (the flat-head layout) and
``loss_seq_chunks`` (the cross entropy streamed over sequence chunks).

The reference's ``use_pallas`` switch has no counterpart: attention, the
SSD scan and the WKV take their kernels whenever their tensors are on the
card.
"""

from __future__ import annotations

import dataclasses

from repro_torch.models.attention import AttentionConfig
from repro_torch.models.mamba2 import Mamba2Config
from repro_torch.models.moe import MoEConfig
from repro_torch.models.rwkv6 import RWKV6Config


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | rwkv | encoder
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
    # MoE
    num_experts: int = 0
    num_experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # SSM / hybrid (zamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_kernel: int = 4
    ssm_chunk: int = 128
    attn_every: int = 0         # hybrid: shared attn block period
    # rwkv
    rwkv_head_dim: int = 64
    lora_rank: int = 32
    # execution
    remat: bool = True
    k_block: int = 512          # flash kv-block (the plain backward's)
    # beyond-paper perf flags (the reference's; its baseline keeps all off)
    flat_attention: bool = False   # flat-head layout (K/V expanded to H)
    loss_seq_chunks: int = 0       # seq-chunked CE (stream fp32 logits)
    moe_sort_dispatch: bool = False  # argsort capacity positions

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
            k_block=self.k_block,
            flat=self.flat_attention,
        )

    def moe_config(self) -> MoEConfig:
        return MoEConfig(
            d_model=self.d_model,
            d_ff=self.d_ff,
            num_experts=self.num_experts,
            top_k=self.num_experts_per_token,
            capacity_factor=self.moe_capacity_factor,
            sort_dispatch=self.moe_sort_dispatch,
        )

    def mamba_config(self) -> Mamba2Config:
        return Mamba2Config(
            d_model=self.d_model,
            d_state=self.ssm_state,
            head_dim=self.ssm_head_dim,
            expand=self.ssm_expand,
            conv_kernel=self.conv_kernel,
            chunk=self.ssm_chunk,
            norm_eps=self.norm_eps,
        )

    def rwkv_config(self) -> RWKV6Config:
        return RWKV6Config(
            d_model=self.d_model,
            d_ff=self.d_ff,
            head_dim=self.rwkv_head_dim,
            lora_rank=self.lora_rank,
            norm_eps=self.norm_eps,
        )
