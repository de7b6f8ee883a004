"""Architecture registry of the port: the configs it can build, their
reduced smoke variants, and the shape cells.

``ARCHS`` holds the reference's ten architectures at their published
widths: the five dense decoders (llama3.2-1b, qwen2-0.5b, qwen3-14b,
granite-20b, chameleon-34b), the two MoE decoders (granite-moe-3b-a800m,
qwen3-moe-30b-a3b), the zamba2-7b hybrid, rwkv6-1.6b and the hubert-xlarge
encoder; ``smoke_config`` shrinks them exactly as the reference's does.
``cells()`` lists the (arch, shape) pairs a dry run covers, as the
reference's does: ``long_500k`` only for the sub-quadratic archs
(``SUBQUADRATIC``), no decode shape for the encoder.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.chameleon_34b import CONFIG as CHAMELEON_34B
from repro_torch.configs.granite_20b import CONFIG as GRANITE_20B
from repro_torch.configs.granite_moe_3b_a800m import CONFIG as GRANITE_MOE
from repro_torch.configs.hubert_xlarge import CONFIG as HUBERT_XL
from repro_torch.configs.llama3_2_1b import CONFIG as LLAMA32_1B
from repro_torch.configs.qwen2_0_5b import CONFIG as QWEN2_05B
from repro_torch.configs.qwen3_14b import CONFIG as QWEN3_14B
from repro_torch.configs.qwen3_moe_30b_a3b import CONFIG as QWEN3_MOE
from repro_torch.configs.rwkv6_1_6b import CONFIG as RWKV6_1_6B
from repro_torch.configs.shapes import SHAPES, ShapeCell
from repro_torch.configs.zamba2_7b import CONFIG as ZAMBA2_7B
from repro_torch.models.config import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    # the reference's order, which cells() and the dry run's tables follow
    c.name: c for c in [LLAMA32_1B, GRANITE_20B, QWEN3_14B, QWEN2_05B, ZAMBA2_7B, CHAMELEON_34B,
                        GRANITE_MOE, QWEN3_MOE, RWKV6_1_6B, HUBERT_XL]
}

# archs allowed to run the long_500k decode cell (sub-quadratic context)
SUBQUADRATIC = {"zamba2-7b", "rwkv6-1.6b"}


def cell_applicable(arch: str, shape: str) -> tuple[bool, str]:
    """Whether the (arch, shape) cell runs, and why not."""
    cfg = ARCHS[arch]
    cell = SHAPES[shape]
    if cfg.family == "encoder" and cell.kind == "decode":
        return False, "encoder-only: no decode step"
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, "full-attention arch: long_500k restricted to SSM/hybrid"
    return True, ""


def cells() -> list[tuple[str, str]]:
    """All applicable (arch, shape) dry-run cells, in the reference's order."""
    return [(arch, shape) for arch in ARCHS for shape in SHAPES
            if cell_applicable(arch, shape)[0]]


def smoke_config(arch: str) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests (the reference's
    shrink)."""
    cfg = ARCHS[arch]
    shrink: dict = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads < cfg.num_heads else 4,
        head_dim=16,
        d_ff=96,
        vocab_size=256,
        k_block=16,
    )
    if cfg.family == "moe":
        # ample capacity so smoke decode-vs-forward comparisons see no drops
        shrink.update(num_experts=8, num_experts_per_token=2, d_ff=32, moe_capacity_factor=8.0)
    if cfg.family == "hybrid":
        # exercise the epilogue: 5 layers, shared attn every 2 -> 2 rounds + 1
        shrink.update(num_layers=5, attn_every=2, ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    if cfg.family == "rwkv":
        shrink.update(rwkv_head_dim=16, lora_rank=8, num_heads=4, num_kv_heads=4)
    return dataclasses.replace(cfg, **shrink)


__all__ = ["ARCHS", "SHAPES", "SUBQUADRATIC", "ShapeCell", "cell_applicable", "cells",
           "smoke_config"]
