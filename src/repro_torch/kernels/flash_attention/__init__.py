"""Flash attention: online-softmax attention with grouped-query heads, and
its gradient.

``ops.flash_attention`` dispatches between the plain PyTorch versions
(``ref.py``) and the CUDA kernels (``kernel.py``, sources
``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``), through
``ops.FlashAttention`` when a gradient is wanted.
"""

from repro_torch.kernels.flash_attention.kernel import (
    BWD_KERNELS,
    BWD_LAUNCHES,
    HEAD_DIMS,
    LAUNCHES,
    flash_attention_bwd_cuda,
    flash_attention_bwd_plain,
    flash_attention_cuda,
    flash_attention_plain,
    flash_attention_stats,
    flash_bwd_work,
    flash_work,
)
from repro_torch.kernels.flash_attention.ops import IMPLS, FlashAttention, flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref, log_sum_exp

__all__ = [
    "BWD_KERNELS",
    "BWD_LAUNCHES",
    "FlashAttention",
    "HEAD_DIMS",
    "IMPLS",
    "LAUNCHES",
    "flash_attention",
    "flash_attention_bwd_cuda",
    "flash_attention_bwd_plain",
    "flash_attention_cuda",
    "flash_attention_plain",
    "flash_attention_ref",
    "flash_attention_stats",
    "flash_bwd_work",
    "flash_work",
    "log_sum_exp",
]
