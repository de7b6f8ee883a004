"""Flash attention: online-softmax attention with grouped-query heads.

``ops.flash_attention`` dispatches between the plain PyTorch version
(``ref.py``) and the CUDA kernel (``kernel.py``, source
``csrc/flash_attention.cu``).
"""

from repro_torch.kernels.flash_attention.kernel import (
    HEAD_DIMS,
    LAUNCHES,
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.flash_attention.ops import IMPLS, flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

__all__ = [
    "HEAD_DIMS",
    "IMPLS",
    "LAUNCHES",
    "flash_attention",
    "flash_attention_cuda",
    "flash_attention_plain",
    "flash_attention_ref",
]
