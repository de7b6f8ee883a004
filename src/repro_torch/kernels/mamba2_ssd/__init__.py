"""Mamba2 SSD: the chunked selective-state-space scan of the zamba2 hybrid.

``ops.ssd`` dispatches between the plain PyTorch version (``ref.py``) and
the CUDA kernel (``kernel.py``, source ``csrc/mamba2_ssd.cu``).
"""

from repro_torch.kernels.mamba2_ssd.kernel import (
    CHUNK,
    KERNELS,
    LAUNCHES,
    head_tile,
    ssd_cuda,
    ssd_plain,
)
from repro_torch.kernels.mamba2_ssd.ops import IMPLS, ssd
from repro_torch.kernels.mamba2_ssd.ref import ssd_chunked, ssd_recurrence

__all__ = [
    "CHUNK",
    "IMPLS",
    "KERNELS",
    "LAUNCHES",
    "head_tile",
    "ssd",
    "ssd_chunked",
    "ssd_cuda",
    "ssd_plain",
    "ssd_recurrence",
]
