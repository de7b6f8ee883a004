"""Mamba2 SSD: the chunked selective-state-space scan of the zamba2 hybrid.

``ops.ssd`` dispatches between the plain PyTorch version (``ref.py``) and
the CUDA kernel (``kernel.py``, source ``csrc/mamba2_ssd.cu``), and under
grad through ``SSDScan``, whose backward is ``csrc/mamba2_ssd_bwd.cu``.
"""

from repro_torch.kernels.mamba2_ssd.kernel import (
    BWD_KERNELS,
    BWD_LAUNCHES,
    CHUNK,
    KERNELS,
    LAUNCHES,
    bwd_head_tile,
    head_tile,
    ssd_bwd_cuda,
    ssd_bwd_plain,
    ssd_cuda,
    ssd_plain,
)
from repro_torch.kernels.mamba2_ssd.ops import IMPLS, SSDScan, ssd
from repro_torch.kernels.mamba2_ssd.ref import ssd_chunked, ssd_chunked_bwd, ssd_recurrence

__all__ = [
    "BWD_KERNELS",
    "BWD_LAUNCHES",
    "CHUNK",
    "IMPLS",
    "KERNELS",
    "LAUNCHES",
    "SSDScan",
    "bwd_head_tile",
    "head_tile",
    "ssd",
    "ssd_bwd_cuda",
    "ssd_bwd_plain",
    "ssd_chunked",
    "ssd_chunked_bwd",
    "ssd_cuda",
    "ssd_plain",
    "ssd_recurrence",
]
