"""RWKV6 WKV: the data-dependent-decay linear-attention recurrence of the
RWKV6 family.

``ops.wkv6`` dispatches between the plain PyTorch version (``ref.py``) and
the CUDA kernel (``kernel.py``, source ``csrc/rwkv6_wkv.cu``), and under
grad through ``WKV6``, whose backward is ``csrc/rwkv6_wkv_bwd.cu``.
"""

from repro_torch.kernels.rwkv6_wkv.kernel import (
    BWD_GROUP,
    BWD_KERNELS,
    BWD_LAUNCHES,
    CHUNK,
    KERNELS,
    LAUNCHES,
    bwd_groups,
    wkv6_bwd_cuda,
    wkv6_bwd_plain,
    wkv6_cuda,
    wkv6_plain,
)
from repro_torch.kernels.rwkv6_wkv.ops import IMPLS, WKV6, log_decay, wkv6
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_chunked, wkv6_chunked_bwd, wkv6_scan

__all__ = [
    "BWD_GROUP",
    "BWD_KERNELS",
    "BWD_LAUNCHES",
    "CHUNK",
    "IMPLS",
    "KERNELS",
    "LAUNCHES",
    "WKV6",
    "bwd_groups",
    "log_decay",
    "wkv6",
    "wkv6_bwd_cuda",
    "wkv6_bwd_plain",
    "wkv6_chunked",
    "wkv6_chunked_bwd",
    "wkv6_cuda",
    "wkv6_plain",
    "wkv6_scan",
]
