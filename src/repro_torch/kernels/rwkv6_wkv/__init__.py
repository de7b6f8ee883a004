"""RWKV6 WKV: the data-dependent-decay linear-attention recurrence of the
RWKV6 family.

``ops.wkv6`` dispatches between the plain PyTorch version (``ref.py``) and
the CUDA kernel (``kernel.py``, source ``csrc/rwkv6_wkv.cu``).
"""

from repro_torch.kernels.rwkv6_wkv.kernel import (
    CHUNK,
    KERNELS,
    LAUNCHES,
    wkv6_cuda,
    wkv6_plain,
)
from repro_torch.kernels.rwkv6_wkv.ops import IMPLS, log_decay, wkv6
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_chunked, wkv6_scan

__all__ = [
    "CHUNK",
    "IMPLS",
    "KERNELS",
    "LAUNCHES",
    "log_decay",
    "wkv6",
    "wkv6_chunked",
    "wkv6_cuda",
    "wkv6_plain",
    "wkv6_scan",
]
