"""Hierarchical row shuffle (Algorithm 1's randomize step): numpy oracle
(``ref.py``), plain PyTorch version and CUDA kernel (``kernel.py``, source
``csrc/rsp_shuffle.cu``), host-drawn permutations (``ops.py``)."""

from repro_torch.kernels.rsp_shuffle.kernel import (
    LAUNCHES,
    flat_gather_index,
    rsp_shuffle,
    rsp_shuffle_cuda,
    rsp_shuffle_plain,
)
from repro_torch.kernels.rsp_shuffle.ops import (
    make_permutations,
    partition_permutations,
    rsp_randomize_blocks,
)
from repro_torch.kernels.rsp_shuffle.ref import flat_indices, rsp_shuffle_ref

__all__ = [
    "LAUNCHES",
    "flat_gather_index",
    "flat_indices",
    "make_permutations",
    "partition_permutations",
    "rsp_randomize_blocks",
    "rsp_shuffle",
    "rsp_shuffle_cuda",
    "rsp_shuffle_plain",
    "rsp_shuffle_ref",
]
