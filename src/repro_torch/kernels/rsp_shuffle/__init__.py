"""Hierarchical row shuffle (Algorithm 1's randomize step): numpy oracle
(``ref.py``), plain PyTorch version and CUDA kernel (``kernel.py``, source
``csrc/rsp_shuffle.cu``), host-drawn permutations (``ops.py``)."""

from repro_torch.kernels.rsp_shuffle.kernel import (
    LAUNCHES,
    flat_gather_index,
    rsp_shuffle,
    rsp_shuffle_cuda,
    rsp_shuffle_plain,
    shuffle_bytes,
    shuffle_path,
    staged_smem_bytes,
)
from repro_torch.kernels.rsp_shuffle.ops import (
    DEFAULT_SHUFFLE_TILE,
    SHUFFLE_TILES,
    make_permutations,
    partition_permutations,
    randomize_tile,
    rsp_randomize_block,
    rsp_randomize_blocks,
    shuffle_candidates,
    shuffle_config,
)
from repro_torch.kernels.rsp_shuffle.ref import flat_indices, rsp_shuffle_ref

__all__ = [
    "DEFAULT_SHUFFLE_TILE",
    "LAUNCHES",
    "SHUFFLE_TILES",
    "flat_gather_index",
    "flat_indices",
    "make_permutations",
    "partition_permutations",
    "randomize_tile",
    "rsp_randomize_block",
    "rsp_randomize_blocks",
    "rsp_shuffle",
    "rsp_shuffle_cuda",
    "rsp_shuffle_plain",
    "rsp_shuffle_ref",
    "shuffle_bytes",
    "shuffle_candidates",
    "shuffle_config",
    "shuffle_path",
    "staged_smem_bytes",
]
