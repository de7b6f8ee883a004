"""Fused per-block sketch: one pass -> moments + extrema + histogram.

``ops.block_sketch`` dispatches between the numpy oracle (``ref.py``), the
plain PyTorch version and the CUDA kernel (``kernel.py``, source
``csrc/block_sketch.cu``).
"""

from repro_torch.kernels.block_sketch.kernel import (
    LAUNCHES,
    block_sketch_cuda,
    block_sketch_plain,
)
from repro_torch.kernels.block_sketch.ops import IMPLS, block_sketch
from repro_torch.kernels.block_sketch.ref import (
    BlockSketch,
    block_sketch_ref,
    grid_histogram,
    merge_sketches,
)

__all__ = [
    "IMPLS",
    "LAUNCHES",
    "BlockSketch",
    "block_sketch",
    "block_sketch_cuda",
    "block_sketch_plain",
    "block_sketch_ref",
    "grid_histogram",
    "merge_sketches",
]
