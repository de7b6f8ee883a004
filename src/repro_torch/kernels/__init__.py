"""The port's kernels: each TPU kernel of the main path as a hand-written
CUDA C++ kernel for ``sm_90a`` (sources in ``repro_torch/csrc/``, built at
first use by :mod:`repro_torch.kernels._cuda`), beside its plain PyTorch
version and a launch counter.

  rsp_shuffle    Algorithm 1's hierarchical row shuffle
  block_sketch   fused per-block moments + histogram
  plan           fused filter / project / group-by sketch

Importing this package imports no kernel: the subpackages load the library
only when a wrapper is called on a CUDA tensor.
"""

from __future__ import annotations


def _counters() -> dict:
    from repro_torch.kernels.block_sketch.kernel import LAUNCHES as block_sketch
    from repro_torch.kernels.plan.kernel import LAUNCHES as plan_sketch
    from repro_torch.kernels.rsp_shuffle.kernel import LAUNCHES as rsp_shuffle

    return {"rsp_shuffle": rsp_shuffle, "block_sketch": block_sketch, "plan_sketch": plan_sketch}


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel so far in this process."""
    return {name: c.value for name, c in _counters().items()}


def reset_launch_counts() -> None:
    for c in _counters().values():
        c.reset()
