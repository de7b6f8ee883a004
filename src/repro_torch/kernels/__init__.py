"""The port's kernels: each TPU kernel of the main path as a hand-written
CUDA C++ kernel for ``sm_90a`` (sources in ``repro_torch/csrc/``, built at
first use by :mod:`repro_torch.kernels._cuda`), beside its plain PyTorch
version and a launch counter.

  rsp_shuffle    Algorithm 1's hierarchical row shuffle
  block_sketch   fused per-block moments + histogram
  plan           fused filter / project / group-by sketch
  flash_attention  online-softmax attention with grouped-query heads
  flash_attention_bwd  its gradient (training)
  mamba2_ssd     the Mamba2 SSD chunked scan (zamba2's SSM layers)
  mamba2_ssd_bwd  its gradient (training)
  rwkv6_wkv      the RWKV6 WKV recurrence (rwkv6's time mix)
  rwkv6_wkv_bwd  its gradient (training)

Importing this package imports no kernel: the subpackages load the library
only when a wrapper is called on a CUDA tensor.
"""

from __future__ import annotations


def _counters() -> dict:
    from repro_torch.kernels.block_sketch.kernel import LAUNCHES as block_sketch
    from repro_torch.kernels.flash_attention.kernel import BWD_LAUNCHES as flash_attention_bwd
    from repro_torch.kernels.flash_attention.kernel import LAUNCHES as flash_attention
    from repro_torch.kernels.mamba2_ssd.kernel import BWD_LAUNCHES as mamba2_ssd_bwd
    from repro_torch.kernels.mamba2_ssd.kernel import LAUNCHES as mamba2_ssd
    from repro_torch.kernels.plan.kernel import LAUNCHES as plan_sketch
    from repro_torch.kernels.rsp_shuffle.kernel import LAUNCHES as rsp_shuffle
    from repro_torch.kernels.rwkv6_wkv.kernel import BWD_LAUNCHES as rwkv6_wkv_bwd
    from repro_torch.kernels.rwkv6_wkv.kernel import LAUNCHES as rwkv6_wkv

    return {"rsp_shuffle": rsp_shuffle, "block_sketch": block_sketch, "plan_sketch": plan_sketch,
            "flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
            "mamba2_ssd": mamba2_ssd, "mamba2_ssd_bwd": mamba2_ssd_bwd,
            "rwkv6_wkv": rwkv6_wkv, "rwkv6_wkv_bwd": rwkv6_wkv_bwd}


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel so far in this process."""
    return {name: c.value for name, c in _counters().items()}


def reset_launch_counts() -> None:
    for c in _counters().values():
        c.reset()
