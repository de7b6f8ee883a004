"""Published peaks of one NVIDIA H100 SXM (NVIDIA's H100 data sheet, dense
rates without sparsity, at the full 700 W power limit).  A card set below
700 W runs slower under load; the result line gives its limit beside every
share of these peaks."""

BF16_FLOPS = 989e12      # bf16 and fp16 tensor-core operations per second
FP32_FLOPS = 67e12       # float32 outside the tensor cores
HBM_BYTES = 3.35e12      # HBM3 bytes per second


def least_seconds(bf16_ops: float = 0.0, fp32_ops: float = 0.0) -> float:
    """The least time of some bf16 and float32 operations at the peaks."""
    return bf16_ops / BF16_FLOPS + fp32_ops / FP32_FLOPS


def bound_seconds(ops: float, nbytes: float, peak: float = FP32_FLOPS) -> float:
    """A kernel's roofline time: the larger of its operations at ``peak``
    (float32 by default; bf16 for bf16 products) and its bytes at the
    HBM's."""
    return max(ops / peak, nbytes / HBM_BYTES)
