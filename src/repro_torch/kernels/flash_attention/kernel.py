"""Flash attention on tensors: the CUDA kernel and its plain version.

q is ``[B, H, S, D]``, k and v ``[B, Hkv, S, D]`` with ``H % Hkv == 0``;
query head ``h`` reads kv head ``h // (H / Hkv)``.  Scores, running max,
running sum and accumulator are float32; the output has q's dtype.

* :func:`flash_attention_cuda` launches ``csrc/flash_attention.cu`` (the
  port of the Pallas ``flash_attention_pallas``) and counts the launch in
  :data:`LAUNCHES`.  It takes CUDA tensors of bfloat16 (tensor cores) or
  float32 (FMAs), D of 64, 112 (zamba2-7b's shared block) or 128, any S,
  and strided views whose head dim is contiguous, so the grouped layout
  needs no copy.  The output is laid
  out ``[B, S, H, D]`` in memory (returned as its ``[B, H, S, D]`` view),
  so the attention layer's transpose back to ``[B, S, H * D]`` is free.
* :func:`flash_attention_plain` is the same function in plain PyTorch
  (``ref.py``), on any device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention.ref import flash_attention_ref as flash_attention_plain

LAUNCHES = _cuda.LaunchCounter("flash_attention")

HEAD_DIMS = (64, 112, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise unless q is [B, H, S, D] and k, v are [B, Hkv, S, D], H % Hkv == 0."""
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("q, k and v must be [B, H, S, D] and [B, Hkv, S, D]")
    B, H, S, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[2:] != (S, D):
        raise ValueError(
            f"k and v must be [{B}, Hkv, {S}, {D}], got {tuple(k.shape)} and {tuple(v.shape)}")
    if H % k.shape[1]:
        raise ValueError(f"H = {H} is not a multiple of Hkv = {k.shape[1]}")


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors."""
    check_shapes(q, k, v)
    _cuda.require_same_device(q.device, k=k, v=v)
    B, H, S, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor for the CUDA kernel")
        if t.dtype not in _DTYPE_CODES or t.dtype != q.dtype:
            raise ValueError(f"q, k and v must all be float32 or all bfloat16, got {t.dtype}")
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s head dim must be contiguous")
        # bf16 tiles are read as 16-byte vectors
        if t.dtype == torch.bfloat16 and (
            t.data_ptr() % 16 or any(t.stride(i) % 8 for i in range(3))
        ):
            raise ValueError(f"{name}'s rows must be 16-byte aligned")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {D}")
    if B > 65535 or H > 65535 or S >= 2**31:
        raise ValueError("the kernel takes B, H <= 65535 and S < 2**31")
    if scale is None:
        scale = 1.0 / D**0.5
    o = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device).permute(0, 2, 1, 3)
    lib = _cuda.library()
    code = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), _DTYPE_CODES[q.dtype],
        B, H, k.shape[1], S, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        int(causal), float(scale), _cuda.stream_handle(q.device),
    )
    _cuda.check(code, "flash_attention kernel")
    LAUNCHES.add()
    return o


__all__ = ["HEAD_DIMS", "LAUNCHES", "check_shapes", "flash_attention_cuda",
           "flash_attention_plain"]
