"""Flash attention on tensors: the CUDA kernels and their plain versions.

q is ``[B, H, S, D]``, k and v ``[B, Hkv, S, D]`` with ``H % Hkv == 0``;
query head ``h`` reads kv head ``h // (H / Hkv)``.  Scores, running max,
running sum and accumulator are float32; the output has q's dtype.

* :func:`flash_attention_cuda` launches ``csrc/flash_attention.cu`` (the
  port of the Pallas ``flash_attention_pallas``) and counts the launch in
  :data:`LAUNCHES`.  It takes CUDA tensors of bfloat16 (tensor cores) or
  float32 (FMAs), D of 64, 80 (hubert-xlarge), 112 (zamba2-7b's shared
  block) or 128, any S,
  and strided views whose head dim is contiguous, so the grouped layout
  needs no copy.  The output is laid
  out ``[B, S, H, D]`` in memory (returned as its ``[B, H, S, D]`` view),
  so the attention layer's transpose back to ``[B, S, H * D]`` is free.
  ``with_lse=True`` also returns each row's log-sum-exp, float32
  ``[B, H, S]``, which the backward reads.  The output has no ``grad_fn``,
  so the wrapper refuses inputs that require grad while grad mode is on:
  ``ops.flash_attention`` differentiates through ``ops.FlashAttention``.
* :func:`flash_attention_bwd_cuda` launches ``csrc/flash_attention_bwd.cu``
  (the port of the reference's blockwise custom-VJP backward,
  ``_flash_flat_cvjp_bwd``; two device kernels, :data:`BWD_KERNELS`: dQ,
  which also writes the rows' statistics, then dK/dV, on ``wgmma`` + TMA) on
  bf16 tensors at the forward's head dims and counts the call in
  :data:`BWD_LAUNCHES`.  It returns
  (dq, dk, dv) in bf16, dk and dv summed over each kv head's query heads
  in a fixed order (no atomics: the same bits every run), laid out
  ``[B, S, heads, D]`` in memory as the forward's output.
* :func:`flash_attention_plain`, :func:`flash_attention_stats` and
  :func:`flash_attention_bwd_plain` are the same functions in plain
  PyTorch (``ref.py``), on any device.
* :func:`flash_work` and :func:`flash_bwd_work` are each direction's
  operations and bytes, from which its bound is computed; handed fake
  tensors, the launchers record them and launch nothing (``_cuda``).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref as flash_attention_bwd_plain,
    flash_attention_ref as flash_attention_plain,
    flash_attention_stats,
)

LAUNCHES = _cuda.LaunchCounter("flash_attention")
BWD_LAUNCHES = _cuda.LaunchCounter("flash_attention_bwd")
# the device kernels of one backward call (template instances carry <D>)
BWD_KERNELS = ("fa_bwd_dq_wgmma", "fa_bwd_dkdv_wgmma")

HEAD_DIMS = (64, 80, 112, 128)
# the backward's statistics scratch covers S rounded up to this many rows
# (kPadRows in csrc/flash_attention_bwd.cu)
BWD_PAD_ROWS = 384
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
GRAD_ROADMAP = ("a float32 flash backward kernel waits (ROADMAP section 1, item 2); train in"
                " bfloat16, as the reference does")


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


def _check_operand(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor for the CUDA kernel")
    if t.dtype not in _DTYPE_CODES or t.dtype != dtype:
        raise ValueError(f"q, k and v must all be float32 or all bfloat16, got {t.dtype}")
    if t.stride(3) != 1:
        raise ValueError(f"{name}'s head dim must be contiguous")
    # bf16 tiles are read as 16-byte vectors (a fake tensor has no address)
    if t.dtype == torch.bfloat16 and ((not _cuda.is_fake(t) and t.data_ptr() % 16)
                                      or any(t.stride(i) % 8 for i in range(3))):
        raise ValueError(f"{name}'s rows must be 16-byte aligned")


def _check_sizes(B: int, H: int, S: int, D: int) -> None:
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {D}")
    if B > 65535 or H > 65535 or S >= 2**31:
        raise ValueError("the kernel takes B, H <= 65535 and S < 2**31")


def _pairs(S: int, causal: bool) -> int:
    return S * (S + 1) // 2 if causal else S * S


def flash_work(B: int, H: int, Hkv: int, S: int, D: int, causal: bool, *, itemsize: int = 2,
               lse: bool = False) -> tuple[int, int]:
    """(operations, bytes) of one forward: QK^T and PV over the attended
    pairs (2 operations a multiply-add); q, k, v read and the output
    written once in ``itemsize`` bytes, and with ``lse`` each row's
    float32 log-sum-exp written."""
    nbytes = itemsize * (2 * B * H * S * D + 2 * B * Hkv * S * D) + (4 * B * H * S if lse else 0)
    return 4 * B * H * D * _pairs(S, causal), nbytes


def flash_bwd_work(B: int, H: int, Hkv: int, S: int, D: int, causal: bool) -> tuple[int, int]:
    """(operations, bytes) of one backward: 2.5x the forward's products;
    q, k, v, out, dout read and dq, dk, dv written once in bf16, lse read
    in float32."""
    return (10 * B * H * D * _pairs(S, causal),
            2 * D * (4 * B * H * S + 4 * B * Hkv * S) + 4 * B * H * S)


def _heads_last(B: int, S: int, heads: int, D: int, like: torch.Tensor) -> torch.Tensor:
    """An empty [B, heads, S, D] view of a [B, S, heads, D] tensor."""
    return torch.empty((B, S, heads, D), dtype=like.dtype, device=like.device).permute(0, 2, 1, 3)


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
    with_lse: bool = False,
):
    """Launch the CUDA kernel on CUDA tensors; (out, lse) with ``with_lse``."""
    check_shapes(q, k, v)
    _cuda.require_same_device(q.device, k=k, v=v)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        raise ValueError("flash_attention_cuda returns no gradient: differentiate through"
                         " ops.flash_attention (the FlashAttention function)")
    B, H, S, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_operand(name, t, q.dtype)
    _check_sizes(B, H, S, D)
    if scale is None:
        scale = 1.0 / D**0.5
    o = _heads_last(B, S, H, D, q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) if with_lse else None
    if _cuda.is_fake(q):
        _cuda.record_shape_only("flash_attention", *flash_work(
            B, H, k.shape[1], S, D, causal, itemsize=q.element_size(), lse=with_lse),
            "bf16" if q.dtype == torch.bfloat16 else "f32")
        return (o, lse) if with_lse else o
    lib = _cuda.library()
    code = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr() if with_lse else None, _DTYPE_CODES[q.dtype],
        B, H, k.shape[1], S, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *o.stride()[:3],
        int(causal), float(scale), _cuda.stream_handle(q.device),
    )
    _cuda.check(code, "flash_attention kernel")
    LAUNCHES.add()
    return (o, lse) if with_lse else o


def flash_attention_bwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    lse: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the backward kernels on bf16 CUDA tensors: (dq, dk, dv)."""
    check_shapes(q, k, v)
    _cuda.require_same_device(q.device, k=k, v=v, out=out, dout=dout, lse=lse)
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"out and dout must be {tuple(q.shape)}")
    if q.dtype != torch.bfloat16:
        raise NotImplementedError(f"flash backward in {q.dtype}: {GRAD_ROADMAP}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)):
        _check_operand(name, t, torch.bfloat16)
    _cuda.require_cuda(lse, "lse", torch.float32)
    if lse.shape != (B, H, S):
        raise ValueError(f"lse must be [{B}, {H}, {S}], got {tuple(lse.shape)}")
    _check_sizes(B, H, S, D)
    if causal and S > 65535 * 128:
        raise ValueError("the causal backward takes S <= 65535 * 128 (one grid index a 128-row"
                         " kv tile)")
    if scale is None:
        scale = 1.0 / D**0.5
    dq = _heads_last(B, S, H, D, q)
    dk = _heads_last(B, S, Hkv, D, q)
    dv = _heads_last(B, S, Hkv, D, q)
    # each row's lse (log2 units) and Dvec, which the dQ kernel writes
    Sp = -(-S // BWD_PAD_ROWS) * BWD_PAD_ROWS
    stats = torch.empty((B, H, 2, Sp), dtype=torch.float32, device=q.device)
    if _cuda.is_fake(q):
        _cuda.record_shape_only("flash_attention_bwd", *flash_bwd_work(B, H, Hkv, S, D, causal),
                                "bf16")
        return dq, dk, dv
    strides = (ctypes.c_longlong * 24)(*(s for t in (q, k, v, out, dout, dq, dk, dv)
                                         for s in t.stride()[:3]))
    code = _cuda.library().flash_attention_bwd_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), stats.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, H, Hkv, S, D, strides, int(causal), float(scale), _cuda.stream_handle(q.device),
    )
    _cuda.check(code, "flash_attention backward kernels")
    BWD_LAUNCHES.add()
    return dq, dk, dv


__all__ = ["BWD_KERNELS", "BWD_LAUNCHES", "GRAD_ROADMAP", "HEAD_DIMS", "LAUNCHES",
           "check_shapes", "flash_attention_bwd_cuda", "flash_attention_bwd_plain",
           "flash_attention_cuda", "flash_attention_plain", "flash_attention_stats",
           "flash_bwd_work", "flash_work"]
