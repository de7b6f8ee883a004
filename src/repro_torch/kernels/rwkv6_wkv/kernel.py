"""The RWKV6 WKV recurrence on tensors: the CUDA kernel and its plain version.

* :func:`wkv6_cuda` launches ``csrc/rwkv6_wkv.cu`` (the port of the Pallas
  ``wkv6_pallas``) and counts the launch in :data:`LAUNCHES`.  It takes
  contiguous float32 CUDA tensors r, k, v and the log-decay logw, each
  ``[B, T, H, 64]``, with T a multiple of the kernel's chunk, :data:`CHUNK` = 16 (``ops.wkv6`` pads), u ``[H, 64]``
  and an optional initial state h0 ``[B, H, 64, 64]``; it returns
  (y ``[B, T, H, 64]``, h_final ``[B, H, 64, 64]``), both float32.
* :func:`wkv6_plain` is the same function in plain PyTorch (``ref.py``'s
  chunked form), on any device.

One CTA owns one (batch row, head) and walks the chunks in order: producer
warps compute each chunk's state-independent terms ahead, consumer warps
carry the state through its two products on the tensor cores.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_chunked as wkv6_plain

LAUNCHES = _cuda.LaunchCounter("rwkv6_wkv")
GRAD_ROADMAP = ("hybrid and RWKV6 training wait for the SSD and WKV backward kernels"
                " (ROADMAP section 1, item 2)")
KERNELS = ("wkv6_chunks",)   # the device kernels one call launches

CHUNK = 16       # the kernel's chunk length Q
HEAD_DIM = 64    # C = V


def check_shapes(r, k, v, logw, u, h0=None) -> None:
    """Raise unless r, k, v and logw are [B, T, H, C], u [H, C] and h0
    (when given) [B, H, C, C]."""
    if r.ndim != 4:
        raise ValueError("r, k, v and logw must be [B, T, H, C]")
    B, T, H, C = r.shape
    for name, t in (("k", k), ("v", v), ("logw", logw)):
        if tuple(t.shape) != (B, T, H, C):
            raise ValueError(f"{name} must be [{B}, {T}, {H}, {C}], got {tuple(t.shape)}")
    if tuple(u.shape) != (H, C):
        raise ValueError(f"u must be [{H}, {C}], got {tuple(u.shape)}")
    if h0 is not None and tuple(h0.shape) != (B, H, C, C):
        raise ValueError(f"h0 must be [{B}, {H}, {C}, {C}], got {tuple(h0.shape)}")


def wkv6_cuda(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    logw: torch.Tensor,
    u: torch.Tensor,
    *,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on CUDA tensors.  Under grad mode, inputs
    that require grad raise ``NotImplementedError`` (:data:`GRAD_ROADMAP`)."""
    check_shapes(r, k, v, logw, u, h0)
    _cuda.refuse_grad("wkv6_cuda", GRAD_ROADMAP, r=r, k=k, v=v, logw=logw, u=u, h0=h0)
    named = {"r": r, "k": k, "v": v, "logw": logw, "u": u}
    if h0 is not None:
        named["h0"] = h0
    _cuda.require_same_device(r.device, **named)
    for name, t in named.items():
        _cuda.require_cuda(t, name, torch.float32)
    B, T, H, C = r.shape
    if C != HEAD_DIM:
        raise ValueError(f"the kernel takes head dim {HEAD_DIM}, got {C}")
    if T <= 0 or T % CHUNK:
        raise ValueError(f"T = {T} must be a positive multiple of the kernel's chunk {CHUNK}")
    if B > 65535:
        raise ValueError("the kernel takes B <= 65535")
    y = torch.empty_like(r)
    h = torch.empty((B, H, C, C), dtype=torch.float32, device=r.device)
    lib = _cuda.library()
    code = lib.rwkv6_wkv_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
        h0.data_ptr() if h0 is not None else None, y.data_ptr(), h.data_ptr(),
        B, T, H, _cuda.stream_handle(r.device),
    )
    _cuda.check(code, "rwkv6_wkv kernel")
    LAUNCHES.add()
    return y, h


__all__ = ["CHUNK", "GRAD_ROADMAP", "HEAD_DIM", "KERNELS", "LAUNCHES", "check_shapes",
           "wkv6_cuda", "wkv6_plain"]
