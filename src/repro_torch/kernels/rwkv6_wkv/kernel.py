"""The RWKV6 WKV recurrence on tensors: the CUDA kernel and its plain version.

* :func:`wkv6_cuda` launches ``csrc/rwkv6_wkv.cu`` (the port of the Pallas
  ``wkv6_pallas``) and counts the launch in :data:`LAUNCHES`.  It takes
  contiguous float32 CUDA tensors r, k, v and the log-decay logw, each
  ``[B, T, H, 64]``, with T a multiple of the kernel's chunk, :data:`CHUNK` = 16 (``ops.wkv6`` pads), u ``[H, 64]``
  and an optional initial state h0 ``[B, H, 64, 64]``; it returns
  (y ``[B, T, H, 64]``, h_final ``[B, H, 64, 64]``), both float32; with
  ``states=True`` also the state at every chunk's start, ``[B, T / 16, H,
  64, 64]``, which the backward reads.
* :func:`wkv6_plain` is the same function in plain PyTorch (``ref.py``'s
  chunked form), on any device.
* :func:`wkv6_bwd_cuda` launches its backward (``csrc/rwkv6_wkv_bwd.cu``,
  no Pallas counterpart: the reference differentiates its jnp scan) and
  counts the launch in :data:`BWD_LAUNCHES`; :func:`wkv6_bwd_plain`
  (``ref.py``'s ``wkv6_chunked_bwd``) is its plain version.

One CTA owns one (batch row, head) and walks the chunks in order: producer
warps compute each chunk's state-independent terms ahead, consumer warps
carry the state through its two products on the tensor cores.  The
backward is two launches (``BWD_KERNELS``): ``wkv6_bwd_state`` walks each
(batch row, head)'s chunks in reverse and writes the state's gradient at
every chunk's end; ``wkv6_bwd_chunk`` computes the gradients of every
(batch row, group of :data:`BWD_GROUP` chunks, head) in parallel, its
products on the tensor cores, du as each CTA's share, which one sum over
the batch rows and groups adds afterwards, in one order every call.

The launchers return tensors without a graph: under grad mode, inputs that
require grad raise ``ValueError``; ``ops.wkv6`` (the ``WKV6`` function)
carries the gradient.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_chunked as wkv6_plain
from repro_torch.kernels.rwkv6_wkv.ref import wkv6_chunked_bwd as wkv6_bwd_plain

LAUNCHES = _cuda.LaunchCounter("rwkv6_wkv")
BWD_LAUNCHES = _cuda.LaunchCounter("rwkv6_wkv_bwd")
KERNELS = ("wkv6_chunks",)   # the device kernels one call launches
BWD_KERNELS = ("wkv6_bwd_state", "wkv6_bwd_chunk")

CHUNK = 16       # the kernel's chunk length Q
HEAD_DIM = 64    # C = V
BWD_GROUP = 8    # chunks a CTA of wkv6_bwd_chunk takes, in reverse


def bwd_groups(T: int) -> int:
    """The chunk groups of ``wkv6_bwd_chunk`` along a padded length T: du
    comes back as a share per (batch row, group, head)."""
    return -(-(T // CHUNK) // BWD_GROUP)


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
    states: bool = False,
):
    """Launch the CUDA kernel on CUDA tensors: (y, h_final), and with
    ``states`` the chunk-start states."""
    check_shapes(r, k, v, logw, u, h0)
    named = _check_operands(r, r=r, k=k, v=v, logw=logw, u=u, h0=h0)
    _cuda.refuse_graph("wkv6_cuda", "ops.wkv6 (the WKV6 function)", **named)
    B, T, H, C = r.shape
    y = torch.empty_like(r)
    h = torch.empty((B, H, C, C), dtype=torch.float32, device=r.device)
    hs = (torch.empty((B, T // CHUNK, H, C, C), dtype=torch.float32, device=r.device)
          if states else None)
    lib = _cuda.library()
    code = lib.rwkv6_wkv_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(),
        _cuda.ptr(h0), y.data_ptr(), h.data_ptr(), _cuda.ptr(hs),
        B, T, H, _cuda.stream_handle(r.device),
    )
    _cuda.check(code, "rwkv6_wkv kernel")
    LAUNCHES.add()
    return (y, h, hs) if states else (y, h)


def _check_operands(r: torch.Tensor, /, **tensors: torch.Tensor | None) -> dict:
    """The given tensors, each a contiguous float32 CUDA tensor on r's
    device; raise unless C is 64 and T a positive multiple of 16."""
    named = {name: t for name, t in tensors.items() if t is not None}
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
    return named


def wkv6_bwd_cuda(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    logw: torch.Tensor,
    u: torch.Tensor,
    hs: torch.Tensor,
    dy: torch.Tensor,
    *,
    dh_final: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """Launch the backward kernels on CUDA tensors: (dr, dk, dv, dlogw
    ``[B, T, H, 64]``, du ``[H, 64]``), float32; ``hs`` the forward's
    chunk-start states, ``dh_final`` the final state's gradient (None:
    zero).  du is written per (batch row, chunk group, head) and summed
    over the batch rows and groups afterwards, in one order every call."""
    check_shapes(r, k, v, logw, u, dh_final)
    B, T, H, C = r.shape
    if tuple(dy.shape) != tuple(r.shape):
        raise ValueError(f"dy must be {tuple(r.shape)}, got {tuple(dy.shape)}")
    if tuple(hs.shape) != (B, T // CHUNK, H, C, C):
        raise ValueError(f"hs must be [{B}, {T // CHUNK}, {H}, {C}, {C}], got {tuple(hs.shape)}")
    _check_operands(r, r=r, k=k, v=v, logw=logw, u=u, hs=hs, dy=dy, dh_final=dh_final)
    dhs = torch.empty_like(hs)           # the state's gradient at every chunk's end
    dr, dk, dv, dlogw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty((B, bwd_groups(T), H, C), dtype=torch.float32, device=r.device)
    code = _cuda.library().rwkv6_wkv_bwd_launch(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(), hs.data_ptr(),
        dy.data_ptr(), _cuda.ptr(dh_final), dhs.data_ptr(), dr.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dlogw.data_ptr(), du.data_ptr(), B, T, H, BWD_GROUP,
        _cuda.stream_handle(r.device),
    )
    _cuda.check(code, "rwkv6_wkv backward kernels")
    BWD_LAUNCHES.add()
    return dr, dk, dv, dlogw, du.sum((0, 1))


__all__ = ["BWD_GROUP", "BWD_KERNELS", "BWD_LAUNCHES", "CHUNK", "HEAD_DIM", "KERNELS",
           "LAUNCHES", "bwd_groups", "check_shapes", "wkv6_bwd_cuda", "wkv6_bwd_plain", "wkv6_cuda", "wkv6_plain"]
