"""The Mamba2 SSD scan on tensors: the CUDA kernel and its plain version.

* :func:`ssd_cuda` launches ``csrc/mamba2_ssd.cu`` (the port of the
  Pallas ``ssd_pallas``) and counts the launch in :data:`LAUNCHES`.  It
  takes contiguous float32 CUDA tensors xbar ``[B, L, H, 64]``, dA
  ``[B, L, H]``, B and C ``[B, L, 64]`` with L a multiple of the kernel's
  chunk, :data:`CHUNK` = 128 (``ops.ssd`` pads), and an optional initial
  state h0 ``[B, H, 64, 64]``; it returns (y ``[B, L, H, 64]``, h_final
  ``[B, H, 64, 64]``), both float32.
* :func:`ssd_plain` is the same function in plain PyTorch (``ref.py``'s
  chunked form), on any device.

A call is two launches (``KERNELS``): ``ssd_state`` walks each (batch row,
head)'s chunks and writes the state at every chunk's start into a scratch
``[B, L / 128, H, 64, 64]`` and h_final; ``ssd_scan`` computes every
(batch row, chunk, tile of ``Ht`` heads)'s y in parallel.
:func:`head_tile` picks ``Ht`` so that the scan's CTAs fill the card's SMs
in as few waves as the work allows.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.mamba2_ssd.ref import ssd_chunked as ssd_plain

LAUNCHES = _cuda.LaunchCounter("mamba2_ssd")
GRAD_ROADMAP = ("hybrid and RWKV6 training wait for the SSD and WKV backward kernels"
                " (ROADMAP section 1, item 2)")
KERNELS = ("ssd_state", "ssd_scan")   # the device kernels one call launches

CHUNK = 128        # the kernel's chunk length Q
HEAD_DIM = 64      # P
STATE_DIM = 64     # N
# the share of a head's work that C B^T adds, once per scan CTA: a warp's
# nine tiles of C B^T take 216 MMAs against 408 for a head's two products
_CB_SHARE = 0.5


def head_tile(batch: int, heads: int, sms: int) -> int:
    """The divisor ``Ht`` of ``heads`` whose grid of ``batch * heads / Ht``
    CTAs (one resident CTA an SM: the scan's shared memory is 211 KB)
    takes the fewest head-chunks of time: waves * (Ht + C B^T's share).
    The scan's grid has a CTA per batch row and chunk: ``batch`` is
    B * L / 128."""
    best, cost = 1, math.inf
    for ht in range(1, heads + 1):
        if heads % ht:
            continue
        waves = math.ceil(batch * (heads // ht) / sms)
        c = waves * (ht + _CB_SHARE)
        if c < cost:
            best, cost = ht, c
    return best


def check_shapes(xbar, dA, Bm, Cm, h0=None) -> None:
    """Raise unless xbar is [B, L, H, P], dA [B, L, H], B and C [B, L, N]
    and h0 (when given) [B, H, P, N]."""
    if xbar.ndim != 4 or dA.ndim != 3 or Bm.ndim != 3 or Cm.ndim != 3:
        raise ValueError("xbar must be [B, L, H, P], dA [B, L, H], B and C [B, L, N]")
    B, L, H, P = xbar.shape
    N = Bm.shape[-1]
    if tuple(dA.shape) != (B, L, H):
        raise ValueError(f"dA must be [{B}, {L}, {H}], got {tuple(dA.shape)}")
    if tuple(Bm.shape) != (B, L, N) or tuple(Cm.shape) != (B, L, N):
        raise ValueError(f"B and C must be [{B}, {L}, N], got {tuple(Bm.shape)} and "
                         f"{tuple(Cm.shape)}")
    if h0 is not None and tuple(h0.shape) != (B, H, P, N):
        raise ValueError(f"h0 must be [{B}, {H}, {P}, {N}], got {tuple(h0.shape)}")


def ssd_cuda(
    xbar: torch.Tensor,
    dA: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    *,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernel on CUDA tensors.  Under grad mode, inputs
    that require grad raise ``NotImplementedError`` (:data:`GRAD_ROADMAP`)."""
    check_shapes(xbar, dA, Bm, Cm, h0)
    _cuda.refuse_grad("ssd_cuda", GRAD_ROADMAP, xbar=xbar, dA=dA, B=Bm, C=Cm, h0=h0)
    named = {"xbar": xbar, "dA": dA, "B": Bm, "C": Cm}
    if h0 is not None:
        named["h0"] = h0
    _cuda.require_same_device(xbar.device, **named)
    for name, t in named.items():
        _cuda.require_cuda(t, name, torch.float32)
    B, L, H, P = xbar.shape
    N = Bm.shape[-1]
    if P != HEAD_DIM or N != STATE_DIM:
        raise ValueError(f"the kernel takes head dim {HEAD_DIM} and state dim {STATE_DIM},"
                         f" got {P} and {N}")
    if L <= 0 or L % CHUNK:
        raise ValueError(f"L = {L} must be a positive multiple of the kernel's chunk {CHUNK}")
    if B > 65535 or L // CHUNK > 65535:
        raise ValueError("the kernel takes B <= 65535 and L <= 128 * 65535")
    y = torch.empty_like(xbar)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=xbar.device)
    hs = torch.empty((B, L // CHUNK, H, P, N), dtype=torch.float32, device=xbar.device)
    sms = torch.cuda.get_device_properties(xbar.device).multi_processor_count
    ht = head_tile(B * (L // CHUNK), H, sms)
    lib = _cuda.library()
    code = lib.mamba2_ssd_launch(
        xbar.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        h0.data_ptr() if h0 is not None else None, y.data_ptr(), h.data_ptr(), hs.data_ptr(),
        B, L, H, ht, _cuda.stream_handle(xbar.device),
    )
    _cuda.check(code, "mamba2_ssd kernel")
    LAUNCHES.add()
    return y, h


__all__ = ["CHUNK", "GRAD_ROADMAP", "HEAD_DIM", "KERNELS", "LAUNCHES", "STATE_DIM",
           "check_shapes", "head_tile", "ssd_cuda", "ssd_plain"]
