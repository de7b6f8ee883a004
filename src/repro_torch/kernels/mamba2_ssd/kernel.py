"""The Mamba2 SSD scan on tensors: the CUDA kernel and its plain version.

* :func:`ssd_cuda` launches ``csrc/mamba2_ssd.cu`` (the port of the
  Pallas ``ssd_pallas``) and counts the launch in :data:`LAUNCHES`.  It
  takes contiguous float32 CUDA tensors xbar ``[B, L, H, 64]``, dA
  ``[B, L, H]``, B and C ``[B, L, 64]`` with L a multiple of the kernel's
  chunk, :data:`CHUNK` = 128 (``ops.ssd`` pads), and an optional initial
  state h0 ``[B, H, 64, 64]``; it returns (y ``[B, L, H, 64]``, h_final
  ``[B, H, 64, 64]``), both float32, and with ``states=True`` also the
  states at the chunks' starts that the backward reads.
* :func:`ssd_plain` is the same function in plain PyTorch (``ref.py``'s
  chunked form), on any device.
* :func:`ssd_bwd_cuda` launches its backward (``csrc/mamba2_ssd_bwd.cu``,
  no Pallas counterpart: the reference differentiates its jnp scan) and
  counts the call in :data:`BWD_LAUNCHES`; :func:`ssd_bwd_plain`
  (``ref.py``'s ``ssd_chunked_bwd``) is its plain version.

A call is two launches (``KERNELS``): ``ssd_state`` walks each (batch row,
head)'s chunks and writes the state at every chunk's start into a scratch
``[B, L / 128, H, 64, 64]`` and h_final; ``ssd_scan`` computes every
(batch row, chunk, tile of ``Ht`` heads)'s y in parallel.
:func:`head_tile` picks ``Ht`` so that the scan's CTAs fill the card's SMs
in as few waves as the work allows.

The backward is two launches too (``BWD_KERNELS``): ``ssd_bwd_state`` walks
each (batch row, head)'s chunks in reverse and writes the state's gradient
at every chunk's end; ``ssd_bwd_tile`` computes every (batch row, chunk,
tile of ``Ht`` heads)'s gradients in parallel on the tensor cores, C B^T
once a tile, and dB and dC as each tile's sum over its heads, which one
sum over the tiles adds afterwards, in one order every call.
:func:`bwd_head_tile` picks that ``Ht`` as :func:`head_tile` picks the
forward's.

The launchers return tensors without a graph: under grad mode, inputs that
require grad raise ``ValueError``; ``ops.ssd`` (the ``SSDScan`` function)
carries the gradient.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.mamba2_ssd.ref import ssd_chunked as ssd_plain
from repro_torch.kernels.mamba2_ssd.ref import ssd_chunked_bwd as ssd_bwd_plain

LAUNCHES = _cuda.LaunchCounter("mamba2_ssd")
BWD_LAUNCHES = _cuda.LaunchCounter("mamba2_ssd_bwd")
KERNELS = ("ssd_state", "ssd_scan")   # the device kernels one call launches
BWD_KERNELS = ("ssd_bwd_state", "ssd_bwd_tile")

CHUNK = 128        # the kernel's chunk length Q
HEAD_DIM = 64      # P
STATE_DIM = 64     # N
# the share of a head's work that C B^T adds, once per scan CTA: a warp's
# nine tiles of C B^T take 216 MMAs against 408 for a head's two products
_CB_SHARE = 0.5
# the same for the backward's tile: a warp's share of C B^T and of the two
# products of the heads' summed E takes 108 six-MMA products against 168
# for a head's five
_BWD_TILE_SHARE = 108 / 168


def head_tile(batch: int, heads: int, sms: int, share: float = _CB_SHARE) -> int:
    """The divisor ``Ht`` of ``heads`` whose grid of ``batch * heads / Ht``
    CTAs (one resident CTA an SM: the scan's shared memory is 211 KB)
    takes the fewest head-chunks of time: waves * (Ht + ``share``, the
    work a CTA does once, in heads; C B^T's by default).  The scan's grid
    has a CTA per batch row and chunk: ``batch`` is B * L / 128."""
    best, cost = 1, math.inf
    for ht in range(1, heads + 1):
        if heads % ht:
            continue
        waves = math.ceil(batch * (heads // ht) / sms)
        c = waves * (ht + share)
        if c < cost:
            best, cost = ht, c
    return best


def bwd_head_tile(batch: int, heads: int, sms: int) -> int:
    """``head_tile`` for the backward's ``ssd_bwd_tile`` (one resident CTA
    an SM too: 222 KB), whose once-a-CTA work is C B^T and the intra-chunk
    products of dB and dC."""
    return head_tile(batch, heads, sms, _BWD_TILE_SHARE)


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
    states: bool = False,
):
    """Launch the CUDA kernel on CUDA tensors: (y, h_final), and with
    ``states`` the chunk-start states ``[B, L / 128, H, 64, 64]``."""
    check_shapes(xbar, dA, Bm, Cm, h0)
    named = _check_operands(xbar, xbar=xbar, dA=dA, B=Bm, C=Cm, h0=h0)
    _cuda.refuse_graph("ssd_cuda", "ops.ssd (the SSDScan function)", **named)
    B, L, H, P = xbar.shape
    N = Bm.shape[-1]
    y = torch.empty_like(xbar)
    h = torch.empty((B, H, P, N), dtype=torch.float32, device=xbar.device)
    hs = torch.empty((B, L // CHUNK, H, P, N), dtype=torch.float32, device=xbar.device)
    sms = torch.cuda.get_device_properties(xbar.device).multi_processor_count
    ht = head_tile(B * (L // CHUNK), H, sms)
    lib = _cuda.library()
    code = lib.mamba2_ssd_launch(
        xbar.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
        _cuda.ptr(h0), y.data_ptr(), h.data_ptr(), hs.data_ptr(),
        B, L, H, ht, _cuda.stream_handle(xbar.device),
    )
    _cuda.check(code, "mamba2_ssd kernel")
    LAUNCHES.add()
    return (y, h, hs) if states else (y, h)


def _check_operands(xbar: torch.Tensor, /, **tensors: torch.Tensor | None) -> dict:
    """The given tensors, each a contiguous float32 CUDA tensor on xbar's
    device; raise unless P = N = 64 and L is a positive multiple of 128."""
    named = {name: t for name, t in tensors.items() if t is not None}
    _cuda.require_same_device(xbar.device, **named)
    for name, t in named.items():
        _cuda.require_cuda(t, name, torch.float32)
    B, L, H, P = xbar.shape
    N = named["B"].shape[-1]
    if P != HEAD_DIM or N != STATE_DIM:
        raise ValueError(f"the kernel takes head dim {HEAD_DIM} and state dim {STATE_DIM},"
                         f" got {P} and {N}")
    if L <= 0 or L % CHUNK:
        raise ValueError(f"L = {L} must be a positive multiple of the kernel's chunk {CHUNK}")
    if B > 65535 or L // CHUNK > 65535:
        raise ValueError("the kernel takes B <= 65535 and L <= 128 * 65535")
    return named


def ssd_bwd_cuda(
    xbar: torch.Tensor,
    dA: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    hs: torch.Tensor,
    dy: torch.Tensor,
    *,
    dh_final: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """Launch the backward kernels on CUDA tensors: (dxbar ``[B, L, H,
    64]``, ddA ``[B, L, H]``, dB, dC ``[B, L, 64]``), float32; ``hs`` the
    forward's chunk-start states, ``dh_final`` the final state's gradient
    (None: zero)."""
    check_shapes(xbar, dA, Bm, Cm, dh_final)
    B, L, H, P = xbar.shape
    N = Bm.shape[-1]
    if tuple(dy.shape) != tuple(xbar.shape):
        raise ValueError(f"dy must be {tuple(xbar.shape)}, got {tuple(dy.shape)}")
    if tuple(hs.shape) != (B, L // CHUNK, H, P, N):
        raise ValueError(f"hs must be [{B}, {L // CHUNK}, {H}, {P}, {N}], got {tuple(hs.shape)}")
    _check_operands(xbar, xbar=xbar, dA=dA, B=Bm, C=Cm, hs=hs, dy=dy, dh_final=dh_final)
    dev = xbar.device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ht = bwd_head_tile(B * (L // CHUNK), H, sms)
    dhs = torch.empty_like(hs)           # the state's gradient at every chunk's end
    dx = torch.empty_like(xbar)
    ddA = torch.empty_like(dA)
    # each tile's sums of dB and dC over its heads
    dB_part = torch.empty((B, L, H // ht, N), dtype=torch.float32, device=dev)
    dC_part = torch.empty((B, L, H // ht, N), dtype=torch.float32, device=dev)
    code = _cuda.library().mamba2_ssd_bwd_launch(
        xbar.data_ptr(), dA.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), hs.data_ptr(),
        dy.data_ptr(), _cuda.ptr(dh_final), dhs.data_ptr(), dx.data_ptr(), ddA.data_ptr(),
        dB_part.data_ptr(), dC_part.data_ptr(), B, L, H, ht, _cuda.stream_handle(dev),
    )
    _cuda.check(code, "mamba2_ssd backward kernels")
    BWD_LAUNCHES.add()
    return dx, ddA, dB_part.sum(2), dC_part.sum(2)


__all__ = ["BWD_KERNELS", "BWD_LAUNCHES", "CHUNK", "HEAD_DIM", "KERNELS", "LAUNCHES",
           "STATE_DIM", "bwd_head_tile", "check_shapes", "head_tile", "ssd_bwd_cuda", "ssd_bwd_plain", "ssd_cuda",
           "ssd_plain"]
