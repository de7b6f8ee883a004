"""The public SSD scan: padding and the impl dispatcher.

``ssd(xbar, dA, Bm, Cm, chunk=..., h0=None, impl=...)`` returns
(y ``[B, L, H, P]``, h_final ``[B, H, P, N]``), both float32.

* ``impl="torch"`` -- the plain chunked form (any device), at ``chunk``.
* ``impl="cuda"``  -- the CUDA kernel (CUDA tensors only; a CPU tensor
  raises).  It runs at its own chunk of 128 and takes only ``chunk=128``,
  the zamba2 config's, and P = N = 64; the sequence is padded to a
  multiple of 128 with zero inputs and zero log-decay (the padded steps
  leave the state as it is), as the reference's wrapper pads
  (``repro/kernels/mamba2_ssd/ops.py``), and y is cut back to L.  A prompt
  shorter than 128 is one padded chunk, where the reference takes one
  chunk of its own length: the same sums, since a padded step adds
  nothing to any position.
* ``impl="auto"``  -- the kernel for a CUDA tensor, the plain version
  otherwise.  On the card it runs the kernel at its chunk of 128 for any
  ``chunk``: the chunk only blocks the same sums, as the reference's
  ``Q = min(chunk, L)`` treats it.  A head dim P or state dim N below 64
  is zero-padded up to 64 (xbar's P, the N of B and C, both of h0): a
  padded state row or column starts at 0 and takes 0 at every step, so it
  stays 0 and adds nothing to y, whose padded columns are 0 and are cut
  off with the state's.  Above 64 there is no width to pad to, and the
  kernel raises.

Unlike the reference's Pallas path, which drops ``h0``
(``repro/models/mamba2.py:206``), both impls start from ``h0`` when it is
given: the reference's default (jnp) path.

When grad mode is on and xbar, dA, B or C requires grad, the call goes
through :class:`SSDScan`, a ``torch.autograd.Function``: on the card the
forward kernels with their chunk-start states and the two backward
kernels, on the host the plain chunked form and its plain backward.
Padding happens outside the Function, so autograd cuts the padded steps'
and widths' gradients off.  An ``h0`` that requires grad raises
``NotImplementedError``: no path of the reference differentiates a state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba2_ssd.kernel import (
    CHUNK,
    HEAD_DIM,
    STATE_DIM,
    ssd_bwd_cuda,
    ssd_bwd_plain,
    ssd_cuda,
    ssd_plain,
)

IMPLS = ("auto", "torch", "cuda")


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """``auto`` -> ``cuda`` on a CUDA tensor, ``torch`` otherwise."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (one of {IMPLS})")
    if impl == "auto":
        return "cuda" if x.is_cuda else "torch"
    return impl


def ssd(
    xbar: torch.Tensor,
    dA: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    *,
    chunk: int,
    h0: torch.Tensor | None = None,
    impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    resolved = resolve_impl(impl, xbar)
    if impl == "cuda" and chunk != CHUNK:
        raise ValueError(f"the kernel runs at chunk {CHUNK}, not {chunk}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (xbar, dA, Bm, Cm, h0)
                                       if t is not None):
        if h0 is not None and h0.requires_grad:
            raise NotImplementedError("the SSD's gradient by its initial state h0: no path of"
                                      " the reference differentiates a state")

        def run(xbar, dA, Bm, Cm, *, h0=None):
            return SSDScan.apply(xbar, dA, Bm, Cm, h0, chunk if resolved == "torch" else CHUNK,
                                 resolved)

        if resolved == "torch":
            return run(xbar, dA, Bm, Cm, h0=h0)
        return run_padded(run, xbar, dA, Bm, Cm, h0=h0, widths=impl == "auto")
    if resolved == "torch":
        return ssd_plain(xbar, dA, Bm, Cm, chunk=chunk, h0=h0)
    return run_padded(ssd_cuda, xbar, dA, Bm, Cm, h0=h0, widths=impl == "auto")


class SSDScan(torch.autograd.Function):
    """The SSD scan with its gradient: ``apply(xbar, dA, Bm, Cm, h0, chunk,
    impl)``, ``impl`` "cuda" (the kernels, on the padded float32 operands,
    at their chunk of 128) or "torch" (the plain chunked form at ``chunk``
    and its plain backward).  The forward saves its inputs and the
    chunk-start states; the backward returns (dxbar, ddA, dB, dC)."""

    @staticmethod
    def forward(ctx, xbar, dA, Bm, Cm, h0, chunk: int, impl: str):
        ctx.set_materialize_grads(False)
        if impl == "cuda":
            y, h, hs = ssd_cuda(xbar, dA, Bm, Cm, h0=h0, states=True)
        else:
            y, h, hs = ssd_plain(xbar, dA, Bm, Cm, chunk=chunk, h0=h0, states=True)
        ctx.save_for_backward(xbar, dA, Bm, Cm, hs)
        ctx.chunk, ctx.impl = chunk, impl
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        xbar, dA, Bm, Cm, hs = ctx.saved_tensors
        dy = torch.zeros_like(xbar) if dy is None else dy.to(torch.float32).contiguous()
        dh = None if dh is None else dh.to(torch.float32).contiguous()
        if ctx.impl == "cuda":
            grads = ssd_bwd_cuda(xbar, dA, Bm, Cm, hs, dy, dh_final=dh)
        else:
            grads = ssd_bwd_plain(xbar, dA, Bm, Cm, hs, dy, chunk=ctx.chunk, dh_final=dh)
        return (*grads, None, None, None)


def run_padded(run, xbar, dA, Bm, Cm, *, h0=None, widths: bool = True):
    """``run(xbar, dA, Bm, Cm, h0=...)`` on float32 contiguous tensors with L
    padded to a multiple of :data:`CHUNK` and, with ``widths``, P and N
    padded up to 64; y and the state are cut back."""
    _, L, _, P = xbar.shape
    N = Bm.shape[-1]
    pad = (-L) % CHUNK
    dp = HEAD_DIM - P if widths and P < HEAD_DIM else 0
    dn = STATE_DIM - N if widths and N < STATE_DIM else 0
    xbar = _pad(xbar, (0, dp, 0, 0, 0, pad))
    dA = _pad(dA, (0, 0, 0, pad))
    Bm, Cm = (_pad(t, (0, dn, 0, pad)) for t in (Bm, Cm))
    if h0 is not None:
        h0 = _pad(h0, (0, dn, 0, dp))
    y, h = run(xbar, dA, Bm, Cm, h0=h0)
    if dp or dn:
        y, h = y[..., :P], h[..., :P, :N].contiguous()
    return (y[:, :L] if pad else y), h


def _pad(t: torch.Tensor, pads: tuple[int, ...]) -> torch.Tensor:
    # float32, contiguous, zero-padded; no copy where nothing changes
    t = t.to(torch.float32)
    return (F.pad(t, pads) if any(pads) else t).contiguous()
