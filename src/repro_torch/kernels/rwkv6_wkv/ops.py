"""The public WKV6 recurrence: the decay's log, padding and the impl
dispatcher.

``wkv6(r, k, v, w, u, h0=None, impl=...)`` returns (y ``[B, T, H, C]``,
h_final ``[B, H, C, C]``), both float32, with the reference wrapper's
semantics (``repro/kernels/rwkv6_wkv/ops.py``): the decay w arrives in
(0, 1) and becomes ``logw = log(max(w, 1e-38))`` -- a decay that
underflowed to 0 takes the clamped log, -87.5 -- and T is padded to a
multiple of the chunk with identity steps (log-decay 0, k = 0, which leave
the state as it is), y cut back to T.

* ``impl="torch"`` -- the plain chunked form (any device), at
  ``Q = min(16, T)`` as the reference takes it.
* ``impl="cuda"``  -- the CUDA kernel (CUDA tensors only; a CPU tensor
  raises), always at its chunk of 16: a sequence shorter than 16 is one
  padded chunk, the same sums, since a padded step adds nothing to any
  position.
* ``impl="auto"``  -- the kernel for a CUDA tensor, the plain version
  otherwise.  On the card a head dim C below 64 is zero-padded up to 64:
  r, k, v, u and h0 with zeros, logw with 0.  A padded key channel has
  decay 1 and k = 0, so its state row starts at 0 and stays 0; a padded
  value column has v = 0, so its state column and y's stay 0.  Both are
  cut off.  Above 64 there is no width to pad to, and the kernel raises.
  (``impl="cuda"`` takes C = 64 only.)

Unlike the reference's Pallas path, which runs only without a state
(``repro/models/rwkv6.py:144``), both impls start from ``h0`` when it is
given: ``wkv6_scan(..., h0=h0)``'s function.

When grad mode is on and r, k, v, w or u requires grad, the call goes
through :class:`WKV6`, a ``torch.autograd.Function``: on the card the
forward kernel with its chunk-start states and the backward kernel, on the
host the plain chunked form and its plain backward.  Padding happens
outside the Function, so autograd cuts the padded steps' and channels'
gradients off.  The gradient reaches w through the clamp before the log:
``1 / w`` above 1e-38, 0 below it, where the reference's decay
``exp(-exp(.))`` has underflowed and its gradient is 0 too.  An ``h0`` that
requires grad raises ``NotImplementedError``: no path of the reference
differentiates a state.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_wkv.kernel import (
    CHUNK,
    HEAD_DIM,
    wkv6_bwd_cuda,
    wkv6_bwd_plain,
    wkv6_cuda,
    wkv6_plain,
)

IMPLS = ("auto", "torch", "cuda")
LOG_DECAY_FLOOR = 1e-38   # the reference's clamp before the log


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """``auto`` -> ``cuda`` on a CUDA tensor, ``torch`` otherwise."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (one of {IMPLS})")
    if impl == "auto":
        return "cuda" if x.is_cuda else "torch"
    return impl


def log_decay(w: torch.Tensor) -> torch.Tensor:
    """``log(max(w, 1e-38))`` in float32."""
    return torch.log(torch.clamp_min(w.to(torch.float32), LOG_DECAY_FLOOR))


def wkv6(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    *,
    h0: torch.Tensor | None = None,
    impl: str = "auto",
) -> tuple[torch.Tensor, torch.Tensor]:
    logw = log_decay(w)
    resolved = resolve_impl(impl, r)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, logw, u, h0)
                                       if t is not None):
        if h0 is not None and h0.requires_grad:
            raise NotImplementedError("the WKV's gradient by its initial state h0: no path of"
                                      " the reference differentiates a state")

        def run(r, k, v, logw, u, *, h0=None):
            return WKV6.apply(r, k, v, logw, u, h0, resolved)

        if resolved == "torch":
            return run(r, k, v, logw, u, h0=h0)
        return run_padded(run, r, k, v, logw, u, h0=h0, widths=impl == "auto")
    if resolved == "torch":
        return wkv6_plain(r, k, v, logw, u, h0=h0, chunk=CHUNK)
    return run_padded(wkv6_cuda, r, k, v, logw, u, h0=h0, widths=impl == "auto")


class WKV6(torch.autograd.Function):
    """The WKV with its gradient: ``apply(r, k, v, logw, u, h0, impl)``,
    ``impl`` "cuda" (the kernels, on the padded float32 operands) or
    "torch" (the plain chunked form at ``Q = min(16, T)`` and its plain
    backward).  The forward saves its inputs and the chunk-start states;
    the backward returns (dr, dk, dv, dlogw, du)."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, h0, impl: str):
        ctx.set_materialize_grads(False)
        if impl == "cuda":
            y, h, hs = wkv6_cuda(r, k, v, logw, u, h0=h0, states=True)
        else:
            y, h, hs = wkv6_plain(r, k, v, logw, u, h0=h0, chunk=CHUNK, states=True)
        ctx.save_for_backward(r, k, v, logw, u, hs)
        ctx.impl = impl
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        r, k, v, logw, u, hs = ctx.saved_tensors
        dy = torch.zeros_like(r) if dy is None else dy.to(torch.float32).contiguous()
        dh = None if dh is None else dh.to(torch.float32).contiguous()
        if ctx.impl == "cuda":
            grads = wkv6_bwd_cuda(r, k, v, logw, u, hs, dy, dh_final=dh)
        else:
            grads = wkv6_bwd_plain(r, k, v, logw, u, hs, dy, dh_final=dh, chunk=CHUNK)
        return (*grads, None, None)


def run_padded(run, r, k, v, logw, u, *, h0=None, widths: bool = True):
    """``run(r, k, v, logw, u, h0=...)`` on float32 contiguous tensors with
    T padded to a multiple of :data:`CHUNK` with identity steps and, with
    ``widths``, C padded up to 64; y and the state are cut back."""
    T, C = r.shape[1], r.shape[-1]
    pad = (-T) % CHUNK
    dc = HEAD_DIM - C if widths and C < HEAD_DIM else 0
    r, k, v, logw = (_pad(t, (0, dc, 0, 0, 0, pad)) for t in (r, k, v, logw))
    u = _pad(u, (0, dc))
    if h0 is not None:
        h0 = _pad(h0, (0, dc, 0, dc))
    y, h = run(r, k, v, logw, u, h0=h0)
    if dc:
        y, h = y[..., :C], h[..., :C, :C].contiguous()
    return (y[:, :T] if pad else y), h


def _pad(t: torch.Tensor, pads: tuple[int, ...]) -> torch.Tensor:
    # float32, contiguous, zero-padded; no copy where nothing changes
    t = t.to(torch.float32)
    return (F.pad(t, pads) if any(pads) else t).contiguous()
