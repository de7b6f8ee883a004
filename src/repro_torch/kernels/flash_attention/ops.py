"""The public flash attention: layouts, the impl dispatcher and the gradient.

``flash_attention(q, k, v, causal=..., impl=...)`` takes the model's
grouped layout q ``[B, Hkv, G, S, D]`` or the flat q ``[B, H, S, D]``, with
k and v ``[B, Hkv, S, D]``, and returns q's layout.  The scale is
``1 / sqrt(D)``.  No block size needs to divide S: the kernel masks the
ragged edge.

* ``impl="torch"`` -- the plain version (any device).
* ``impl="cuda"``  -- the CUDA kernel (CUDA tensors only; a CPU tensor
  raises), at the head dims it takes (64, 80, 112, 128).
* ``impl="auto"``  -- the kernel for a CUDA tensor, the plain version
  otherwise.  A head dim the kernel does not take is zero-padded up to the
  next one it does, as the reference's wrapper pads D (``repro/kernels/
  flash_attention/ops.py``, ``pad_d``), with the scale of the unpadded D
  and the output cut back to D: the padded columns add 0 to every score
  and every output column past D is dropped, so the padding is exact.
  Above 128 there is no width to pad to, and the kernel raises.

When grad mode is on and an input requires grad, the call goes through
:class:`FlashAttention`, a ``torch.autograd.Function``: on the card the
forward kernel with its row log-sum-exp and the backward kernel
(bf16 only: a float32 input raises ``NotImplementedError``), on the host
the plain forward with the reference's statistics and the plain backward
(the port of its custom VJP).  Padding then happens outside the Function,
so autograd cuts the padded gradient columns off and the scale of the
unpadded D holds in both directions.  Without grad the output carries no
graph, as serving wants.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention.kernel import (
    GRAD_ROADMAP,
    HEAD_DIMS,
    flash_attention_bwd_cuda,
    flash_attention_bwd_plain,
    flash_attention_cuda,
    flash_attention_plain,
    flash_attention_stats,
)

IMPLS = ("auto", "torch", "cuda")


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """``auto`` -> ``cuda`` on a CUDA tensor, ``torch`` otherwise."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (one of {IMPLS})")
    if impl == "auto":
        return "cuda" if x.is_cuda else "torch"
    return impl


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the kernels read it: head dim contiguous, rows 16-byte aligned."""
    ok = (t.stride(3) == 1 and all(t.stride(i) % 8 == 0 for i in range(3))
          and (_cuda.is_fake(t) or t.data_ptr() % 16 == 0))   # a fake tensor has no address
    return t if ok else t.contiguous()


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: ``apply(q, k, v, causal, scale,
    impl, k_block)`` on the flat layout, ``impl`` "cuda" (the kernels) or
    "torch" (the plain versions, whose backward walks ``k_block`` keys at a
    time).  The forward saves q, k, v, the output and the row statistics;
    the backward recomputes P from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float | None, impl: str, k_block: int):
        if impl == "cuda":
            out, lse = flash_attention_cuda(q, k, v, causal=causal, scale=scale, with_lse=True)
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            out32, (m, l) = flash_attention_stats(q, k, v, causal=causal, scale=scale)
            out = out32.to(q.dtype)
            # the reference's Dvec reads the float32 output
            ctx.save_for_backward(q, k, v, out32, m, l)
        ctx.causal, ctx.scale, ctx.impl, ctx.k_block = causal, scale, impl, k_block
        return out

    @staticmethod
    def backward(ctx, dout):
        if ctx.impl == "cuda":
            q, k, v, out, lse = ctx.saved_tensors
            dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, _aligned(dout), lse,
                                                  causal=ctx.causal, scale=ctx.scale)
        else:
            q, k, v, out, m, l = ctx.saved_tensors
            dq, dk, dv = flash_attention_bwd_plain(q, k, v, out, dout, m, l, causal=ctx.causal,
                                                   scale=ctx.scale, k_block=ctx.k_block)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    impl: str = "auto",
    k_block: int = 512,
) -> torch.Tensor:
    grouped = q.ndim == 5
    if grouped:
        B, Hkv, G, S, D = q.shape
        qf = q.reshape(B, Hkv * G, S, D)
    else:
        qf = q
    resolved = resolve_impl(impl, q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if resolved == "cuda" and q.dtype != torch.bfloat16:
            raise NotImplementedError(f"flash attention's gradient in {q.dtype}: {GRAD_ROADMAP}")

        def run(q, k, v, *, causal, scale=None):
            if resolved == "cuda":
                q, k, v = _aligned(q), _aligned(k), _aligned(v)
            return FlashAttention.apply(q, k, v, causal, scale, resolved, k_block)

        out = run_padded(run, qf, k, v, causal=causal) if impl == "auto" and resolved == "cuda" \
            else run(qf, k, v, causal=causal)
    elif resolved == "torch":
        out = flash_attention_plain(qf, k, v, causal=causal)
    elif impl == "auto":
        out = run_padded(flash_attention_cuda, qf, k, v, causal=causal)
    else:
        out = flash_attention_cuda(qf, k, v, causal=causal)
    return out.reshape(q.shape) if grouped else out


def padded_head_dim(D: int) -> int:
    """The kernel's head dim for D: the smallest of :data:`HEAD_DIMS` that
    is at least D, or D itself above the widest (the kernel then raises)."""
    return next((w for w in HEAD_DIMS if w >= D), D)


def run_padded(run, q, k, v, *, causal: bool) -> torch.Tensor:
    """``run(q, k, v, causal=..., scale=...)`` with D zero-padded to
    :func:`padded_head_dim` and the output cut back to D."""
    D = q.shape[-1]
    Dp = padded_head_dim(D)
    if Dp == D:
        return run(q, k, v, causal=causal)
    q, k, v = (F.pad(t, (0, Dp - D)) for t in (q, k, v))
    return run(q, k, v, causal=causal, scale=1.0 / D**0.5)[..., :D]
