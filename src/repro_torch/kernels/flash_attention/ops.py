"""The public flash attention: layouts and the impl dispatcher.

``flash_attention(q, k, v, causal=..., impl=...)`` takes the model's
grouped layout q ``[B, Hkv, G, S, D]`` or the flat q ``[B, H, S, D]``, with
k and v ``[B, Hkv, S, D]``, and returns q's layout.  The scale is
``1 / sqrt(D)``.  No block size needs to divide S: the kernel masks the
ragged edge.

* ``impl="torch"`` -- the plain version (any device).
* ``impl="cuda"``  -- the CUDA kernel (CUDA tensors only; a CPU tensor
  raises), at the head dims it takes (64, 112, 128).
* ``impl="auto"``  -- the kernel for a CUDA tensor, the plain version
  otherwise.  A head dim the kernel does not take is zero-padded up to the
  next one it does, as the reference's wrapper pads D (``repro/kernels/
  flash_attention/ops.py``, ``pad_d``), with the scale of the unpadded D
  and the output cut back to D: the padded columns add 0 to every score
  and every output column past D is dropped, so the padding is exact.
  Above 128 there is no width to pad to, and the kernel raises.
"""

from __future__ import annotations

import torch

import torch.nn.functional as F

from repro_torch.kernels.flash_attention.kernel import (
    HEAD_DIMS,
    flash_attention_cuda,
    flash_attention_plain,
)

IMPLS = ("auto", "torch", "cuda")


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """``auto`` -> ``cuda`` on a CUDA tensor, ``torch`` otherwise."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (one of {IMPLS})")
    if impl == "auto":
        return "cuda" if x.is_cuda else "torch"
    return impl


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    impl: str = "auto",
) -> torch.Tensor:
    grouped = q.ndim == 5
    if grouped:
        B, Hkv, G, S, D = q.shape
        qf = q.reshape(B, Hkv * G, S, D)
    else:
        qf = q
    resolved = resolve_impl(impl, q)
    if resolved == "torch":
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
