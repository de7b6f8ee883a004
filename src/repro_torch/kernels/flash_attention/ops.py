"""The public flash attention: layouts and the impl dispatcher.

``flash_attention(q, k, v, causal=..., impl=...)`` takes the model's
grouped layout q ``[B, Hkv, G, S, D]`` or the flat q ``[B, H, S, D]``, with
k and v ``[B, Hkv, S, D]``, and returns q's layout.  The scale is
``1 / sqrt(D)``.  Unlike the reference's wrapper it needs no padding of D
and no block size that divides S: the kernel masks the ragged edge.

* ``impl="torch"`` -- the plain version (any device).
* ``impl="cuda"``  -- the CUDA kernel (CUDA tensors only; a CPU tensor raises).
* ``impl="auto"``  -- ``"cuda"`` for a CUDA tensor, ``"torch"`` otherwise.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (
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
    run = flash_attention_cuda if resolve_impl(impl, q) == "cuda" else flash_attention_plain
    out = run(qf, k, v, causal=causal)
    return out.reshape(q.shape) if grouped else out
