"""The public SSD scan: padding and the impl dispatcher.

``ssd(xbar, dA, Bm, Cm, chunk=..., h0=None, impl=...)`` returns
(y ``[B, L, H, P]``, h_final ``[B, H, P, N]``), both float32.

* ``impl="torch"`` -- the plain chunked form (any device), at ``chunk``.
* ``impl="cuda"``  -- the CUDA kernel (CUDA tensors only; a CPU tensor
  raises).  It runs at its own chunk of 128 and takes only ``chunk=128``,
  the zamba2 config's; the sequence is padded to a multiple of 128 with
  zero inputs and zero log-decay (the padded steps leave the state as it
  is), as the reference's wrapper pads (``repro/kernels/mamba2_ssd/
  ops.py``), and y is cut back to L.  A prompt shorter than 128 is one
  padded chunk, where the reference takes one chunk of its own length:
  the same sums, since a padded step adds nothing to any position.
* ``impl="auto"``  -- ``"cuda"`` for a CUDA tensor, ``"torch"`` otherwise.

Unlike the reference's Pallas path, which drops ``h0``
(``repro/models/mamba2.py:206``), both impls start from ``h0`` when it is
given: the reference's default (jnp) path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.mamba2_ssd.kernel import CHUNK, ssd_cuda, ssd_plain

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
    if resolve_impl(impl, xbar) == "torch":
        return ssd_plain(xbar, dA, Bm, Cm, chunk=chunk, h0=h0)
    if chunk != CHUNK:
        raise ValueError(f"the kernel runs at chunk {CHUNK}, not {chunk}")
    L = xbar.shape[1]
    pad = (-L) % CHUNK
    args = []
    for t in (xbar, dA, Bm, Cm):
        t = t.to(torch.float32)
        if pad:
            t = F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
        args.append(t.contiguous())
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    y, h = ssd_cuda(*args, h0=h0)
    return (y[:, :L] if pad else y), h
