"""The plain versions of the Mamba2 SSD scan, in float32 PyTorch.

The selective state-space recurrence, per batch row b and head h,

    h_t = exp(dA_t) * h_{t-1} + xbar_t B_t^T,      y_t = h_t C_t,

with xbar ``[B, L, H, P]`` (dt-scaled inputs), dA ``[B, L, H]`` (log-decay
per step, <= 0), B and C ``[B, L, N]`` and the state ``[B, H, P, N]``.

* :func:`ssd_chunked` is the reference's chunked form
  (``repro/models/mamba2.py::ssd_chunked``): inside a chunk of Q steps the
  output is a masked ``[Q, Q]`` product, ``(C B^T * exp(cum_i - cum_j))
  xbar`` over j <= i, plus ``exp(cum_i) C h_start``; the chunks' states
  follow one another in a short loop.  Every decay is exp of a number
  <= 0; the mask selects (``torch.where``) and never multiplies, so the
  positive exponents above the diagonal, which overflow to inf at strong
  decay, never reach the sum.  A length that is not a multiple of Q is
  padded with zero inputs and zero log-decay, which leave the state as it
  is.  The prefix sums of dA within a chunk, ``cum``, and their
  differences are taken in float64 and rounded to float32 once before
  ``exp``, as the CUDA kernel takes them: ``cum`` reaches about -100 in a
  chunk, where a float32 prefix sum strays by a few ulps (8e-6 each) and
  moves the largest outputs by up to 1e-3.  This is what the CUDA kernel is
  held against.
* :func:`ssd_recurrence` is the step recurrence
  (``repro/models/mamba2.py::ssd_reference``): the oracle, and the decode
  step of a served model (one step, no kernel, as in the reference).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad_steps(t: torch.Tensor, pad: int) -> torch.Tensor:
    # zero steps at the end of dim 1
    return F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))


def ssd_chunked(
    xbar: torch.Tensor,     # [B, L, H, P]
    dA: torch.Tensor,       # [B, L, H]
    Bm: torch.Tensor,       # [B, L, N]
    Cm: torch.Tensor,       # [B, L, N]
    *,
    chunk: int,
    h0: torch.Tensor | None = None,   # [B, H, P, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B, L, H, P] float32, h_final [B, H, P, N] float32)."""
    B, L, H, P = xbar.shape
    N = Bm.shape[-1]
    Q = min(chunk, L)
    orig_L = L
    if L % Q:
        pad = Q - L % Q
        xbar, dA, Bm, Cm = (_pad_steps(t, pad) for t in (xbar, dA, Bm, Cm))
        L += pad
    nc = L // Q
    f32 = torch.float32
    x_ = xbar.reshape(B, nc, Q, H, P).to(f32)
    dA_ = dA.reshape(B, nc, Q, H).to(f32)
    B_ = Bm.reshape(B, nc, Q, N).to(f32)
    C_ = Cm.reshape(B, nc, Q, N).to(f32)

    cum = torch.cumsum(dA_.to(torch.float64), dim=2)                 # [B, nc, Q, H]
    # intra-chunk: scores[i, j] = (C_i . B_j) * exp(cum_i - cum_j) for j <= i
    CB = torch.einsum("bcqn,bckn->bcqk", C_, B_)
    rel = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).to(f32)    # [B, nc, Q, K, H]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xbar.device).tril()
    M = torch.where(causal[None, None, :, :, None], torch.exp(rel),
                    torch.zeros((), device=xbar.device))
    del rel
    y = torch.einsum("bcqkh,bckhp->bcqhp", CB[..., None] * M, x_)
    del M

    # per-chunk state contribution: sum_j exp(cum_end - cum_j) B_j xbar_j^T
    decay_to_end = torch.exp((cum[:, :, -1:, :] - cum).to(f32))     # [B, nc, Q, H]
    S_c = torch.einsum("bckn,bckhp->bchpn", B_, x_ * decay_to_end[..., None])
    chunk_decay = torch.exp(cum[:, :, -1, :].to(f32))                # [B, nc, H]

    h = torch.zeros((B, H, P, N), dtype=f32, device=xbar.device) if h0 is None else h0.to(f32)
    h_starts = []
    for c in range(nc):
        h_starts.append(h)
        h = h * chunk_decay[:, c, :, None, None] + S_c[:, c]
    h_starts = torch.stack(h_starts, dim=1)                          # [B, nc, H, P, N]

    # inter-chunk output: exp(cum_i) * (C_i . h_start)
    y_off = torch.einsum("bcqn,bchpn->bcqhp", C_, h_starts) * torch.exp(cum.to(f32))[..., None]
    y = (y + y_off).reshape(B, L, H, P)
    return y[:, :orig_L], h


def ssd_recurrence(
    xbar: torch.Tensor,
    dA: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    *,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The step-by-step recurrence: (y [B, L, H, P], h_final [B, H, P, N])."""
    B, L, H, P = xbar.shape
    N = Bm.shape[-1]
    f32 = torch.float32
    h = torch.zeros((B, H, P, N), dtype=f32, device=xbar.device) if h0 is None else h0.to(f32)
    x_, a_, b_, c_ = (t.to(f32) for t in (xbar, dA, Bm, Cm))
    ys = []
    for t in range(L):
        h = h * torch.exp(a_[:, t])[:, :, None, None] + torch.einsum(
            "bhp,bn->bhpn", x_[:, t], b_[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, c_[:, t]))
    return torch.stack(ys, dim=1), h
