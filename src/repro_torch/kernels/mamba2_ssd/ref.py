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
  held against.  With ``states=True`` it also returns the state at every
  chunk's start, ``[B, L / Q, H, P, N]``, which the backward reads.
* :func:`ssd_chunked_bwd` is the backward of that chunked form, in the
  order the CUDA backward kernels compute it (below).
* :func:`ssd_recurrence` is the step recurrence
  (``repro/models/mamba2.py::ssd_reference``): the oracle, and the decode
  step of a served model (one step, no kernel, as in the reference).

The backward, given dy and the final state's gradient dh_final.  A reverse
walk over the chunks carries the state's gradient at each chunk's end,
``G_end``: ``G_start = exp(cum_Q) G_end + sum_t exp(cum_t) dy_t C_t^T``,
from ``dh_final``.  Then each chunk's gradients follow on their own, with
``W_ts = exp(cum_t - cum_s)`` for s <= t (0 above), ``M = (C B^T) * W`` and
``E_ts = W_ts (dy_t . xbar_s)``:

    dxbar_s = exp(cum_Q - cum_s) G_end B_s + sum_{t>=s} M_ts dy_t,
    dB_s    = sum_h [exp(cum_Q - cum_s) G_end^T xbar_s + sum_{t>=s} E_ts C_t],
    dC_t    = sum_h [exp(cum_t) h_start^T dy_t + sum_{s<=t} E_ts B_s],
    ddA_s   = exp(cum_Q) <G_end, h_start>                   (state in, state out)
            + sum_{t>=s} exp(cum_t) dy_t . (h_start C_t)      (state in, y_t out)
            + sum_{j<s} exp(cum_Q - cum_j) xbar_j . (G_end B_j) (xbar_j in, state out)
            + sum_{j<s<=t} (C_t . B_j) E_tj                   (xbar_j in, y_t out),

B and C being shared by the heads.  ddA_s is the sum of every path through
step s's decay, all inside s's chunk; each term carries that decay, so
nothing cancels (the shorter ``dy . y - xbar . dxbar`` form cancels the
undecayed diagonal terms and loses every bit of a strong decay's
gradient).
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
    states: bool = False,
):
    """Returns (y [B, L, H, P] float32, h_final [B, H, P, N] float32), and
    with ``states`` the chunk-start states [B, L / Q, H, P, N] (L padded up
    to Q's multiple)."""
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
    y = (y + y_off).reshape(B, L, H, P)[:, :orig_L]
    return (y, h, h_starts) if states else (y, h)


def ssd_chunked_bwd(
    xbar: torch.Tensor,       # [B, L, H, P]
    dA: torch.Tensor,         # [B, L, H]
    Bm: torch.Tensor,         # [B, L, N]
    Cm: torch.Tensor,         # [B, L, N]
    h_starts: torch.Tensor,   # [B, L / Q, H, P, N]: the forward's chunk-start states
    dy: torch.Tensor,         # [B, L, H, P]
    *,
    chunk: int,
    dh_final: torch.Tensor | None = None,   # [B, H, P, N]
) -> tuple[torch.Tensor, ...]:
    """The backward of :func:`ssd_chunked` at Q = min(chunk, L): (dxbar
    [B, L, H, P], ddA [B, L, H], dB [B, L, N], dC [B, L, N]), float32 (see
    the module's notes)."""
    B, L, H, P = xbar.shape
    N = Bm.shape[-1]
    f32, f64 = torch.float32, torch.float64
    Q = min(chunk, L)
    pad = (-L) % Q
    xbar, dA, Bm, Cm, dy = (t.to(f32) for t in (xbar, dA, Bm, Cm, dy))
    if pad:
        xbar, dA, Bm, Cm, dy = (_pad_steps(t, pad) for t in (xbar, dA, Bm, Cm, dy))
    nc = (L + pad) // Q
    x_, dy_ = (t.reshape(B, nc, Q, H, P) for t in (xbar, dy))
    B_, C_ = (t.reshape(B, nc, Q, N) for t in (Bm, Cm))
    cum = torch.cumsum(dA.reshape(B, nc, Q, H).to(f64), dim=2)       # [B, nc, Q, H]
    e_c = torch.exp(cum.to(f32))                                     # exp(cum_t)
    e_q = torch.exp((cum[:, :, -1:] - cum).to(f32))                  # exp(cum_Q - cum_t)
    chunk_decay = torch.exp(cum[:, :, -1].to(f32))                   # [B, nc, H]

    # the state's gradient at every chunk's end, the chunks in reverse
    G = (torch.zeros((B, H, P, N), dtype=f32, device=xbar.device) if dh_final is None
         else dh_final.to(f32))
    g_ends = [G] * nc
    for c in range(nc - 1, -1, -1):
        g_ends[c] = G
        G = chunk_decay[:, c, :, None, None] * G + torch.einsum(
            "bqhp,bqn->bhpn", dy_[:, c] * e_c[:, c, :, :, None], C_[:, c])
    g_ends = torch.stack(g_ends, dim=1)                              # [B, nc, H, P, N]
    h_starts = h_starts.to(f32)

    # each chunk: W, M = (C B^T) W and E = W (dy . xbar)
    rel = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).to(f32)     # [B, nc, Q(t), Q(s), H]
    causal = torch.ones((Q, Q), dtype=torch.bool, device=xbar.device).tril()
    W = torch.where(causal[None, None, :, :, None], torch.exp(rel),
                    torch.zeros((), device=xbar.device))
    del rel
    CB = torch.einsum("bctn,bcsn->bcts", C_, B_)
    E = W * torch.einsum("bcthp,bcshp->bctsh", dy_, x_)
    dx_end = e_q[..., None] * torch.einsum("bchpn,bcsn->bcshp", g_ends, B_)
    dx = dx_end + torch.einsum("bctsh,bcthp->bcshp", CB[..., None] * W, dy_)
    del W
    dB = (torch.einsum("bcsh,bchpn,bcshp->bcsn", e_q, g_ends, x_)
          + torch.einsum("bctsh,bctn->bcsn", E, C_))
    dC = (torch.einsum("bcth,bchpn,bcthp->bctn", e_c, h_starts, dy_)
          + torch.einsum("bctsh,bcsn->bctn", E, B_))

    # ddA: the paths through each step's decay (see the module's notes)
    ddA = (chunk_decay * (g_ends * h_starts).sum(dim=(-1, -2)))[:, :, None] \
        + _sum_from(e_c * torch.einsum("bchpn,bcthp,bctn->bcth", h_starts, dy_, C_)) \
        + _sum_before((x_ * dx_end).sum(-1))
    # sum_{j<s<=t} F_tj, F = (C B^T) E strictly below the diagonal: the sum
    # over j < s of each row, then over the rows t >= s
    below = torch.ones((Q, Q), dtype=torch.bool, device=xbar.device).tril(-1)
    Fp = torch.where(below[None, None, :, :, None], CB[..., None] * E,
                     torch.zeros((), device=xbar.device))
    del E
    before = F.pad(torch.cumsum(Fp, 3), (0, 0, 1, 0))[:, :, :, :-1]  # [t, s]: sum_{j<s} F_tj
    ddA = ddA + (before * causal[None, None, :, :, None]).sum(2)
    return (dx.reshape(B, nc * Q, H, P)[:, :L], ddA.reshape(B, nc * Q, H)[:, :L],
            dB.reshape(B, nc * Q, N)[:, :L], dC.reshape(B, nc * Q, N)[:, :L])


def _sum_from(t: torch.Tensor) -> torch.Tensor:
    # the sum over the steps at or after each one (dim 2)
    return torch.flip(torch.cumsum(torch.flip(t, (2,)), 2), (2,))


def _sum_before(t: torch.Tensor) -> torch.Tensor:
    # the sum over the steps before each one (dim 2), no term subtracted
    return F.pad(torch.cumsum(t, 2), (0, 0, 1, 0))[:, :, :-1]


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
