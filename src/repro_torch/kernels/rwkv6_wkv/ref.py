"""The plain versions of the RWKV6 WKV recurrence, in float32 PyTorch.

Per batch row b and head h, with key dim C and value dim V (= C),

    S_t = diag(w_t) S_{t-1} + k_t v_t^T,
    y_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t,

with r, k, v ``[B, T, H, C]``, the decay w in (0, 1) (or its log, <= 0),
the bonus u ``[H, C]`` and the state ``[B, H, C, V]``.

* :func:`wkv6_scan` is the exact step recurrence
  (``repro/models/rwkv6.py::wkv6_scan``): the oracle, and the decode step
  of a served model (one step, no kernel, as in the reference).
* :func:`wkv6_chunked` is the CUDA kernel's own algebra (the Pallas
  ``_wkv_kernel``'s): sequential over chunks of Q steps, vectorised inside
  a chunk.  With ``cwx_t`` the sum of the log-decays before step t inside
  the chunk and ``cw_j`` the sum through step j,

      y_t = (r_t exp(cwx_t)) h_start + sum_{j<t} A_tj v_j + (r_t . u k_t) v_t,
      A_tj = sum_c r_tc k_jc exp(cwx_tc - cw_jc),
      h_end = exp(cw_Q) h_start + sum_j (k_j exp(cw_Q - cw_j)) v_j^T.

  Every exponent is a sum of log-decays, <= 0.  A step's log-decay reaches
  -87.5 at the reference's 1e-38 clamp, so a chunk's prefix sum reaches
  about -1400, where a float32 difference of two prefix sums keeps none of
  the bits of a small exponent: the prefix sums and their differences are
  float64, each exponent rounded to float32 once before ``exp``, as the
  CUDA kernel takes them.  The strict triangle ``j < t`` is a selection:
  only those pairs are formed.  A length that is not a multiple of Q is
  padded with identity steps (log-decay 0, k = 0), which leave the state
  as it is; y is cut back to T.  This is what the CUDA kernel is held
  against.  With ``states=True`` it also returns the state at every
  chunk's start, ``[B, T / Q, H, C, V]``, which the backward reads.
* :func:`wkv6_chunked_bwd` is the backward of that chunked form, in the
  order the CUDA backward kernel computes it (below).

The backward, given dy and the gradient of the final state dh_final.  The
state's gradient G_t = dL/dS_t runs backward, ``G_{t-1} = diag(w_t) G_t +
r_t dy_t^T`` from ``G_T = dh_final``; a chunk's ``G_start = exp(cw_Q) G_end
+ sum_t (r_t exp(cwx_t)) dy_t^T``.  Inside a chunk, with ``E_tsc =
exp(cwx_tc - cw_sc)`` for s < t and ``vd_ts = v_s . dy_t``,

    dr_t = exp(cwx_t) (S_start dy_t) + sum_{s<t} vd_ts k_s E_ts + u k_t vd_tt,
    dk_s = exp(cw_Q - cw_s) (G_end v_s) + sum_{t>s} vd_ts r_t E_ts + u r_s vd_ss,
    dv_s = G_end^T (k_s exp(cw_Q - cw_s)) + sum_{t>s} A_ts dy_t + (r_s . u k_s) dy_s,
    du   = sum over b and t of r_t k_t vd_tt,

and the log-decay's gradient as the sum of every path through step s's
decay, each term carrying that decay (so nothing cancels, also where a
decay has underflowed): with ``a_t = r_t exp(cwx_t) (S_start dy_t)`` and
``b_j = k_j exp(cw_Q - cw_j) (G_end v_j)`` (the chunk-boundary parts of
r_t dr_t and k_j dk_j) and ``P_tj = r_t k_j E_tj vd_tj``,

    dlogw_s = exp(cw_Q) rowsum(G_end * S_start)     (state in, state out)
            + sum_{t>s} a_t                           (state in, y_t out)
            + sum_{j<s} b_j                           (k_j in, state out)
            + sum_{j<s<t} P_tj                        (k_j in, y_t out),

all inside s's chunk.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def wkv6_scan(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    *,
    h0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The step recurrence, with the multiplicative decay w in (0, 1):
    (y [B, T, H, C] float32, final state [B, H, C, C] float32)."""
    B, T, H, C = r.shape
    f32 = torch.float32
    h = torch.zeros((B, H, C, C), dtype=f32, device=r.device) if h0 is None else h0.to(f32)
    r_, k_, v_, w_ = (t.to(f32) for t in (r, k, v, w))
    uu = u.to(f32)[None, :, :, None]
    ys = []
    for t in range(T):
        kv = torch.einsum("bhc,bhv->bhcv", k_[:, t], v_[:, t])
        ys.append(torch.einsum("bhcv,bhc->bhv", h + uu * kv, r_[:, t]))
        h = h * w_[:, t, :, :, None] + kv
    return torch.stack(ys, dim=1), h


def _pad_steps(t: torch.Tensor, pad: int) -> torch.Tensor:
    # zero steps at the end of dim 1
    return F.pad(t, (0, 0, 0, 0, 0, pad))


def wkv6_chunked(
    r: torch.Tensor,        # [B, T, H, C]
    k: torch.Tensor,
    v: torch.Tensor,
    logw: torch.Tensor,     # [B, T, H, C], log-decay <= 0
    u: torch.Tensor,        # [H, C]
    *,
    h0: torch.Tensor | None = None,   # [B, H, C, C]
    chunk: int = 16,
    states: bool = False,
):
    """The chunked form at Q = min(chunk, T): (y [B, T, H, C] float32,
    final state [B, H, C, C] float32), and with ``states`` the chunk-start
    states [B, T / Q, H, C, C] (T padded up to Q's multiple)."""
    B, T, H, C = r.shape
    f32, f64 = torch.float32, torch.float64
    Q = min(chunk, T)
    pad = (-T) % Q
    r, k, v, logw = (t.to(f32) for t in (r, k, v, logw))
    if pad:
        r, k, v, logw = (_pad_steps(t, pad) for t in (r, k, v, logw))
    nc = (T + pad) // Q
    r_, k_, v_ = (t.reshape(B, nc, Q, H, C) for t in (r, k, v))
    lw = logw.reshape(B, nc, Q, H, C).to(f64)

    cw = torch.cumsum(lw, dim=2)                 # through step t, float64
    cwx = cw - lw                                # before step t (exact in float64)
    total = cw[:, :, -1]                         # [B, nc, H, C]
    r_dec = r_ * torch.exp(cwx.to(f32))
    k_dec = k_ * torch.exp((total[:, :, None] - cw).to(f32))
    chunk_decay = torch.exp(total.to(f32))

    # intra-chunk: y_t += sum_{j<t} A_tj v_j, one step t at a time
    y = torch.empty_like(v_)
    bonus = (r_ * u.to(f32) * k_).sum(-1, keepdim=True)          # [B, nc, Q, H, 1]
    for t in range(Q):
        y_t = bonus[:, :, t] * v_[:, :, t]
        if t:
            E = torch.exp((cwx[:, :, t:t + 1] - cw[:, :, :t]).to(f32))   # [B, nc, t, H, C]
            A = torch.einsum("bnhc,bnjhc,bnjhc->bnjh", r_[:, :, t], k_[:, :, :t], E)
            y_t = y_t + torch.einsum("bnjh,bnjhv->bnhv", A, v_[:, :, :t])
            del E
        y[:, :, t] = y_t

    # the chunks' states in order, then the inter-chunk term
    S_c = torch.einsum("bnjhc,bnjhv->bnhcv", k_dec, v_)
    h = torch.zeros((B, H, C, C), dtype=f32, device=r.device) if h0 is None else h0.to(f32)
    h_starts = []
    for c in range(nc):
        h_starts.append(h)
        h = chunk_decay[:, c, :, :, None] * h + S_c[:, c]
    del S_c
    h_starts = torch.stack(h_starts, dim=1)                       # [B, nc, H, C, V]
    y = y + torch.einsum("bnthc,bnhcv->bnthv", r_dec, h_starts)
    y = y.reshape(B, nc * Q, H, C)[:, :T]
    return (y, h, h_starts) if states else (y, h)


def _sum_before(t: torch.Tensor) -> torch.Tensor:
    # the sum over the steps before each one (dim 2), no term subtracted
    return F.pad(torch.cumsum(t, 2), (0, 0, 0, 0, 1, 0))[:, :, :-1]


def _sum_after(t: torch.Tensor) -> torch.Tensor:
    # the sum over the steps after each one (dim 2)
    return torch.flip(_sum_before(torch.flip(t, (2,))), (2,))


def wkv6_chunked_bwd(
    r: torch.Tensor,          # [B, T, H, C]
    k: torch.Tensor,
    v: torch.Tensor,
    logw: torch.Tensor,       # [B, T, H, C]
    u: torch.Tensor,          # [H, C]
    h_starts: torch.Tensor,   # [B, T / Q, H, C, C]: the forward's chunk-start states
    dy: torch.Tensor,         # [B, T, H, C]
    *,
    dh_final: torch.Tensor | None = None,   # [B, H, C, C]
    chunk: int = 16,
) -> tuple[torch.Tensor, ...]:
    """The backward of :func:`wkv6_chunked` at Q = min(chunk, T):
    (dr, dk, dv, dlogw [B, T, H, C], du [H, C]), float32 (see the module's
    notes)."""
    B, T, H, C = r.shape
    f32, f64 = torch.float32, torch.float64
    Q = min(chunk, T)
    pad = (-T) % Q
    r, k, v, logw, dy = (t.to(f32) for t in (r, k, v, logw, dy))
    if pad:
        r, k, v, logw, dy = (_pad_steps(t, pad) for t in (r, k, v, logw, dy))
    nc = (T + pad) // Q
    r_, k_, v_, dy_ = (t.reshape(B, nc, Q, H, C) for t in (r, k, v, dy))
    lw = logw.reshape(B, nc, Q, H, C).to(f64)
    cw = torch.cumsum(lw, dim=2)
    cwx = cw - lw
    total = cw[:, :, -1]
    e_r = torch.exp(cwx.to(f32))                              # exp(cwx_t)
    e_k = torch.exp((total[:, :, None] - cw).to(f32))         # exp(cw_Q - cw_t)
    chunk_decay = torch.exp(total.to(f32))                    # [B, nc, H, C]

    # the state's gradient at every chunk's end, the chunks in reverse
    G = (torch.zeros((B, H, C, C), dtype=f32, device=r.device) if dh_final is None
         else dh_final.to(f32))
    g_ends = [G] * nc
    for c in range(nc - 1, -1, -1):
        g_ends[c] = G
        G = chunk_decay[:, c, :, :, None] * G + torch.einsum(
            "bthc,bthv->bhcv", r_[:, c] * e_r[:, c], dy_[:, c])
    g_ends = torch.stack(g_ends, dim=1)                       # [B, nc, H, C, V]
    h_starts = h_starts.to(f32)

    # the chunk-boundary terms, and their paths through each step's decay
    dr = e_r * torch.einsum("bnhcv,bnthv->bnthc", h_starts, dy_)
    dk = e_k * torch.einsum("bnhcv,bnthv->bnthc", g_ends, v_)
    dv = torch.einsum("bnhcv,bnthc->bnthv", g_ends, k_ * e_k)
    a, b = r_ * dr, k_ * dk
    dlogw = (chunk_decay * (g_ends * h_starts).sum(-1))[:, :, None] \
        + _sum_after(a) + _sum_before(b)
    del g_ends, a, b
    # inside the chunk: the pairs s < t, one step t at a time
    vd = torch.einsum("bnshv,bnthv->bntsh", v_, dy_)          # vd[t, s] = v_s . dy_t
    for t in range(1, Q):
        E = torch.exp((cwx[:, :, t:t + 1] - cw[:, :, :t]).to(f32))   # [B, nc, t, H, C]
        vdt = vd[:, :, t, :t]                                        # [B, nc, t, H]
        dr[:, :, t] += torch.einsum("bnsh,bnshc->bnhc", vdt, k_[:, :, :t] * E)
        rE = r_[:, :, t:t + 1] * E
        dk[:, :, :t] += vdt[..., None] * rE
        A = (rE * k_[:, :, :t]).sum(-1)                              # A[t, s], [B, nc, t, H]
        dv[:, :, :t] += A[..., None] * dy_[:, :, t:t + 1]
        # P_tj over j < t adds to dlogw_s for j < s < t
        dlogw[:, :, 1:t] += torch.cumsum(vdt[..., None] * rE * k_[:, :, :t], 2)[:, :, :t - 1]
        del E, rE
    # the bonus
    uu = u.to(f32)
    vdd = torch.diagonal(vd, dim1=2, dim2=3).permute(0, 1, 3, 2)[..., None]   # [B, nc, Q, H, 1]
    dr = dr + uu * k_ * vdd
    dk = dk + uu * r_ * vdd
    dv = dv + (r_ * uu * k_).sum(-1, keepdim=True) * dy_
    du = (r_ * k_ * vdd).sum(dim=(0, 1, 2))
    return tuple(t.reshape(B, nc * Q, H, C)[:, :T] for t in (dr, dk, dv, dlogw)) + (du,)
