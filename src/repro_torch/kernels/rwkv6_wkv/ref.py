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
  against.
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
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked form at Q = min(chunk, T): (y [B, T, H, C] float32,
    final state [B, H, C, C] float32)."""
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
    return y.reshape(B, nc * Q, H, C)[:, :T], h
