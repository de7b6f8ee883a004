"""The plain versions of flash attention and its gradient, in float32,
materialising the scores.

``flash_attention_ref(q, k, v, causal=...)`` takes q ``[B, H, S, D]`` and
k, v ``[B, Hkv, S, D]``; query head ``h`` reads kv head ``h // (H / Hkv)``
without expanding k and v.  Scores, softmax and the weighted sum run in
float32; the output has q's dtype.  Masked scores are ``-1e30``, as in the
reference kernel, so a row never divides zero by zero.

``flash_attention_stats`` is the same forward that also returns the
float32 output and the reference's row statistics ``(m, l)``
(``_flash_flat_stats``): the running max of the scaled scores and the sum
of ``exp(s - m)``, each ``[B, H, S]``.  ``flash_attention_bwd_ref`` is the
port of the reference's custom-VJP backward (``_flash_flat_cvjp_bwd``,
``src/repro/models/attention.py``): ``Dvec = rowsum(dout * out)``, then
over blocks of ``k_block`` keys ``p = exp(s - m) / l``, ``ds = p (dp -
Dvec) scale``, ``dq += ds k``, ``dk = ds^T q`` and ``dv = p^T dout``; with
grouped heads dk and dv are summed over each kv head's G query heads (the
gradient of the flat layout's ``repeat``).  The gradients have their
inputs' dtypes.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def _scores(q, k, scale, causal, kpos0=0):
    """Scaled float32 scores [B, Hkv, G, S, T] of grouped q against k
    [B, Hkv, T, D], keys numbered from ``kpos0``, masked above the diagonal."""
    s = torch.einsum("bhgsd,bhtd->bhgst", q, k.to(torch.float32)) * scale
    if causal:
        S, T = s.shape[-2:]
        qpos = torch.arange(S, device=q.device)[:, None]
        kpos = torch.arange(kpos0, kpos0 + T, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, NEG_INF)
    return s


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> torch.Tensor:
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    if scale is None:
        scale = 1.0 / D**0.5
    qg = q.reshape(B, Hkv, G, S, D).to(torch.float32)
    p = torch.softmax(_scores(qg, k, scale, causal), dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", p, v.to(torch.float32))
    return out.reshape(B, H, S, D).to(q.dtype)


def flash_attention_stats(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
) -> tuple[torch.Tensor, tuple[torch.Tensor, torch.Tensor]]:
    """(float32 out [B, H, S, D], (m, l)), each statistic [B, H, S]."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    if scale is None:
        scale = 1.0 / D**0.5
    qg = q.reshape(B, Hkv, G, S, D).to(torch.float32)
    s = _scores(qg, k, scale, causal)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", p, v.to(torch.float32))
    out = out / torch.clamp_min(l, 1e-30)[..., None]
    return out.reshape(B, H, S, D), (m.reshape(B, H, S), l.reshape(B, H, S))


def log_sum_exp(m: torch.Tensor, l: torch.Tensor) -> torch.Tensor:
    """The kernel's row statistic from the reference's: ``m + log(max(l, 1e-30))``."""
    return m + torch.log(torch.clamp_min(l, 1e-30))


def flash_attention_bwd_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    dout: torch.Tensor,
    m: torch.Tensor,
    l: torch.Tensor,
    *,
    causal: bool = True,
    scale: float | None = None,
    k_block: int = 512,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's inputs, output and statistics."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    if scale is None:
        scale = 1.0 / D**0.5
    f32 = torch.float32
    qf = q.reshape(B, Hkv, G, S, D).to(f32)
    gf = dout.reshape(B, Hkv, G, S, D).to(f32)
    dvec = (gf * out.reshape(B, Hkv, G, S, D).to(f32)).sum(dim=-1)       # [B, Hkv, G, S]
    mg = m.reshape(B, Hkv, G, S)[..., None]
    lsafe = torch.clamp_min(l.reshape(B, Hkv, G, S), 1e-30)[..., None]
    dq = torch.zeros_like(qf)
    dk = torch.empty((B, Hkv, S, D), dtype=f32, device=q.device)
    dv = torch.empty_like(dk)
    for k0 in range(0, S, k_block):
        kb = k[:, :, k0:k0 + k_block].to(f32)
        vb = v[:, :, k0:k0 + k_block].to(f32)
        p = torch.exp(_scores(qf, kb, scale, causal, k0) - mg) / lsafe       # [B, Hkv, G, S, t]
        dp = torch.einsum("bhgsd,bhtd->bhgst", gf, vb)
        ds = p * (dp - dvec[..., None]) * scale
        dq += torch.einsum("bhgst,bhtd->bhgsd", ds, kb)
        dk[:, :, k0:k0 + k_block] = torch.einsum("bhgst,bhgsd->bhtd", ds, qf)
        dv[:, :, k0:k0 + k_block] = torch.einsum("bhgst,bhgsd->bhtd", p, gf)
    return dq.reshape(B, H, S, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
