"""The plain version of flash attention: masked softmax attention in
float32, materialising the scores.

``flash_attention_ref(q, k, v, causal=...)`` takes q ``[B, H, S, D]`` and
k, v ``[B, Hkv, S, D]``; query head ``h`` reads kv head ``h // (H / Hkv)``
without expanding k and v.  Scores, softmax and the weighted sum run in
float32; the output has q's dtype.  Masked scores are ``-1e30``, as in the
reference kernel, so a row never divides zero by zero.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


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
    s = torch.einsum("bhgsd,bhtd->bhgst", qg, k.to(torch.float32)) * scale
    if causal:
        keep = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", p, v.to(torch.float32))
    return out.reshape(B, H, S, D).to(q.dtype)
