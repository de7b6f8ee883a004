"""Grouped-query attention: projections, qk-norm, RoPE, prefill through the
flash attention kernel, and token decode against a KV cache.

GQA stays in grouped form: queries ``[B, Hkv, G, S, D]`` against keys and
values ``[B, Hkv, S, D]``, so K/V are never expanded to the full head count.
Prefill goes through ``kernels.flash_attention`` -- the CUDA kernel for
tensors on the card, its plain version on the host (``impl="auto"``).  A
decode step (``S == 1`` with a cache) is plain attention over the whole
float32 cache, masked by position, as in the reference.

Reference numerics kept here, limits included: q, k and v enter attention
in bf16 after RoPE; scores, softmax and accumulators are float32; the
prefill output is bf16.  A prefill with a cache attends only to its own
keys (the reference's ``kg = kh``), so a prefill after a non-empty cache is
unsupported, as in the reference.  The cache is updated in place (a decode
step would otherwise copy every layer's cache); the returned cache dict
holds the same tensors with the new length.

Training differentiates through the same call: with grad on, attention
goes through ``kernels.flash_attention.FlashAttention`` (the forward
kernel with its row log-sum-exp and the backward kernel on the card, the
plain forward and the port of the reference's custom-VJP backward on the
host), in the grouped layout or, with ``cfg.flat``, in the reference's
flat-head layout: K and V repeated G times along the heads, attention in
``[B, H, S, D]``, the repeat's gradient the sum over each group.  On one
card the flat layout only changes memory and the order of sums; it is the
reference's tensor-parallel layout.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models.common import ParamSpec, Tree, apply_rope, linear, linear_spec, rmsnorm_1d

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttentionConfig:
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qk_norm: bool = False
    qkv_bias: bool = False
    rope: bool = True
    rope_theta: float = 10000.0
    causal: bool = True
    norm_eps: float = 1e-5
    k_block: int = 512      # key block of the plain flash backward
    flat: bool = False      # flat-head layout (K/V expanded to H)


def attention_specs(cfg: AttentionConfig) -> Tree:
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "q": linear_spec(cfg.d_model, H * D, ("embed", "heads"), bias=cfg.qkv_bias),
        "k": linear_spec(cfg.d_model, Hkv * D, ("embed", "kv_heads"), bias=cfg.qkv_bias),
        "v": linear_spec(cfg.d_model, Hkv * D, ("embed", "kv_heads"), bias=cfg.qkv_bias),
        "o": linear_spec(H * D, cfg.d_model, ("heads", "embed")),
    }
    if cfg.qk_norm:
        specs["q_norm"] = ParamSpec((D,), (None,), "ones")
        specs["k_norm"] = ParamSpec((D,), (None,), "ones")
    return specs


def attention_apply(
    params,
    x: torch.Tensor,                        # [B, S, d_model]
    cfg: AttentionConfig,
    *,
    positions: torch.Tensor | None = None,  # [S] absolute positions
    cache: dict | None = None,              # {"k", "v": [B, Hkv, T, D], "length": int}
    compute_dtype=torch.bfloat16,
    impl: str = "auto",
) -> tuple[torch.Tensor, dict | None]:
    B, S, _ = x.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // Hkv
    if positions is None:
        positions = torch.arange(S, device=x.device)
        if cache is not None:
            positions = positions + cache["length"]
    tp = tpl.current()
    if tp is not None:
        return _attention_split(params, x, cfg, tp, positions=positions, cache=cache,
                                compute_dtype=compute_dtype, impl=impl)

    q = linear(params["q"], x, compute_dtype=compute_dtype).reshape(B, S, H, D)
    k = linear(params["k"], x, compute_dtype=compute_dtype).reshape(B, S, Hkv, D)
    v = linear(params["v"], x, compute_dtype=compute_dtype).reshape(B, S, Hkv, D)
    if cfg.qk_norm:
        q = rmsnorm_1d(params["q_norm"], q, eps=cfg.norm_eps)
        k = rmsnorm_1d(params["k_norm"], k, eps=cfg.norm_eps)
    if cfg.rope:
        q = apply_rope(q, positions[None, :, None], theta=cfg.rope_theta)
        k = apply_rope(k, positions[None, :, None], theta=cfg.rope_theta)

    kh = k.transpose(1, 2)             # [B, Hkv, S, D] (cache layout), a view
    vh = v.transpose(1, 2)
    qg = q.reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4)   # [B, Hkv, G, S, D]

    new_cache = None
    if cache is not None:
        start = int(cache["length"])
        ck, cv = cache["k"], cache["v"]
        if start + S > ck.shape[2]:
            raise ValueError(f"cache of {ck.shape[2]} positions cannot take {start + S}")
        ck[:, :, start:start + S] = kh
        cv[:, :, start:start + S] = vh
        ck = constrain(ck, ("batch", "kv_heads", "kv_seq", None))
        cv = constrain(cv, ("batch", "kv_heads", "kv_seq", None))
        new_cache = {"k": ck, "v": cv, "length": start + S}

    if cache is not None and S == 1:
        # token decode: grouped attention against the full cache
        qg = constrain(qg, ("batch", "kv_heads", "heads_inner", None, None))
        out = _decode_attention(
            qg, new_cache["k"], new_cache["v"],
            q_positions=positions,
            kv_positions=torch.arange(new_cache["k"].shape[2], device=x.device),
        )
    elif cfg.flat:
        heads = ("batch", "heads", None, None)
        out = flash_flat_cvjp(constrain(q.transpose(1, 2), heads),
                              constrain(kh.repeat_interleave(G, dim=1), heads),
                              constrain(vh.repeat_interleave(G, dim=1), heads),
                              cfg.causal, cfg.k_block, impl=impl)
        out = out.transpose(1, 2).reshape(B, S, H * D).to(compute_dtype)
        out = constrain(out, ("batch", None, "heads"))
        return linear(params["o"], out, compute_dtype=compute_dtype), new_cache
    else:
        qg = constrain(qg, ("batch", "kv_heads", "heads_inner", None, None))
        kh = constrain(kh, ("batch", "kv_heads", None, None))
        vh = constrain(vh, ("batch", "kv_heads", None, None))
        out = flash_attention(qg, kh, vh, causal=cfg.causal, impl=impl, k_block=cfg.k_block)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H * D).to(compute_dtype)
    out = constrain(out, ("batch", None, "heads"))
    return linear(params["o"], out, compute_dtype=compute_dtype), new_cache


def _attention_split(params, x, cfg: AttentionConfig, tp, *, positions, cache, compute_dtype,
                     impl):
    """``attention_apply`` on this rank's whole heads ``[a, b)``
    (``TensorParallel.heads``).  The q columns and o rows are the rank's
    chunks, or gathered and sliced where "model" does not divide the
    heads; kv heads are the rank's chunk when the rules split them, else
    sliced from the replicated projections (whose gradient then sums the
    ranks' parts).  A cache whose kv heads are not split holds every kv
    head, whole or over a head-dim chunk, and a decode step against it
    attends by contraction (:func:`_decode_contracted`).  The o product is
    row-parallel: its partial sums are all-reduced."""
    B, S, _ = x.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // Hkv
    kv_split = tp.splits("kv_heads")
    if cache is not None and S == 1 and not kv_split:
        return _decode_contracted(params, x, cfg, tp, positions=positions, cache=cache,
                                  compute_dtype=compute_dtype)
    a, b = tp.heads(H)
    Hl = b - a
    ka, kb = (a // G, (b - 1) // G + 1) if Hl else (0, 0)
    Kl = kb - ka
    xin = tpl.enter(x, tp)
    q_p = {"w": tpl.gather_heads(params["q"]["w"], 1, H, D, tp)}
    if "b" in params["q"]:
        q_p["b"] = tpl.gather_heads(params["q"]["b"], 0, H, D, tp)
    q = linear(q_p, xin, compute_dtype=compute_dtype).reshape(B, S, Hl, D)

    def kv(name: str) -> torch.Tensor:
        if kv_split:                       # this rank's chunk: exactly its kv heads
            return linear(params[name], xin, compute_dtype=compute_dtype).reshape(B, S, Kl, D)
        p = {"w": tpl.enter(params[name]["w"], tp).narrow(1, ka * D, Kl * D)}
        if "b" in params[name]:
            p["b"] = tpl.enter(params[name]["b"], tp).narrow(0, ka * D, Kl * D)
        return linear(p, xin, compute_dtype=compute_dtype).reshape(B, S, Kl, D)

    def kv_all(name: str) -> torch.Tensor:
        # every kv head (a cache that holds them all), from the replicated weight
        return linear(params[name], x, compute_dtype=compute_dtype).reshape(B, S, Hkv, D)

    whole_cache = cache is not None and not kv_split
    k = kv_all("k") if whole_cache else kv("k")
    v = kv_all("v") if whole_cache else kv("v")
    if cfg.qk_norm:
        q = rmsnorm_1d(tpl.enter(params["q_norm"], tp), q, eps=cfg.norm_eps)
        k = rmsnorm_1d(tpl.enter(params["k_norm"], tp), k, eps=cfg.norm_eps)
    if cfg.rope:
        q = apply_rope(q, positions[None, :, None], theta=cfg.rope_theta)
        k = apply_rope(k, positions[None, :, None], theta=cfg.rope_theta)
    kh, vh = k.transpose(1, 2), v.transpose(1, 2)

    new_cache = None
    if cache is not None:
        start = int(cache["length"])
        ck, cv = cache["k"], cache["v"]
        if start + S > ck.shape[2]:
            raise ValueError(f"cache of {ck.shape[2]} positions cannot take {start + S}")
        d0, d1 = (0, D) if ck.shape[3] == D else tp.chunk(D)
        ck[:, :, start:start + S] = kh[..., d0:d1]
        cv[:, :, start:start + S] = vh[..., d0:d1]
        ck = constrain(ck, ("batch", "kv_heads", "kv_seq", None))
        cv = constrain(cv, ("batch", "kv_heads", "kv_seq", None))
        new_cache = {"k": ck, "v": cv, "length": start + S}
        if whole_cache:
            kh, vh = kh[:, ka:kb], vh[:, ka:kb]

    if Hl == 0:
        out = x.new_zeros((B, S, 0), dtype=compute_dtype)
    elif cache is not None and S == 1:
        # decode against this rank's kv heads (kv split: its groups whole)
        qg = constrain(q.reshape(B, S, Kl, G, D).permute(0, 2, 3, 1, 4),
                       ("batch", "kv_heads", "heads_inner", None, None))
        out = _decode_attention(qg, new_cache["k"], new_cache["v"], q_positions=positions,
                                kv_positions=torch.arange(new_cache["k"].shape[2],
                                                          device=x.device))
        out = out.permute(0, 3, 1, 2, 4).reshape(B, S, Hl * D).to(compute_dtype)
    else:
        grouped = Kl == 1 or (a % G == 0 and b % G == 0)
        if cfg.flat or not grouped:
            # one kv head a q head: the rank's heads need not hold whole groups
            idx = torch.arange(a, b, device=x.device) // G - ka
            kx, vx = kh.index_select(1, idx), vh.index_select(1, idx)
            qt = q.transpose(1, 2)
            if cfg.flat:
                out = flash_flat_cvjp(qt, kx, vx, cfg.causal, cfg.k_block, impl=impl)
            else:
                out = flash_attention(qt[:, :, None], kx, vx, causal=cfg.causal, impl=impl,
                                      k_block=cfg.k_block)[:, :, 0]
            out = out.transpose(1, 2).reshape(B, S, Hl * D).to(compute_dtype)
        else:
            Gl = Hl // Kl
            qg = constrain(q.reshape(B, S, Kl, Gl, D).permute(0, 2, 3, 1, 4),
                           ("batch", "kv_heads", "heads_inner", None, None))
            out = flash_attention(qg, kh, vh, causal=cfg.causal, impl=impl, k_block=cfg.k_block)
            out = out.permute(0, 3, 1, 2, 4).reshape(B, S, Hl * D).to(compute_dtype)
    out = constrain(out, ("batch", None, "heads"))
    o_w = tpl.gather_heads(params["o"]["w"], 0, H, D, tp)
    return linear({"w": o_w}, out, compute_dtype=compute_dtype, reduce="heads"), new_cache


def _decode_contracted(params, x, cfg: AttentionConfig, tp, *, positions, cache,
                       compute_dtype):
    """A decode step against a cache that holds every kv head, over this
    rank's head-dim chunk ``[d0, d1)`` (the rules' ``kv_head_dim``) or
    whole: q of every head (each rank's chunk of the q columns, gathered),
    k and v of every kv head from their replicated projections; the
    scores' partial sums over the head-dim chunks all-reduced, the
    weighted values' chunks gathered, and the o product row-parallel on
    the rank's chunk of its rows."""
    B, S, _ = x.shape
    H, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // Hkv
    q = tpl.gather_last(linear(params["q"], x, compute_dtype=compute_dtype), H * D, tp)
    q = q.reshape(B, S, H, D)
    k = linear(params["k"], x, compute_dtype=compute_dtype).reshape(B, S, Hkv, D)
    v = linear(params["v"], x, compute_dtype=compute_dtype).reshape(B, S, Hkv, D)
    if cfg.qk_norm:
        q = rmsnorm_1d(params["q_norm"], q, eps=cfg.norm_eps)
        k = rmsnorm_1d(params["k_norm"], k, eps=cfg.norm_eps)
    if cfg.rope:
        q = apply_rope(q, positions[None, :, None], theta=cfg.rope_theta)
        k = apply_rope(k, positions[None, :, None], theta=cfg.rope_theta)
    start = int(cache["length"])
    ck, cv = cache["k"], cache["v"]
    if start + S > ck.shape[2]:
        raise ValueError(f"cache of {ck.shape[2]} positions cannot take {start + S}")
    split = ck.shape[3] != D
    d0, d1 = tp.chunk(D) if split else (0, D)
    ck[:, :, start:start + S] = k.transpose(1, 2)[..., d0:d1]
    cv[:, :, start:start + S] = v.transpose(1, 2)[..., d0:d1]
    ck = constrain(ck, ("batch", "kv_heads", "kv_seq", None))
    cv = constrain(cv, ("batch", "kv_heads", "kv_seq", None))
    new_cache = {"k": ck, "v": cv, "length": start + S}

    qg = constrain(q.reshape(B, S, Hkv, G, D).permute(0, 2, 3, 1, 4),
                   ("batch", "kv_heads", "heads_inner", None, None))[..., d0:d1]
    s = torch.einsum("bhgsd,bhtd->bhgst", qg.to(torch.float32), ck.to(torch.float32))
    if split:
        tpl.all_reduce(s, tp.group)
    s = s * (1.0 / (D ** 0.5))
    keep = torch.arange(ck.shape[2], device=x.device)[None, :] <= positions[:, None]
    p = torch.softmax(s.masked_fill(~keep, NEG_INF), dim=-1)
    out = torch.einsum("bhgst,bhtd->bhgsd", p, cv.to(torch.float32))
    if split:
        out = tpl.gather_last(out, D, tp)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, S, H * D).to(compute_dtype)
    out = constrain(out, ("batch", None, "heads"))
    r0, r1 = tp.chunk(H * D)          # the rank's chunk of the o rows
    return linear(params["o"], out[..., r0:r1], compute_dtype=compute_dtype,
                  reduce="heads"), new_cache


def flash_flat_cvjp(q, k, v, causal: bool, k_block: int, *, impl: str = "auto"):
    """The reference's flat flash with its custom VJP: q, k and v ``[B, H,
    S, D]`` (K and V already expanded), the gradient through
    ``FlashAttention`` -- whose plain backward is the port of that VJP,
    walking ``k_block`` keys at a time."""
    return flash_attention(q, k, v, causal=causal, impl=impl, k_block=k_block)


def flash_attention_flat(q, k, v, *, causal: bool, k_block: int, impl: str = "auto"):
    """The reference's flat flash without the custom VJP (its fallback
    when ``k_block`` does not divide S): the same function and gradient
    here, since no block size needs to divide S."""
    return flash_flat_cvjp(q, k, v, causal, k_block, impl=impl)


def _decode_attention(q, k, v, *, q_positions, kv_positions):
    """Single/few-token attention against a (possibly longer) cache, in
    float32, masked by position."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhgsd,bhtd->bhgst", q.to(torch.float32), k.to(torch.float32)) * scale
    keep = kv_positions[None, :] <= q_positions[:, None]
    s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgst,bhtd->bhgsd", p, v.to(torch.float32))


def init_cache(
    cfg: AttentionConfig, batch: int, max_len: int, dtype=torch.bfloat16, device="cuda"
) -> dict:
    dev = resolve_device(device)
    shape = (batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=dev),
        "v": torch.zeros(shape, dtype=dtype, device=dev),
        "length": 0,
    }
