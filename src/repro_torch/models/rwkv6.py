"""RWKV6 ("Finch") layer: data-dependent-decay linear attention.

Time-mix recurrence (per head, key dim C, value dim V = C):
    S_t = diag(w_t) S_{t-1} + k_t v_t^T
    y_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t
with the per-channel decay w_t = exp(-exp(w0 + lora_w(x))) in (0, 1), data
dependent.  Every pass of more than one step -- a stateless forward or a
prefill from a state -- runs through ``kernels.rwkv6_wkv.wkv6`` (the CUDA
kernel for tensors on the card, its plain chunked version on the host); a
decode step (one step from a state) is one step of the exact recurrence,
``wkv6_scan``, as in the reference.  The reference takes its Pallas kernel
only without a state; the port's kernel also starts from one.

Token-shift mixing is the paper's ddlerp (low-rank data-dependent lerp).

Reference numerics kept here (``repro/models/rwkv6.py``, as XLA computes it
on the host under the reference's jit):

* The token shift concatenates the carried previous token with the
  stream.  A served model's caches are float32, and the concatenation
  promotes: the shifted stream and all the ddlerp arithmetic of a served
  pass are float32.  A stateless pass shifts in bf16: the difference
  ``dx = x_{t-1} - x_t`` and the inner product ``dx * mu_i`` round to
  bf16, and the float32 sums that take them (the inner mix ``x + dx *
  mu_i`` before the low-rank product, and ``x + dx * (mu_i + lora_i)``)
  take them unrounded, as the jitted reference does (XLA drops the bf16
  round trip of the inner sum in front of its float32 cast); found by
  test, bit for bit on the host.
* The time mix's new shift state takes the cache's dtype; the channel
  mix's takes the activations' (bf16), as the reference casts it, so after
  a served prefill the channel mix decodes from a bf16 previous token.
* r, k, v, g, o and the channel mix's projections are bf16 linears; the
  decay's low-rank product and the ddlerp's are float32.  The WKV runs in
  float32; the per-head group norm (population variance, eps) is float32,
  cast to bf16 after ``ln_x``; the gate ``silu(g)``, the channel mix's
  ``relu(k)**2`` and ``sigmoid`` round to bf16 after every operation
  (``models/ffn.py``).

Under tensor parallelism (``distributed.tensor_parallel``; "model" must
divide the heads) the ddlerp and both low-rank products stay replicated,
as in the reference (``d``-wide float32 work on every rank), and each rank
computes its own heads: r, k, v and g from their column chunks, the decay,
the bonus ``u``, the WKV and its group norm on its channels, with ``w0``,
``u``, ``ln_x`` and the decay's ``w_lora_b`` resting replicated and sliced
(entered into the split region, so their gradients sum the ranks' parts),
and ``o`` row-parallel.  The channel mix's key is column-parallel and its
value row-parallel; its receptance stays replicated.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels.rwkv6_wkv import wkv6, wkv6_scan
from repro_torch.models.common import ParamSpec, Tree, linear, linear_spec
from repro_torch.models.ffn import sigmoid, silu


@dataclasses.dataclass(frozen=True)
class RWKV6Config:
    d_model: int
    d_ff: int
    head_dim: int = 64
    lora_rank: int = 32
    norm_eps: float = 1e-5

    @property
    def num_heads(self) -> int:
        return self.d_model // self.head_dim


def rwkv6_timemix_specs(cfg: RWKV6Config) -> Tree:
    d, r = cfg.d_model, cfg.lora_rank
    return {
        "mu_base": ParamSpec((5, d), (None, "embed"), "normal", 0.1),
        "lora_a": ParamSpec((d, r), ("embed", None), "normal"),
        "lora_b": ParamSpec((5, r, d), (None, None, "embed"), "zeros"),
        "w0": ParamSpec((d,), ("embed",), "normal", 0.5),
        "w_lora_a": ParamSpec((d, r), ("embed", None), "normal"),
        "w_lora_b": ParamSpec((r, d), (None, "embed"), "zeros"),
        "u": ParamSpec((d,), ("embed",), "normal", 0.5),
        "r": linear_spec(d, d, ("embed", "heads")),
        "k": linear_spec(d, d, ("embed", "heads")),
        "v": linear_spec(d, d, ("embed", "heads")),
        "g": linear_spec(d, d, ("embed", "heads")),
        "o": linear_spec(d, d, ("heads", "embed")),
        "ln_x": ParamSpec((d,), ("embed",), "ones"),
    }


def rwkv6_channelmix_specs(cfg: RWKV6Config) -> Tree:
    d = cfg.d_model
    return {
        "mu_k": ParamSpec((d,), ("embed",), "normal", 0.1),
        "key": linear_spec(d, cfg.d_ff, ("embed", "ff")),
        "value": linear_spec(cfg.d_ff, d, ("ff", "embed")),
        "receptance": linear_spec(d, d, ("embed", "embed")),
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor | None) -> torch.Tensor:
    """The x_{t-1} stream: x shifted right by one step, ``prev`` (or zeros)
    in front; a float32 ``prev`` promotes the stream to float32, as
    ``jnp.concatenate`` does."""
    if prev is None:
        prev = torch.zeros_like(x[:, :1])
    dtype = torch.promote_types(prev.dtype, x.dtype)
    return torch.cat([prev.to(dtype), x[:, :-1].to(dtype)], dim=1)


def rwkv6_timemix_apply(
    params,
    x: torch.Tensor,                 # [B, L, d]
    cfg: RWKV6Config,
    *,
    state: dict | None = None,       # {"shift": [B, 1, d], "wkv": [B, H, C, C]}
    wkv_impl: str = "auto",
    compute_dtype=torch.bfloat16,
):
    """Returns (out [B, L, d] bf16, new state or None, (y [B, L, H, C],
    h_final [B, H, C, C])), the last the WKV's own, both float32.  The new
    state's tensors are new; the caller writes them into its caches."""
    B, L, d = x.shape
    H, C = cfg.num_heads, cfg.head_dim
    f32 = torch.float32
    prev = state["shift"] if state is not None else None
    with obs.range("rwkv6.ddlerp"):
        xp = _token_shift(x, prev)
        # dx and the inner product dx * mu_base_i in the shifted stream's
        # dtype (bf16 when stateless: both rounded); the sums that take
        # them are float32 and unrounded (see above)
        dx = xp - x.to(xp.dtype)
        mu = params["mu_base"]
        prod = dx[None] * mu.to(x.dtype).to(xp.dtype)[:, None, None, :]
        # ddlerp: x_i = x + dx * (mu_i + lora_i(x + dx * mu_base_i))
        inner = x.to(f32)[None] + prod.to(f32)                       # [5, B, L, d]
        dx = dx.to(f32)
        del prod
        lora_h = torch.tanh(inner @ params["lora_a"].to(f32))        # [5, B, L, r]
        lora = torch.einsum("nblr,nrd->nbld", lora_h, params["lora_b"].to(f32))
        mixed = x.to(f32)[None] + dx[None] * (mu.to(f32)[:, None, None, :] + lora)
        xr, xk, xv, xw, xg = (mixed[i].to(compute_dtype) for i in range(5))
        del inner, lora_h, lora, mixed

    tp = tpl.current()
    if tp is not None and H % tp.size:
        raise ValueError(f"tensor parallelism over {tp.size} ranks needs the {H} RWKV6 heads"
                         " to divide")
    if tp is not None:
        H = H // tp.size
        c0, dl = tp.rank * H * C, H * C            # this rank's channels

        def mine(p: torch.Tensor) -> torch.Tensor:  # a replicated leaf, used sliced
            return tpl.enter(p, tp).narrow(-1, c0, dl)

        xr, xk, xv, xg = (tpl.enter(t, tp) for t in (xr, xk, xv, xg))
    r = constrain(linear(params["r"], xr, compute_dtype=compute_dtype).reshape(B, L, H, C),
                  ("batch", None, "heads", None))
    k = constrain(linear(params["k"], xk, compute_dtype=compute_dtype).reshape(B, L, H, C),
                  ("batch", None, "heads", None))
    v = constrain(linear(params["v"], xv, compute_dtype=compute_dtype).reshape(B, L, H, C),
                  ("batch", None, "heads", None))
    g = linear(params["g"], xg, compute_dtype=compute_dtype)

    if tp is None:
        w_log = params["w0"].to(f32) + (xw.to(f32) @ params["w_lora_a"].to(f32)) @ params[
            "w_lora_b"].to(f32)
        u = params["u"].to(f32).reshape(H, C)
        ln_x = params["ln_x"]
    else:
        lora_w = tpl.enter(xw.to(f32) @ params["w_lora_a"].to(f32), tp)
        w_log = mine(params["w0"]).to(f32) + lora_w @ mine(params["w_lora_b"]).to(f32)
        u = mine(params["u"]).to(f32).reshape(H, C)
        ln_x = mine(params["ln_x"])
    w = torch.exp(-torch.exp(w_log)).reshape(B, L, H, C)          # decay in (0, 1)

    h0 = state["wkv"] if state is not None else None
    r, k, v = r.to(f32), k.to(f32), v.to(f32)
    if state is not None and L == 1:
        y, h_final = wkv6_scan(r, k, v, w, u, h0=h0)              # decode: one step
    else:
        y, h_final = wkv6(r, k, v, w, u, h0=h0, impl=wkv_impl)

    # group norm per head (population variance), then ln_x and the gate
    mu_y = y.mean(-1, keepdim=True)
    var = y.var(-1, unbiased=False, keepdim=True)
    yn = (y - mu_y) * torch.rsqrt(var + cfg.norm_eps)
    yn = (yn.reshape(B, L, H * C) * ln_x.to(f32)).to(compute_dtype)
    out = linear(params["o"], yn * silu(g), compute_dtype=compute_dtype, reduce="heads")

    new_state = None
    if state is not None:
        new_state = {"shift": x[:, -1:, :].to(state["shift"].dtype), "wkv": h_final}
    return out, new_state, (y, h_final)


def rwkv6_channelmix_apply(
    params,
    x: torch.Tensor,
    cfg: RWKV6Config,
    *,
    state: dict | None = None,       # {"shift": [B, 1, d]}
    compute_dtype=torch.bfloat16,
) -> tuple[torch.Tensor, dict | None]:
    """Returns (out [B, L, d] bf16, new state or None); the new shift is in
    x's dtype, as the reference casts it."""
    prev = state["shift"] if state is not None else None
    xp = _token_shift(x, prev)
    dtype = xp.dtype
    xk = x.to(dtype) + (xp - x.to(dtype)) * params["mu_k"].to(x.dtype).to(dtype)
    tp = tpl.current()
    xin = tpl.enter(xk, tp) if tp is not None and tp.splits("ff") else xk
    k = linear(params["key"], xin, compute_dtype=compute_dtype)
    kv = linear(params["value"], torch.square(torch.relu(k)), compute_dtype=compute_dtype,
                reduce="ff")
    rgate = sigmoid(linear(params["receptance"], xk, compute_dtype=compute_dtype))
    new_state = {"shift": x[:, -1:, :]} if state is not None else None
    return rgate * kv, new_state


def init_rwkv_state(cfg: RWKV6Config, batch: int, dtype=torch.bfloat16, device="cuda") -> dict:
    dev = resolve_device(device)
    H, C = cfg.num_heads, cfg.head_dim
    return {
        "time": {
            "shift": torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=dev),
            "wkv": torch.zeros((batch, H, C, C), dtype=torch.float32, device=dev),
        },
        "channel": {"shift": torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=dev)},
    }
