"""RWKV-6 "Finch" (arXiv:2404.05892) as a plain float32 reference.

Embedding, an input layer norm, ``num_layers`` layers of (layer norm, time
mix, residual; layer norm, channel mix, residual), an output layer norm
and a separate unembedding.  The time mix is the paper's: the ddlerp token
shift (a low-rank data-dependent interpolation of five streams), the
data-dependent per-channel decay ``w_t = exp(-exp(w0 + lora_w(x)))``, the
WKV recurrence per head

    S_t = diag(w_t) S_{t-1} + k_t v_t^T,   y_t = (S_{t-1} + diag(u) k_t v_t^T)^T r_t,

a group norm per head, ``ln_x``, the ``silu(g)`` gate and the output
projection; the channel mix is ``sigmoid(r) * (relu(k)^2 W_v)``.  Departures
from the paper's released code, shared with the program: one token-shift
mix coefficient set ``mu_base`` feeds the ddlerp's inner mix, and the
decay's log is clamped at ``log(1e-38)`` where ``w`` would underflow.

The WKV is computed in chunks of 16 steps: inside a chunk the pairwise
decays ``exp(L_{t-1} - L_s)`` (``L`` the running sum of log-decays, every
exponent <= 0) weight the strictly earlier keys; between chunks the state
is carried in a loop.  That is the recurrence's exact sum in another order.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.common import (
    Precision,
    chunked_mean_nll,
    fan_in_std,
    layer,
    layernorm,
    maybe_checkpoint,
    silu,
)

LOG_DECAY_FLOOR = math.log(1e-38)
CHUNK = 16


def leaf_specs(cfg: dict) -> list[tuple[tuple[str, ...], tuple[int, ...], float, float]]:
    """(path, shape, mean, std) of every parameter."""
    L, d, f, V = cfg["num_layers"], cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    r = cfg.get("lora_rank", 32)
    mat = lambda a, b: ((L, a, b), 0.0, fan_in_std((a, b)))  # noqa: E731
    # projections into the residual stream at 1 / sqrt(2 x layers), as GPT-2's
    out = lambda a, b: ((L, a, b), 0.0, fan_in_std((a, b)) / math.sqrt(2 * L))  # noqa: E731
    specs = {
        ("embed", "table"): ((V, d), 0.0, 0.02),
        ("ln_in", "scale"): ((d,), 1.0, 0.1),
        ("ln_in", "bias"): ((d,), 0.0, 0.02),
        ("ln_out", "scale"): ((d,), 1.0, 0.1),
        ("ln_out", "bias"): ((d,), 0.0, 0.02),
        ("unembed", "table"): ((V, d), 0.0, fan_in_std((d, V))),
    }
    for ln in ("ln1", "ln2"):
        specs[("layers", ln, "scale")] = ((L, d), 1.0, 0.1)
        specs[("layers", ln, "bias")] = ((L, d), 0.0, 0.02)
    t = ("layers", "time")
    specs.update({
        t + ("mu_base",): ((L, 5, d), 0.5, 0.1),
        t + ("lora_a",): mat(d, r),
        t + ("lora_b",): ((L, 5, r, d), 0.0, 0.1),
        t + ("w0",): ((L, d), -3.5, 1.2),        # decays exp(-exp(w0)) from ~0.998 to ~0.7
        t + ("w_lora_a",): mat(d, r),
        t + ("w_lora_b",): ((L, r, d), 0.0, 0.1),
        t + ("u",): ((L, d), 0.0, 0.5),
        t + ("ln_x",): ((L, d), 1.0, 0.1),
    })
    for name in ("r", "k", "v", "g"):
        specs[t + (name, "w")] = mat(d, d)
    specs[t + ("o", "w")] = out(d, d)
    c = ("layers", "channel")
    specs.update({
        c + ("mu_k",): ((L, d), 0.5, 0.1),
        c + ("key", "w"): mat(d, f),
        c + ("value", "w"): out(f, d),
        c + ("receptance", "w"): mat(d, d),
    })
    return [(path, *specs[path]) for path in sorted(specs)]


def wkv(r, k, v, logw, u, chunk: int = CHUNK):
    """y ``[B, T, H, C]`` of the WKV recurrence from a zero state; r, k, v,
    logw ``[B, T, H, C]`` float32, u ``[H, C]``."""
    B, T, H, C = r.shape
    Q = min(chunk, T)
    pad = (-T) % Q
    if pad:
        zeros = lambda x: torch.cat([x, x.new_zeros(B, pad, H, C)], 1)  # noqa: E731
        r, k, v, logw = zeros(r), zeros(k), zeros(v), zeros(logw)
    N = r.shape[1] // Q
    to_chunks = lambda x: x.reshape(B, N, Q, H, C).permute(0, 3, 1, 2, 4)  # [B, H, N, Q, C]  # noqa: E731
    r, k, v, lw = to_chunks(r), to_chunks(k), to_chunks(v), to_chunks(logw)
    cum = torch.cumsum(lw, dim=3)                       # L_t, inclusive
    ex = cum - lw                                       # L_{t-1}
    lower = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=r.device), -1)
    diff = ex[..., :, None, :] - cum[..., None, :, :]   # [B, H, N, t, s, C]
    decay = torch.where(lower[:, :, None], torch.exp(torch.where(lower[:, :, None], diff, 0.0)),
                        0.0)
    att = torch.einsum("bhntc,bhntsc,bhnsc->bhnts", r, decay, k)
    y = att @ v + (r * u[None, :, None, None, :] * k).sum(-1, keepdim=True) * v
    # the state entering each chunk, carried chunk to chunk
    last = cum[..., -1:, :]                              # [B, H, N, 1, C]
    kd = k * torch.exp(last - cum)                       # keys decayed to the chunk's end
    rd = r * torch.exp(ex)                               # queries decayed from its start
    S = r.new_zeros(B, H, C, C)
    inter = []
    for n in range(N):
        inter.append(rd[:, :, n] @ S)
        S = torch.exp(last[:, :, n, 0, :])[..., None] * S + kd[:, :, n].transpose(-1, -2) @ v[:, :, n]
    y = y + torch.stack(inter, dim=2)
    y = y.permute(0, 2, 3, 1, 4).reshape(B, N * Q, H, C)
    return y[:, :T]


def _shift(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def time_mix(p: dict, x: torch.Tensor, cfg: dict, prec: Precision) -> torch.Tensor:
    B, T, d = x.shape
    C = cfg.get("rwkv_head_dim", 64)
    H = d // C
    dx = _shift(x) - x
    inner = x[None] + dx[None] * p["mu_base"][:, None, None, :]         # [5, B, T, d]
    lora = torch.einsum("nbtr,nrd->nbtd", torch.tanh(inner @ p["lora_a"]), p["lora_b"])
    mixed = x[None] + dx[None] * (p["mu_base"][:, None, None, :] + lora)
    xr, xk, xv, xw, xg = mixed.unbind(0)
    r = prec.linear(xr, p["r"]["w"]).reshape(B, T, H, C)
    k = prec.linear(xk, p["k"]["w"]).reshape(B, T, H, C)
    v = prec.linear(xv, p["v"]["w"]).reshape(B, T, H, C)
    g = prec.linear(xg, p["g"]["w"])
    w_log = p["w0"] + (xw @ p["w_lora_a"]) @ p["w_lora_b"]
    logw = torch.clamp(-torch.exp(w_log), min=LOG_DECAY_FLOOR).reshape(B, T, H, C)
    y = wkv(r, k, v, logw, p["u"].reshape(H, C))
    mu = y.mean(-1, keepdim=True)
    var = ((y - mu) ** 2).mean(-1, keepdim=True)
    yn = ((y - mu) * torch.rsqrt(var + cfg.get("norm_eps", 1e-5))).reshape(B, T, d) * p["ln_x"]
    return prec.linear(yn * silu(g), p["o"]["w"])


def channel_mix(p: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    xk = x + (_shift(x) - x) * p["mu_k"]
    kv = prec.linear(torch.relu(prec.linear(xk, p["key"]["w"])) ** 2, p["value"]["w"])
    return torch.sigmoid(prec.linear(xk, p["receptance"]["w"])) * kv


def hidden(params: dict, tokens: torch.Tensor, cfg: dict, prec: Precision,
           remat: bool = True) -> torch.Tensor:
    """Output-normed hidden states [B, T, d], float32."""
    eps = cfg.get("norm_eps", 1e-5)
    h = prec.act(layernorm(params["ln_in"], params["embed"]["table"][tokens.long()], eps))

    def block(h, p):
        h = h + time_mix(p["time"], layernorm(p["ln1"], h, eps), cfg, prec)
        return prec.act(h + channel_mix(p["channel"], layernorm(p["ln2"], h, eps), prec))

    run = maybe_checkpoint(block, remat)
    for i in range(cfg["num_layers"]):
        h = run(h, layer(params["layers"], i))
    return layernorm(params["ln_out"], h, eps)


def logits(params: dict, tokens: torch.Tensor, cfg: dict, prec: Precision) -> torch.Tensor:
    """Every position's logits [B, T, V], float32."""
    return prec.linear(hidden(params, tokens, cfg, prec, remat=False),
                       params["unembed"]["table"].T)


def loss(params: dict, tokens: torch.Tensor, cfg: dict, prec: Precision) -> torch.Tensor:
    """Mean next-token cross entropy of ``tokens [B, T + 1]``."""
    h = hidden(params, tokens[:, :-1], cfg, prec)
    return chunked_mean_nll(h, params["unembed"]["table"], tokens[:, 1:], prec)

