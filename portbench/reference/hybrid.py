"""The Zamba2 hybrid (arXiv:2411.15242) as a plain float32 reference.

Embedding ``e``; then, before every ``attn_every``-th Mamba2 layer, one
call of the single shared transformer block on ``concat(e, h)``; the
Mamba2 layers (pre-norm, residual); a final RMS norm and the unembedding.

* Shared block: ``z = concat(e, h) W_in`` (2d -> d), ``z += attn(rms(z))``
  (causal multi-head attention with RoPE on the halves of each head,
  softmax in float32), ``z += swiglu(rms(z))``, and ``h + z`` goes on.
* Mamba2 layer (the SSD form): ``z, x, B, C`` projections and a float32
  ``dt = softplus(. W_dt + dt_bias)``; a depthwise causal conv over
  ``[x | B | C]`` and ``silu``; per head ``h_t = exp(dt_t a) h_{t-1} +
  dt_t x_t B_t^T``, ``y_t = h_t C_t + D x_t`` with ``a = -exp(A_log)``;
  ``rms(y * silu(z))`` and the output projection.  One group of B and C.

Departures from the published Zamba2-7B, shared with the program (the
configuration file lists them): one shared block where the model
alternates two, attention after the block's input projection (heads of
d / heads), SwiGLU in the shared block, no per-call LoRA adapters, one
B/C group.

The scan is computed in chunks: inside a chunk a masked ``[Q, Q]``
product with decays ``exp(cum_t - cum_s)`` for s <= t, between chunks the
state carried in a loop -- the recurrence's exact sum in another order.
"""

from __future__ import annotations

import math

import torch

from portbench.reference.common import (
    Precision,
    chunked_mean_nll,
    fan_in_std,
    layer,
    maybe_checkpoint,
    rmsnorm,
    silu,
)

CHUNK = 64


def dims(cfg: dict) -> dict:
    d = cfg["d_model"]
    di = cfg.get("ssm_expand", 2) * d
    P = cfg.get("ssm_head_dim", 64)
    return {"d": d, "di": di, "N": cfg["ssm_state"], "H": di // P, "P": P,
            "K": cfg.get("conv_kernel", 4), "period": cfg["attn_every"],
            "D": d // cfg["num_heads"]}


def layout(cfg: dict) -> tuple[int, int, int]:
    """(full rounds, layers a round, epilogue layers)."""
    period = cfg["attn_every"]
    full = cfg["num_layers"] // period
    return full, period, cfg["num_layers"] - full * period


def _residual(cfg: dict) -> float:
    """The scale of a projection that writes into the residual stream:
    1 / sqrt(2 x layers), as GPT-2 scales its residual projections."""
    return 1.0 / math.sqrt(2 * cfg["num_layers"])


def _mamba_specs(cfg: dict, lead: tuple[int, ...]) -> dict:
    m = dims(cfg)
    d, di, N, H, K = m["d"], m["di"], m["N"], m["H"], m["K"]
    mat = lambda a, b: ((*lead, a, b), 0.0, fan_in_std((a, b)))  # noqa: E731
    res = _residual(cfg)
    return {
        ("norm", "scale"): ((*lead, d), 1.0, 0.1),
        ("mamba", "z", "w"): mat(d, di),
        ("mamba", "x", "w"): mat(d, di),
        ("mamba", "B", "w"): mat(d, N),
        ("mamba", "C", "w"): mat(d, N),
        ("mamba", "dt", "w"): mat(d, H),
        ("mamba", "dt_bias"): ((*lead, H), 0.0, 1.0, dt_bias_draw),
        ("mamba", "A_log"): ((*lead, H), 0.0, 1.0, a_log_draw),
        ("mamba", "D"): ((*lead, H), 1.0, 0.1),
        ("mamba", "conv"): ((*lead, K, di + 2 * N), 0.0, 1.0 / math.sqrt(K)),
        ("mamba", "norm"): ((*lead, di), 1.0, 0.1),
        ("mamba", "out", "w"): ((*lead, di, d), 0.0, fan_in_std((di, d)) * res),
    }


def leaf_specs(cfg: dict) -> list[tuple]:
    """(path, shape, mean, std) of every parameter, and for a leaf drawn
    Mamba2's way the function that maps standard normals to it."""
    d, f, V = cfg["d_model"], cfg["d_ff"], cfg["vocab_size"]
    full, period, rem = layout(cfg)
    specs = {("embed", "table"): ((V, d), 0.0, 0.02),
             ("final_norm", "scale"): ((d,), 1.0, 0.1),
             ("unembed", "table"): ((V, d), 0.0, fan_in_std((d, V)))}
    for path, s in _mamba_specs(cfg, (full, period)).items():
        specs[("rounds",) + path] = s
    if rem:
        for path, s in _mamba_specs(cfg, (rem,)).items():
            specs[("epilogue",) + path] = s
    mat = lambda a, b: ((a, b), 0.0, fan_in_std((a, b)))  # noqa: E731
    out = lambda a, b: ((a, b), 0.0, fan_in_std((a, b)) * _residual(cfg))  # noqa: E731
    specs.update({
        ("shared", "in_proj", "w"): out(2 * d, d),
        ("shared", "norm1", "scale"): ((d,), 1.0, 0.1),
        ("shared", "norm2", "scale"): ((d,), 1.0, 0.1),
        ("shared", "attn", "q", "w"): mat(d, d),
        ("shared", "attn", "k", "w"): mat(d, d),
        ("shared", "attn", "v", "w"): mat(d, d),
        ("shared", "attn", "o", "w"): out(d, d),
        ("shared", "mlp", "gate", "w"): mat(d, f),
        ("shared", "mlp", "up", "w"): mat(d, f),
        ("shared", "mlp", "down", "w"): out(f, d),
    })
    return [(path, *specs[path]) for path in sorted(specs)]


def _uniform(z):
    return 0.5 * (1 + torch.erf(z / math.sqrt(2)))     # standard normals to uniform (0, 1)


def dt_bias_draw(z):
    """Mamba2's step bias: the inverse softplus of a step log-uniform in
    [time_step_min, time_step_max] = [0.001, 0.1], floored at 1e-4."""
    dt = torch.exp(math.log(1e-3) + _uniform(z) * (math.log(0.1) - math.log(1e-3)))
    dt = dt.clamp_min(1e-4)
    return dt + torch.log(-torch.expm1(-dt))


def a_log_draw(z):
    """Mamba2's decay rates: the log of a rate uniform in [1, 16]."""
    return torch.log(1 + 15 * _uniform(z))


def ssd(xbar, dA, Bm, Cm, chunk: int = CHUNK):
    """y ``[B, L, H, P]`` of ``h_t = exp(dA_t) h_{t-1} + xbar_t B_t^T, y_t =
    h_t C_t`` from a zero state; xbar ``[B, L, H, P]``, dA ``[B, L, H]``,
    B and C ``[B, L, N]``."""
    Bsz, L, H, P = xbar.shape
    Q = min(chunk, L)
    if L % Q:
        raise ValueError(f"length {L} is not a multiple of the chunk {Q}")
    n = L // Q
    x = xbar.reshape(Bsz, n, Q, H, P)
    a = dA.reshape(Bsz, n, Q, H)
    Bc, Cc = Bm.reshape(Bsz, n, Q, -1), Cm.reshape(Bsz, n, Q, -1)
    cum = torch.cumsum(a, dim=2)                                    # [B, n, Q, H]
    causal = torch.tril(torch.ones(Q, Q, dtype=torch.bool, device=xbar.device))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]            # [B, n, t, s, H]
    W = torch.where(causal[:, :, None], torch.exp(torch.where(causal[:, :, None], diff, 0.0)),
                    0.0)
    CB = Cc @ Bc.transpose(-1, -2)                                  # [B, n, t, s]
    y = torch.einsum("bnts,bntsh,bnshp->bnthp", CB, W, x)
    last = cum[:, :, -1:, :]                                        # [B, n, 1, H]
    xd = x * torch.exp(last - cum)[..., None]                       # decayed to the chunk's end
    S = xbar.new_zeros(Bsz, H, P, Bc.shape[-1])
    inter = []
    for c in range(n):
        # y_t += exp(cum_t) S C_t
        inter.append(torch.einsum("bhpn,btn,bth->bthp", S, Cc[:, c], torch.exp(cum[:, c])))
        S = (torch.exp(last[:, c, 0])[:, :, None, None] * S
             + torch.einsum("bthp,btn->bhpn", xd[:, c], Bc[:, c]))
    y = y + torch.stack(inter, dim=1)
    return y.reshape(Bsz, L, H, P)


def _softplus(x):
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def mamba(p: dict, x: torch.Tensor, cfg: dict, prec: Precision) -> torch.Tensor:
    m = dims(cfg)
    B, L, _ = x.shape
    H, P, N, K = m["H"], m["P"], m["N"], m["K"]
    z = prec.linear(x, p["z"]["w"])
    xbc = torch.cat([prec.linear(x, p["x"]["w"]), prec.linear(x, p["B"]["w"]),
                     prec.linear(x, p["C"]["w"])], dim=-1)
    dt = _softplus(x @ p["dt"]["w"] + p["dt_bias"])                 # float32 in the program too
    xp = torch.cat([xbc.new_zeros(B, K - 1, xbc.shape[-1]), xbc], dim=1)
    conv = sum(xp[:, i:i + L] * p["conv"][i] for i in range(K))
    xi, Bm, Cm = torch.split(silu(conv), [m["di"], N, N], dim=-1)
    a = -torch.exp(p["A_log"])
    xh = xi.reshape(B, L, H, P)
    y = ssd(xh * dt[..., None], dt * a, Bm, Cm) + p["D"][None, None, :, None] * xh
    y = rmsnorm(p["norm"], y.reshape(B, L, m["di"]) * silu(z), cfg.get("norm_eps", 1e-5))
    return prec.linear(y, p["out"]["w"])


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x ``[B, S, H, D]``: the halves of each head rotated by position."""
    S, D = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=x.dtype, device=x.device) / D)
    ang = torch.arange(S, dtype=x.dtype, device=x.device)[:, None] * freqs   # [S, D/2]
    sin, cos = torch.sin(ang)[None, :, None], torch.cos(ang)[None, :, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: dict, x: torch.Tensor, cfg: dict, prec: Precision,
              rows: int = 2) -> torch.Tensor:
    B, S, d = x.shape
    H = cfg["num_heads"]
    D = d // H
    theta = cfg.get("rope_theta", 10000.0)
    q = rope(prec.linear(x, p["q"]["w"]).reshape(B, S, H, D), theta).transpose(1, 2)
    k = rope(prec.linear(x, p["k"]["w"]).reshape(B, S, H, D), theta).transpose(1, 2)
    v = prec.linear(x, p["v"]["w"]).reshape(B, S, H, D).transpose(1, 2)
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    outs = []
    for b in range(0, B, rows):          # a few rows at a time: [rows, H, S, S] scores
        s = (q[b:b + rows] @ k[b:b + rows].transpose(-1, -2)) / math.sqrt(D)
        s = torch.where(mask, s, float("-inf"))
        outs.append(torch.softmax(s, dim=-1) @ v[b:b + rows])
    out = torch.cat(outs).transpose(1, 2).reshape(B, S, d)
    return prec.linear(out, p["o"]["w"])


def shared_block(p: dict, h: torch.Tensor, e: torch.Tensor, cfg: dict,
                 prec: Precision) -> torch.Tensor:
    eps = cfg.get("norm_eps", 1e-5)
    z = prec.linear(torch.cat([e, h], dim=-1), p["in_proj"]["w"])
    z = z + attention(p["attn"], rmsnorm(p["norm1"]["scale"], z, eps), cfg, prec)
    f = rmsnorm(p["norm2"]["scale"], z, eps)
    mlp = p["mlp"]
    z = z + prec.linear(silu(prec.linear(f, mlp["gate"]["w"])) * prec.linear(f, mlp["up"]["w"]),
                        mlp["down"]["w"])
    return h + z


def hidden(params: dict, tokens: torch.Tensor, cfg: dict, prec: Precision,
           remat: bool = True) -> torch.Tensor:
    """Final-normed hidden states [B, S, d], float32."""
    eps = cfg.get("norm_eps", 1e-5)
    full, period, rem = layout(cfg)
    e = prec.act(params["embed"]["table"][tokens.long()])
    h = e

    def mamba_layer(h, p):
        return prec.act(h + mamba(p["mamba"], rmsnorm(p["norm"]["scale"], h, eps), cfg, prec))

    shared = maybe_checkpoint(lambda h, e, p: prec.act(shared_block(p, h, e, cfg, prec)), remat)
    run = maybe_checkpoint(mamba_layer, remat)
    for i in range(cfg["num_layers"]):
        if i % period == 0:
            h = shared(h, e, params["shared"])
        p = (layer(params["rounds"], (i // period, i % period)) if i < full * period
             else layer(params["epilogue"], i - full * period))
        h = run(h, p)
    return rmsnorm(params["final_norm"]["scale"], h, eps)


def logits(params: dict, tokens: torch.Tensor, cfg: dict, prec: Precision) -> torch.Tensor:
    return prec.linear(hidden(params, tokens, cfg, prec, remat=False),
                       params["unembed"]["table"].T)


def loss(params: dict, tokens: torch.Tensor, cfg: dict, prec: Precision) -> torch.Tensor:
    """Mean next-token cross entropy of ``tokens [B, S + 1]``."""
    h = hidden(params, tokens[:, :-1], cfg, prec)
    return chunked_mean_nll(h, params["unembed"]["table"], tokens[:, 1:], prec)
