"""Mamba2 (SSD) layer: projections, the causal depthwise conv, the SSD scan
through the ``mamba2_ssd`` kernel, the gated RMS norm and the output
projection.

The selective state-space recurrence
    h_t = exp(dA_t) * h_{t-1} + (dt_t x_t) B_t^T,      y_t = h_t C_t + D x_t
runs chunk-parallel for a prefill (``kernels.mamba2_ssd.ssd``: the CUDA
kernel for tensors on the card, its plain chunked version on the host) and
as one recurrence step for a decode step (no kernel, as in the reference).

Reference numerics kept here (``repro/models/mamba2.py``): the z / x / B / C
projections are bf16 linears and ``dt`` a float32 one (float32 products stay
float32 on the card: TF32 is off unless a caller turns it on), then
``softplus`` in float32.  The causal conv adds its taps one by one in bf16,
rounding after each multiply and each add, as XLA does on the host
(``conv1d`` would accumulate in float32, through cuDNN's TF32 on the card).
``silu`` on bf16 repeats the reference's arithmetic (``models/ffn.py``).
The scan runs in float32; ``y + D x`` is float32, cast to bf16 before the
gate; the gated product ``y * silu(z)`` enters the norm in float32, not
rounded to bf16, as the reference's XLA program computes it on the host
(it drops the bf16 round trip before the norm's float32 cast).  A decode
state's conv window is held in the caches' dtype (float32 when served) and
cast to bf16 where it is used.

Under tensor parallelism (``distributed.tensor_parallel``; "model" must
divide the heads) a rank computes its own heads: z, x, dt and the SSD on
its chunks; B and C, their conv channels and silu alike on every rank
from their replicated weights, entering the split region in float32 at
the SSD (so their gradient, each rank's heads' part, is summed in float32,
as GSPMD sums the reference's); the gated norm's mean of squares
all-reduced over all of ``d_inner``; and the output projection
row-parallel.  The conv weight and a decode state's conv window rest split
over the concatenated ``[x | B | C]`` channels, which does not line up with
the heads: both are gathered (the x channels' weight gradient
reduce-scattered back, the B and C channels' taken as the rank's chunk),
and the new window is gathered and cut back to the rank's chunk.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels.mamba2_ssd import ssd, ssd_recurrence
from repro_torch.models.common import ParamSpec, Tree, linear, linear_spec, rmsnorm_1d
from repro_torch.models.ffn import silu


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    d_model: int
    d_state: int = 64          # N
    head_dim: int = 64         # P
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 128
    norm_eps: float = 1e-5

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def num_heads(self) -> int:
        return self.d_inner // self.head_dim


def mamba2_specs(cfg: Mamba2Config) -> Tree:
    di, N, H = cfg.d_inner, cfg.d_state, cfg.num_heads
    return {
        "z": linear_spec(cfg.d_model, di, ("embed", "heads")),
        "x": linear_spec(cfg.d_model, di, ("embed", "heads")),
        "B": linear_spec(cfg.d_model, N, ("embed", None)),
        "C": linear_spec(cfg.d_model, N, ("embed", None)),
        "dt": linear_spec(cfg.d_model, H, ("embed", "heads")),
        "dt_bias": ParamSpec((H,), ("heads",), "zeros"),
        "A_log": ParamSpec((H,), ("heads",), "normal", 0.5),
        "D": ParamSpec((H,), ("heads",), "ones"),
        "conv": ParamSpec((cfg.conv_kernel, di + 2 * N), (None, "heads"), "normal", 0.5),
        "norm": ParamSpec((di,), ("heads",), "ones"),
        "out": linear_spec(di, cfg.d_model, ("heads", "embed")),
    }


def _causal_conv(xbc: torch.Tensor, kernel: torch.Tensor,
                 state: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over [B, L, Ch]; returns (out, new_state), the
    new state being the last ``K - 1`` inputs (window included)."""
    Kw = kernel.shape[0]
    if state is None:
        pad = torch.zeros((xbc.shape[0], Kw - 1, xbc.shape[2]), dtype=xbc.dtype, device=xbc.device)
    else:
        pad = state.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)
    new_state = xp[:, xp.shape[1] - (Kw - 1):, :]
    out = torch.zeros_like(xbc)
    L = xbc.shape[1]
    for i in range(Kw):
        out = out + xp[:, i:i + L, :] * kernel[i][None, None, :]
    return out, new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus: logaddexp(x, 0)
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))


def mamba2_apply(
    params,
    x: torch.Tensor,                 # [B, L, d_model]
    cfg: Mamba2Config,
    *,
    state: dict | None = None,       # decode: {"conv": [B, K-1, Ch], "ssm": [B, H, P, N]}
    impl: str = "auto",
    compute_dtype=torch.bfloat16,
) -> tuple[torch.Tensor, dict | None]:
    """Returns (out [B, L, d_model], new state or None).  The new state's
    tensors are new; the caller writes them into its caches."""
    B, L, _ = x.shape
    H, P, N = cfg.num_heads, cfg.head_dim, cfg.d_state
    f32 = torch.float32
    di, Ch = cfg.d_inner, cfg.d_inner + 2 * N
    tp = tpl.current()
    if tp is not None and H % tp.size:
        raise ValueError(f"tensor parallelism over {tp.size} ranks needs the {H} Mamba2 heads"
                         " to divide")
    Hl = H // tp.size if tp is not None else H
    dil = Hl * P                                 # this rank's x channels

    xin = x if tp is None else tpl.enter(x, tp)
    z = linear(params["z"], xin, compute_dtype=compute_dtype)
    xi = linear(params["x"], xin, compute_dtype=compute_dtype)
    Bm = linear(params["B"], x, compute_dtype=compute_dtype)
    Cm = linear(params["C"], x, compute_dtype=compute_dtype)
    dt = _softplus(linear(params["dt"], xin, compute_dtype=f32) + params["dt_bias"].to(f32))

    conv_state = state["conv"] if state is not None else None
    kernel = params["conv"].to(compute_dtype)
    if tp is None:
        xbc, new_conv = _causal_conv(torch.cat([xi, Bm, Cm], dim=-1), kernel, conv_state)
        xbc = silu(xbc)
        xi, Bm, Cm = torch.split(xbc, [dil, N, N], dim=-1)
    else:
        # the depthwise conv channel by channel: the rank's x channels (their
        # weights' gradient summed over the ranks) and all of B and C, which
        # every rank computes alike (their weights' gradient the same on every
        # rank); B and C enter the split region after it, in float32
        a0 = tp.rank * dil
        k_x = tpl.gather(kernel, 1, Ch, tp).narrow(1, a0, dil)
        k_bc = tpl.gather(kernel, 1, Ch, tp, replicated=True).narrow(1, di, 2 * N)
        s_x = s_bc = None
        if conv_state is not None:
            whole = tpl.gather_last(conv_state, Ch, tp)
            s_x, s_bc = whole[..., a0:a0 + dil], whole[..., di:]
        xi, new_x = _causal_conv(xi, k_x, s_x)
        bc, new_bc = _causal_conv(torch.cat([Bm, Cm], dim=-1), k_bc, s_bc)
        xi, bc = silu(xi), silu(bc)
        Bm, Cm = torch.split(bc, [N, N], dim=-1)

    a = -torch.exp(params["A_log"].to(f32))                       # [H], < 0
    dA = dt * a[None, None, :]                                    # [B, L, H] <= 0
    xh = constrain(xi.reshape(B, L, Hl, P).to(f32), ("batch", None, "heads", None))
    xbar = xh * dt[..., None]

    h0 = state["ssm"] if state is not None else None
    if state is not None and L == 1:
        # decode: a single recurrence step
        y, h_final = ssd_recurrence(xbar, dA, Bm, Cm, h0=h0)
    else:
        Bs, Cs = Bm.to(f32), Cm.to(f32)
        if tp is not None:
            Bs, Cs = tpl.enter(Bs, tp), tpl.enter(Cs, tp)
        y, h_final = ssd(xbar, dA, Bs, Cs, chunk=cfg.chunk, h0=h0, impl=impl)

    y = y + params["D"].to(f32)[None, None, :, None] * xh
    y = y.reshape(B, L, dil).to(compute_dtype)
    # the gate's product enters the norm unrounded (float32), as XLA
    # computes the reference's bf16 product before the norm's float32 cast
    if tp is None:
        y = rmsnorm_1d(params["norm"], y.to(f32) * silu(z).to(f32), eps=cfg.norm_eps)
    else:
        y = tpl.rms_norm_split(params["norm"], y.to(f32) * silu(z).to(f32), di,
                               eps=cfg.norm_eps, tp=tp)
    y = y.to(compute_dtype)
    out = linear(params["out"], y, compute_dtype=compute_dtype, reduce="heads")
    new_state = None
    if state is not None:
        if tp is not None:         # the whole window, cut back to the rank's chunk
            whole = torch.cat([tpl.gather_last(new_x, di, tp), new_bc], dim=-1)
            lo, hi = tp.chunk(Ch)
            new_conv = whole[..., lo:hi]
        new_state = {"conv": new_conv.to(state["conv"].dtype), "ssm": h_final}
    return out, new_state


def init_mamba_state(cfg: Mamba2Config, batch: int, dtype=torch.bfloat16, device="cuda") -> dict:
    dev = resolve_device(device)
    return {
        "conv": torch.zeros((batch, cfg.conv_kernel - 1, cfg.d_inner + 2 * cfg.d_state),
                            dtype=dtype, device=dev),
        "ssm": torch.zeros((batch, cfg.num_heads, cfg.head_dim, cfg.d_state), dtype=torch.float32,
                           device=dev),
    }
