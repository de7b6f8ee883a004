"""What the plain references share: the parameter layout they read, the
matrix product in the configuration's precision or one step below it,
norms, and the chunked cross entropy.

Everything is float32 PyTorch with TF32 off.  No kernel, no cache, no
import of the program under test.  A parameter tree is a nested dict of
float32 tensors, layers stacked on a leading axis; ``leaf_specs`` of each
family module lists its leaves as (path, shape, mean, std), which the
benchmark draws from the seed and hands to both sides.

``Precision("fp8")`` is the control: where the program rounds to bf16 --
a linear's operands and output, the activations between layers -- the
control rounds to float8 e4m3 (one scale per tensor), forward and
backward, the products summed in float32.  It is the step below the bf16
the configurations state.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

F32 = torch.float32
FP8_MAX = 448.0


def no_tf32() -> None:
    """Float32 products stay float32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 at one scale for the tensor, back in
    float32."""
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = FP8_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(F32) / scale


class _Fp8Linear(torch.autograd.Function):
    """``x @ w`` with both operands and the product rounded to fp8; in the
    backward the incoming gradient, the operands and both gradients."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = fp8_round(x), fp8_round(w)
        ctx.save_for_backward(xq, wq)
        return fp8_round(xq @ wq)

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = fp8_round(g)
        gx = gq @ wq.T
        gw = xq.reshape(-1, xq.shape[-1]).T @ gq.reshape(-1, gq.shape[-1])
        return fp8_round(gx), fp8_round(gw)


class _Fp8Round(torch.autograd.Function):
    """An activation rounded to fp8, and its gradient in the backward."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g)


class Precision:
    """How a linear multiplies and an activation between layers is held:
    ``None`` in float32, ``"fp8"`` the control."""

    def __init__(self, kind: str | None = None):
        if kind not in (None, "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp8":
            return _Fp8Linear.apply(x, w)
        return x @ w

    def act(self, x: torch.Tensor) -> torch.Tensor:
        return _Fp8Round.apply(x) if self.kind == "fp8" else x


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def layer(tree: dict, i) -> dict:
    """Layer ``i`` of a stacked tree (``i`` an index or a tuple of them)."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's cross entropy, float32."""
    logz = torch.logsumexp(logits, dim=-1)
    return logz - torch.gather(logits, -1, labels[..., None].long())[..., 0]


def chunked_mean_nll(h: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
                     prec: Precision, rows: int = 2048) -> torch.Tensor:
    """Mean next-token cross entropy of hidden states ``h [B, S, d]`` under
    the unembedding ``table [V, d]``, ``rows`` positions at a time, each
    slice's logits made again in the backward."""
    hf, lf = h.reshape(-1, h.shape[-1]), labels.reshape(-1)

    def part(hc, lc):
        return token_nll(prec.linear(hc, table.T), lc).sum()

    total = torch.zeros((), dtype=F32, device=h.device)
    for s in range(0, hf.shape[0], rows):
        total = total + checkpoint(part, hf[s:s + rows], lf[s:s + rows], use_reentrant=False)
    return total / hf.shape[0]


def maybe_checkpoint(fn, remat: bool):
    if not remat:
        return fn
    return lambda *a: checkpoint(fn, *a, use_reentrant=False)


def iter_paths(tree: dict, prefix: tuple = ()):
    for name in sorted(tree):
        sub = tree[name]
        if isinstance(sub, dict):
            yield from iter_paths(sub, prefix + (name,))
        else:
            yield prefix + (name,), sub


def set_path(tree: dict, path: tuple, value) -> None:
    for name in path[:-1]:
        tree = tree.setdefault(name, {})
    tree[path[-1]] = value


def fan_in_std(shape: tuple) -> float:
    """1 / sqrt(fan-in) of a matrix whose last axis is its output."""
    return 1.0 / math.sqrt(shape[-2])
