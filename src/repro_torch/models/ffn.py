"""Feed-forward blocks: SwiGLU (llama/qwen family) and the GELU MLP
(granite-20b).

The activations repeat the reference's arithmetic in the activations' own
dtype, one rounding per operation, constants rounded to that dtype first:
``jax.nn.sigmoid`` is ``1 / (1 + exp(-x))``, ``jax.nn.silu`` is ``x *
sigmoid(x)`` and ``jax.nn.gelu`` (tanh
approximation, its default) is ``x * (0.5 * (1 + tanh(c * (x + 0.044715 *
x**3))))``.  PyTorch's fused ``F.silu`` / ``F.gelu`` round once from float32
and give other bf16 values for about a third of the inputs.
"""

from __future__ import annotations

import math

import torch

from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.distributed.sharding import constrain
from repro_torch.models.common import Tree, linear, linear_spec


def _const(value: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(value, dtype=like.dtype, device=like.device)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.reciprocal(torch.exp(-x) + _const(1.0, x))


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    inner = x + _const(0.044715, x) * x ** 3
    cdf = _const(0.5, x) * (torch.tanh(_const(math.sqrt(2 / math.pi), x) * inner) + _const(1.0, x))
    return x * cdf


def swiglu_specs(d_model: int, d_ff: int) -> Tree:
    return {
        "gate": linear_spec(d_model, d_ff, ("embed", "ff")),
        "up": linear_spec(d_model, d_ff, ("embed", "ff")),
        "down": linear_spec(d_ff, d_model, ("ff", "embed")),
    }


def _enter_ff(x: torch.Tensor) -> torch.Tensor:
    """``x`` into the ff-split region when the rules split ff over "model"
    (every rank then holds its ff columns of the first products and rows of
    the last, whose partial sums ``linear(reduce="ff")`` adds)."""
    tp = tpl.current()
    return tpl.enter(x, tp) if tp is not None and tp.splits("ff") else x


def swiglu_apply(params, x: torch.Tensor, *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    x = _enter_ff(x)
    g = linear(params["gate"], x, compute_dtype=compute_dtype)
    u = linear(params["up"], x, compute_dtype=compute_dtype)
    h = constrain(silu(g) * u, ("batch", None, "ff"))
    return linear(params["down"], h, compute_dtype=compute_dtype, reduce="ff")


def gelu_mlp_specs(d_model: int, d_ff: int, *, bias: bool = True) -> Tree:
    return {
        "fc1": linear_spec(d_model, d_ff, ("embed", "ff"), bias=bias),
        "fc2": linear_spec(d_ff, d_model, ("ff", "embed"), bias=bias),
    }


def gelu_mlp_apply(params, x: torch.Tensor, *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    h = gelu_tanh(linear(params["fc1"], _enter_ff(x), compute_dtype=compute_dtype))
    h = constrain(h, ("batch", None, "ff"))
    return linear(params["fc2"], h, compute_dtype=compute_dtype, reduce="ff")
