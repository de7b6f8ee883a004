"""Module substrate of the model zoo: parameter specs, their initialisation
with an explicit ``torch.Generator``, and the basic layers.

A model is described by a nested dict of :class:`ParamSpec` leaves, laid out
as the reference lays it out (layers stacked on a leading axis).  Each spec
carries the reference's logical axis names, one a dimension, which
``distributed.sharding`` maps to the axes of a device mesh.  From that
tree :func:`init_params` makes real float32 values at the reference's
scales; :class:`Params` turns a (per-layer) tree into an ``nn.Module`` whose
leaves are parameters (frozen for serving, trainable for training) and
whose sub-dicts are sub-modules, indexed as ``params["q"]["w"]`` by the
functional layers below.

Layers follow the reference's numerics: every ``linear`` casts ``x`` and
``w`` to ``compute_dtype`` (bfloat16) before the product, norms compute in
float32 and return the input's dtype, RoPE rotates in float32.  They read
whatever dtype the parameters have: serving keeps float32 weights and
casts at every call; training (the reference's ``init_state`` casts every
leaf to bf16, norm scales and the embedding included) hands them bf16
leaves, on which every cast is the identity -- the same values the
reference's training forward reads.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator

import torch
from torch import nn

from repro_torch import obs
from repro_torch.distributed import tensor_parallel as tpl

Tree = dict[str, Any]


# Logical axis vocabulary.  distributed/sharding.py maps these to mesh axes.
#   "batch"   -> (pod, data)        "vocab"   -> model
#   "heads"   -> model              "kv_heads"-> model (if wide enough)
#   "ff"      -> model              "embed"   -> None (replicated)
#   "experts" -> model              "layers"  -> None (stacked layers)
#   "seq"/"kv_seq" -> None (or data for long-context decode)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # a logical axis name (or None) a dimension
    init: str = "normal"          # normal | zeros | ones | embed
    scale: float | None = None    # stddev override for "normal" / "embed"

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes} rank mismatch")


def _fan_in(shape: tuple[int, ...]) -> int:
    # weight layout convention: last dim is output features
    return int(math.prod(shape[:-1])) if len(shape) > 1 else int(shape[0])


def init_scale(spec: ParamSpec) -> float:
    """The standard deviation the reference draws a "normal"/"embed" leaf
    with (``_init_leaf``): the override, else 1 for embeddings and
    ``1 / sqrt(fan_in)`` otherwise -- with the layer axis of a stacked leaf
    counted in its fan-in, as the reference counts it."""
    if spec.scale is not None:
        return spec.scale
    return 1.0 if spec.init == "embed" else 1.0 / math.sqrt(max(_fan_in(spec.shape), 1))


def init_leaf(spec: ParamSpec, generator: torch.Generator, device) -> torch.Tensor:
    """A float32 leaf: zeros, ones, or normal at :func:`init_scale`."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, device=device)
    x = torch.randn(spec.shape, generator=generator, device=device)
    return x.mul_(init_scale(spec))


def iter_leaves(tree: Tree, prefix: tuple[str, ...] = ()) -> Iterator[tuple[tuple[str, ...], Any]]:
    """(path, leaf) pairs of a nested dict, in sorted key order."""
    for name in sorted(tree):
        sub = tree[name]
        if isinstance(sub, dict):
            yield from iter_leaves(sub, prefix + (name,))
        else:
            yield prefix + (name,), sub


def set_leaf(tree: Tree, path: tuple[str, ...], value) -> None:
    for name in path[:-1]:
        tree = tree.setdefault(name, {})
    tree[path[-1]] = value


def init_params(specs: Tree, generator: torch.Generator, device) -> Tree:
    """Real parameter values for a spec tree, drawn leaf by leaf in sorted
    path order from ``generator`` (which lives on ``device``)."""
    out: Tree = {}
    for path, spec in iter_leaves(specs):
        set_leaf(out, path, init_leaf(spec, generator, device))
    return out


def param_count(specs: Tree) -> int:
    """The number of parameters of a spec tree."""
    return sum(math.prod(s.shape) for _, s in iter_leaves(specs))


def stack_specs(specs: Tree, num: int, axis_name: str = "layers") -> Tree:
    """Prepend a stacked dimension, on logical axis ``axis_name``, to every
    leaf."""
    out: Tree = {}
    for path, s in iter_leaves(specs):
        set_leaf(out, path, ParamSpec((num, *s.shape), (axis_name, *s.axes), s.init, s.scale))
    return out


class Params(nn.Module):
    """A tree of parameters as a module: dict leaves become
    ``nn.Parameter``s (frozen unless ``trainable``) sharing the leaves'
    storage, sub-dicts sub-modules.  ``p["q"]["w"]`` and ``"b" in p`` read
    it as the functional layers read the reference's dicts."""

    def __init__(self, tree: Tree, *, trainable: bool = False):
        super().__init__()
        for name in sorted(tree):
            value = tree[name]
            if isinstance(value, dict):
                self.add_module(name, Params(value, trainable=trainable))
            else:
                self.register_parameter(name, nn.Parameter(torch.as_tensor(value),
                                                           requires_grad=trainable))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


# ---------------------------------------------------------------------------
# Basic layers (functional; params are dicts or Params of the spec trees)
# ---------------------------------------------------------------------------

def linear_spec(d_in: int, d_out: int, axes: tuple[str | None, str | None], *,
                bias: bool = False, bias_axis: str | None = None,
                scale: float | None = None) -> Tree:
    out = {"w": ParamSpec((d_in, d_out), axes, "normal", scale)}
    if bias:
        out["b"] = ParamSpec((d_out,), (bias_axis if bias_axis is not None else axes[1],),
                             "zeros")
    return out


def linear(params, x: torch.Tensor, *, compute_dtype=torch.bfloat16,
           reduce: str | None = None) -> torch.Tensor:
    """``x @ w (+ b)`` in ``compute_dtype``.  Under tensor parallelism the
    weight is this rank's chunk: split on its output axis it is
    column-parallel (the caller has entered the split region,
    ``tensor_parallel.enter``); with ``reduce``, the logical axis of its
    input, split there it is row-parallel -- the partial products summed
    over "model" (``leave``) before the bias, which every rank holds
    whole."""
    tp = tpl.current() if reduce is not None else None
    if tp is not None and tp.splits(reduce):
        y = tpl.leave(x.to(compute_dtype) @ cast_weight(params["w"], compute_dtype), tp)
    else:
        y = x.to(compute_dtype) @ cast_weight(params["w"], compute_dtype)
    if "b" in params:
        y = y + cast_weight(params["b"], compute_dtype)
    return y


def cast_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``w`` in ``dtype``.  A narrowing cast (float32 weights served in
    bf16) runs inside a ``models.weight_cast`` range; a weight already in
    ``dtype``, or widened for a float32 product (Mamba2's dt projection in
    bf16 training), opens none."""
    if w.dtype.itemsize <= dtype.itemsize:
        return w.to(dtype)
    with obs.range("models.weight_cast"):
        return w.to(dtype)


def rmsnorm_spec(d: int) -> Tree:
    return {"scale": ParamSpec((d,), ("embed",), "ones")}


def rmsnorm(params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32)).to(x.dtype)


def layernorm_spec(d: int) -> Tree:
    return {"scale": ParamSpec((d,), ("embed",), "ones"),
            "bias": ParamSpec((d,), ("embed",), "zeros")}


def layernorm(params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].to(torch.float32) + params["bias"].to(torch.float32)).to(x.dtype)


def rmsnorm_1d(scale: torch.Tensor, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm over the last dim with an explicit scale vector (qk-norm)."""
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def embedding_spec(vocab: int, d: int, *, scale: float = 0.02) -> Tree:
    return {"table": ParamSpec((vocab, d), ("vocab", "embed"), "embed", scale)}


def _vocab_split() -> "tpl.TensorParallel | None":
    tp = tpl.current()
    return tp if tp is not None and tp.splits("vocab") else None


def embed(params, ids: torch.Tensor, *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    # gather, then cast: the same values as casting the whole table first
    tp = _vocab_split()
    if tp is not None:
        return tpl.vocab_embed(params["table"], ids, compute_dtype, tp)
    return params["table"][ids].to(compute_dtype)


def unembed_logits(params, x: torch.Tensor, *, compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x [.., d] @ table.T -> logits [.., vocab] (a vocab-split table:
    this rank's columns)."""
    tp = _vocab_split()
    if tp is not None:
        x = tpl.enter(x, tp)
    return x.to(compute_dtype) @ cast_weight(params["table"], compute_dtype).T


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10000.0) -> torch.Tensor:
    """x: [..., seq, head_dim]; positions: broadcastable to [..., seq]."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].to(torch.float32) * freqs
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's cross entropy [...] in float32: ``logsumexp`` minus
    the gold logit (vocab-split logits: over every rank's columns,
    ``tensor_parallel.vocab_nll``)."""
    tp = _vocab_split()
    if tp is not None:
        return tpl.vocab_nll(logits, labels, tp)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].to(torch.int64))[..., 0]
    return logz - gold


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, *,
                          mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean of ``token_nll`` over the (optionally masked) positions."""
    nll = token_nll(logits, labels)
    if mask is not None:
        mask = mask.to(torch.float32)
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()


def _chunk_nll_sum(hc: torch.Tensor, table: torch.Tensor, lc: torch.Tensor,
                   compute_dtype) -> torch.Tensor:
    logits = (hc.to(compute_dtype) @ table.to(compute_dtype).T).to(torch.float32)
    return token_nll(logits, lc).sum()


def seq_chunked_cross_entropy(
    h: torch.Tensor,         # [B, S, d] final hidden states
    table: torch.Tensor,     # [V, d] unembedding table
    labels: torch.Tensor,    # [B, S]
    *,
    chunks: int,
    compute_dtype=torch.bfloat16,
) -> torch.Tensor:
    """Mean CE without holding the whole float32 [B, S, V] logits: the
    sequence goes through in ``chunks`` slices, each under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``), so a
    slice's logits are made again in the backward and peak logits memory
    drops by ``chunks``.  When ``chunks`` does not divide S it is the full
    cross entropy, as in the reference.  The sum over every position is
    divided by ``B * S``."""
    B, S, _ = h.shape
    tp = _vocab_split()
    if tp is not None:
        h = tpl.enter(h, tp)      # once: each chunk's product is column-parallel
    if S % chunks:
        logits = h.to(compute_dtype) @ table.to(compute_dtype).T
        return softmax_cross_entropy(logits, labels)
    from torch.utils.checkpoint import checkpoint

    Sc = S // chunks
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    chunk_nll_sum = tpl.carried(_chunk_nll_sum)   # recomputed under the forward's context
    for c in range(chunks):
        sl = slice(c * Sc, (c + 1) * Sc)
        total = total + checkpoint(chunk_nll_sum, h[:, sl], table, labels[:, sl],
                                   compute_dtype, use_reentrant=False)
    return total / (B * S)
