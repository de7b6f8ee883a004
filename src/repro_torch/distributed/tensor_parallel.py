"""Tensor-parallel compute over the "model" mesh axis: what GSPMD does for
the reference when its activations are constrained (``constrain``) and its
parameters rest at ``param_shardings``.

Under :func:`tensor_parallel` each rank holds its own chunk of every
parameter the rules split over "model" (the chunk it rests with, no
gather), and the model code computes its own heads, ff columns, vocab
rows or experts from them.  The stream between layers stays replicated:
every model rank holds the same hidden states and computes the same norms.
A split region is entered and left through the two operators of Megatron's
tensor parallelism, which are the reductions GSPMD inserts:

* :func:`enter` (``f``): the identity forward, an all-reduce of the
  gradient backward -- each rank's gradient of a replicated tensor used in
  the split region is its part of the sum;
* :func:`leave` (``g``): an all-reduce forward (a row-parallel product's
  partial sums), the identity backward.

A parameter that rests replicated but is used sliced inside a region
(RWKV6's ``w0``, ``u``, ``ln_x``, ``w_lora_b``; the kv projections a rank
slices its kv heads from) goes through :func:`enter` itself, so its
gradient is the sum of the ranks' parts and every copy updates alike; a
replicated activation that every rank computes alike and uses whole in
its part (the Mamba2 B and C) enters at its use instead.  A parameter whose chunk does not
line up with what a rank computes (a head count "model" does not divide;
the Mamba2 conv weight over ``[x | B | C]``) is gathered at compute time
(:func:`gather`, whose backward is a reduce-scatter of the gradient back
to the rank's chunk).

Collectives run in the tensors' own dtype: a bf16 product's partial sums
and a bf16 gradient are all-reduced in bf16, as XLA all-reduces them for
the reference.  On a gloo group a CUDA tensor is copied through host
memory for the collective, as the collective partition's exchange runs
on host tensors (``core/partition.py``), and a reduce-scatter is an
all-reduce of which the rank keeps its piece.

The vocab-parallel embedding and cross entropy, the sum of squares over a
split dimension, the head ranges and the local shapes of specs are here
too.  Outside a :func:`tensor_parallel` context, or on a mesh of one model
rank, :func:`current` is ``None`` and the model code takes its unsplit
path, bit for bit.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's place on "model": its coordinate ``rank``, the axis'
    ``size`` and process ``group``, and the rules that say which logical
    axes are split."""

    rules: object            # distributed.sharding.ShardingRules
    rank: int
    size: int
    group: object

    def splits(self, axis: str | None) -> bool:
        """Whether the rules put logical ``axis`` on "model"."""
        if axis is None:
            return False
        r = self.rules.rules.get(axis)
        names = r if isinstance(r, tuple) else (r,)
        return "model" in names

    def chunk(self, n: int) -> tuple[int, int]:
        """[start, stop) of this rank's chunk of a dimension of ``n`` split
        over "model" (``torch.chunk``'s split, as the parameters rest)."""
        return chunk_range(n, self.size, self.rank)

    def heads(self, n: int) -> tuple[int, int]:
        """[start, stop) of this rank's whole heads of ``n``: its chunk when
        "model" divides ``n``, else ``[ceil(r n / M), ceil((r + 1) n /
        M))``: the low ranks take the larger shares (rank 0, which the dry
        run traces, holds the most) and the last may hold none."""
        return (-(-self.rank * n // self.size), -(-(self.rank + 1) * n // self.size))


_TP: contextvars.ContextVar[TensorParallel | None] = contextvars.ContextVar(
    "tensor_parallel", default=None)


def chunk_range(n: int, parts: int, i: int) -> tuple[int, int]:
    """[start, stop) of chunk ``i`` of ``torch.chunk(range(n), parts)``
    (empty past the last chunk)."""
    c = -(-n // parts) if n else 0
    start = min(i * c, n)
    return start, min(start + c, n)


def from_rules(rules) -> TensorParallel | None:
    """This rank's :class:`TensorParallel` on ``rules``' mesh, or None
    when the mesh has no "model" axis of more than one rank."""
    from repro_torch.distributed.sharding import mesh_shape

    sizes = mesh_shape(rules.mesh)
    if int(sizes.get("model", 1)) <= 1:
        return None
    k = list(sizes).index("model")
    coord = rules.mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return TensorParallel(rules, int(coord[k]), int(sizes["model"]),
                          rules.mesh.get_group("model"))


@contextlib.contextmanager
def tensor_parallel(tp: TensorParallel | None):
    """Models built and run inside compute on this rank's shards (``tp``
    None: unsplit)."""
    token = _TP.set(tp)
    try:
        yield tp
    finally:
        _TP.reset(token)


def current() -> TensorParallel | None:
    return _TP.get()


def carried(fn):
    """``fn`` run under the tensor-parallel context and activation rules
    active now, wherever it is called: a function that
    ``torch.utils.checkpoint`` recomputes in the backward runs on the
    autograd engine's device thread, which the contexts do not reach.
    ``fn`` itself outside both."""
    from repro_torch.distributed.sharding import _ACTIVE, activation_sharding

    tp, rules = current(), _ACTIVE.get()
    if tp is None and rules is None:
        return fn

    def run(*args, **kwargs):
        with activation_sharding(rules), tensor_parallel(tp):
            return fn(*args, **kwargs)

    return run


def local_shape(shape, axes, tp: TensorParallel | None = None) -> tuple[int, ...]:
    """The shape of this rank's chunk of a leaf of global ``shape`` on
    logical ``axes`` (``tp``: the active one)."""
    tp = tp or current()
    if tp is None:
        return tuple(shape)
    out = []
    for n, a in zip(shape, axes):
        lo, hi = tp.chunk(n) if tp.splits(a) else (0, n)
        out.append(hi - lo)
    return tuple(out)


# ---------------------------------------------------------------------------
# Collectives (in the tensors' dtype; a gloo group's CUDA tensors staged on the host)
# ---------------------------------------------------------------------------

def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_reduce(t: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` all-reduced over ``group`` in place (through host memory for
    a CUDA tensor on a gloo group); returns ``t``."""
    if _staged(t, group):
        host = t.cpu()
        dist.all_reduce(host, op=op, group=group)
        t.copy_(host)
    else:
        dist.all_reduce(t, op=op, group=group)
    return t


def _sum(t: torch.Tensor, group) -> torch.Tensor:
    # in the tensor's own dtype, as XLA all-reduces a bf16 product's
    # partial sums: half the bytes of float32
    return all_reduce(t.clone(memory_format=torch.contiguous_format), group)


def _gather_chunks(t: torch.Tensor, dim: int, n: int, tp: TensorParallel) -> torch.Tensor:
    """The dimension ``dim`` of size ``n`` made whole from every rank's
    ``torch.chunk`` piece ``t`` (pieces padded to the largest)."""
    c = -(-n // tp.size)
    pad = c - t.shape[dim]
    x = t
    if pad:
        shape = list(t.shape)
        shape[dim] = pad
        x = torch.cat([t, t.new_zeros(shape)], dim)
    x = x.contiguous()
    staged = _staged(x, tp.group)
    src = x.cpu() if staged else x
    parts = [torch.empty_like(src) for _ in range(tp.size)]
    dist.all_gather(parts, src, group=tp.group)
    full = torch.cat(parts, dim).narrow(dim, 0, n)
    return full.to(t.device) if staged else full


def _scatter_chunks(g: torch.Tensor, dim: int, tp: TensorParallel) -> torch.Tensor:
    """This rank's ``torch.chunk`` piece of the sum over ranks of ``g``
    (a reduce-scatter, pieces padded to the largest), float32."""
    n = g.shape[dim]
    c = -(-n // tp.size)
    g = g.to(torch.float32, copy=True)
    if c * tp.size != n:
        shape = list(g.shape)
        shape[dim] = c * tp.size - n
        g = torch.cat([g, g.new_zeros(shape)], dim)
    lo, hi = tp.chunk(n)
    if dist.get_backend(tp.group) == "gloo":
        # a gloo group all-reduces and keeps the rank's piece (its
        # reduce-scatter is missing from some builds)
        return all_reduce(g, tp.group).narrow(dim, lo, hi - lo)
    pieces = [p.contiguous() for p in torch.split(g, c, dim)]
    out = torch.empty_like(pieces[0])
    dist.reduce_scatter(out, pieces, group=tp.group)
    return out.narrow(dim, 0, hi - lo)


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.group), None


class _Leave(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _sum(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, n, tp, summed):
        ctx.dim, ctx.tp, ctx.dtype, ctx.summed = dim, tp, x.dtype, summed
        return _gather_chunks(x, dim, n, tp)

    @staticmethod
    def backward(ctx, grad):
        if ctx.summed:
            g = _scatter_chunks(grad, ctx.dim, ctx.tp)
        else:
            lo, hi = ctx.tp.chunk(grad.shape[ctx.dim])
            g = grad.narrow(ctx.dim, lo, hi - lo)
        return g.to(ctx.dtype), None, None, None, None


def enter(x: torch.Tensor, tp: TensorParallel | None = None) -> torch.Tensor:
    """``f``: ``x`` into a split region (identity; its gradient summed over
    "model").  The identity without a tensor-parallel context."""
    tp = tp or current()
    return x if tp is None else _Enter.apply(x, tp.group)


def leave(x: torch.Tensor, tp: TensorParallel | None = None) -> torch.Tensor:
    """``g``: the sum over "model" of each rank's partial ``x``, in
    ``x``'s dtype (gradient: the identity)."""
    tp = tp or current()
    return x if tp is None else _Leave.apply(x, tp.group)


def all_sum(x: torch.Tensor, tp: TensorParallel | None = None) -> torch.Tensor:
    """The sum over "model" of partial ``x`` used again inside a split
    region (``f(g(x))``: all-reduced forward and backward)."""
    tp = tp or current()
    return x if tp is None else _Enter.apply(_Leave.apply(x, tp.group), tp.group)


def gather(x: torch.Tensor, dim: int, n: int, tp: TensorParallel | None = None, *,
           replicated: bool = False) -> torch.Tensor:
    """Dimension ``dim`` of ``n`` whole again from the ranks' chunks (an
    all-gather).  Its gradient is reduce-scattered back to the chunk --
    the gathered tensor feeds a split region, each rank's gradient a part
    of the sum -- or, ``replicated``, the chunk of a gradient every rank
    holds whole and alike (the gathered tensor feeds replicated
    compute)."""
    tp = tp or current()
    if tp is None or x.shape[dim] == n:
        return x
    return _Gather.apply(x, dim, n, tp, not replicated)


def gather_heads(w: torch.Tensor, dim: int, n_heads: int, head_dim: int,
                 tp: TensorParallel) -> torch.Tensor:
    """This rank's whole heads (:meth:`TensorParallel.heads`) of a weight
    whose dimension ``dim`` of ``n_heads * head_dim`` is split over
    "model": its chunk when the heads divide, else gathered and sliced."""
    lo, hi = tp.heads(n_heads)
    if n_heads % tp.size == 0:
        return w
    full = gather(w, dim, n_heads * head_dim, tp)
    return full.narrow(dim, lo * head_dim, (hi - lo) * head_dim)


# ---------------------------------------------------------------------------
# Vocab-parallel embedding and cross entropy; a norm over a split dimension
# ---------------------------------------------------------------------------

def vocab_embed(table: torch.Tensor, ids: torch.Tensor, compute_dtype,
                tp: TensorParallel) -> torch.Tensor:
    """Rows of a vocab-split table (the rules split the vocab only where
    "model" divides it, so rank r holds rows ``[r n, (r + 1) n)``): each
    rank looks up the ids in its rows (zeros elsewhere) and an all-reduce
    adds them.  One rank holds each row, so the sum is the row, bit for
    bit."""
    n = table.shape[0]
    local = ids.to(torch.int64) - tp.rank * n
    inside = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)]
    rows = torch.where(inside[..., None], rows, torch.zeros((), dtype=rows.dtype,
                                                             device=rows.device))
    return leave(rows, tp).to(compute_dtype)


def vocab_nll(logits: torch.Tensor, labels: torch.Tensor, tp: TensorParallel) -> torch.Tensor:
    """``token_nll`` of vocab-split logits (this rank's columns, as
    :func:`vocab_embed` holds its rows): the max, the sum of exponentials
    and the gold logit all-reduced over "model"; every rank returns the
    same float32 [...]."""
    n = logits.shape[-1]
    lo, hi = tp.rank * n, (tp.rank + 1) * n
    x = logits.to(torch.float32)
    m = x.detach().amax(dim=-1)
    all_reduce(m, tp.group, op=dist.ReduceOp.MAX)
    sumexp = leave(torch.exp(x - m[..., None]).sum(-1), tp)
    local = labels.to(torch.int64) - lo
    inside = (local >= 0) & (local < hi - lo)
    gold = torch.gather(x, -1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = leave(torch.where(inside, gold, torch.zeros((), dtype=gold.dtype,
                                                         device=gold.device)), tp)
    return torch.log(sumexp) + m - gold


def rms_norm_split(scale: torch.Tensor, x: torch.Tensor, n: int, *, eps: float,
                   tp: TensorParallel) -> torch.Tensor:
    """RMS norm over a last dimension of ``n`` split over "model" (x and
    scale this rank's part of it): the sum of squares all-reduced."""
    x32 = x.to(torch.float32)
    ss = all_sum((x32 * x32).sum(dim=-1, keepdim=True), tp)
    return (x32 * torch.rsqrt(ss / n + eps) * scale.to(torch.float32)).to(x.dtype)


def gather_last(x: torch.Tensor, n: int, tp: TensorParallel) -> torch.Tensor:
    """Activations' last dimension of ``n`` whole from the ranks' chunks
    (no gradient: decode)."""
    return _gather_chunks(x, x.ndim - 1, n, tp)


__all__ = ["TensorParallel", "all_reduce", "all_sum", "carried", "chunk_range", "current", "enter",
           "from_rules", "gather", "gather_heads", "gather_last", "leave", "local_shape",
           "rms_norm_split", "tensor_parallel", "vocab_embed", "vocab_nll"]
