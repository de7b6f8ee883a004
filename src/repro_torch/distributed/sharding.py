"""Logical-axis sharding on a torch ``DeviceMesh``: maps ParamSpec axis
names to mesh axes, gives the shardings of parameters, optimizer state,
batches and decode caches, places tensors as DTensors, and holds the
activation-constraint hook.

Default rules (DP x TP on a ("data", "model") or ("pod", "data", "model")
mesh), the reference's:
    batch    -> (pod, data)        vocab   -> model
    heads    -> model              ff      -> model
    kv_heads -> model iff the arch has as many kv heads as model ranks and
                they divide (GQA padding waste is bounded); otherwise
                replicated (MQA keeps the single KV head on every model rank)
    experts  -> model              embed   -> replicated
    layers / inner / seq / None -> replicated (stacked / contraction dims)

ZeRO-1: the optimizer's master, m and v additionally shard their largest
unsharded dimension that "data" divides (:func:`zero_shard_spec`).

A :class:`PartitionSpec` is a tuple with one entry a tensor dimension:
``None``, a mesh axis name, or a tuple of names, entry by entry the
reference's ``jax.sharding.PartitionSpec``.  On a real ``DeviceMesh`` a
spec becomes DTensor placements, one a mesh dimension
(:meth:`NamedSharding.placements`): ``Shard(i)`` on every mesh dimension
named in entry ``i``, ``Replicate()`` on the rest.  A tuple entry such as
``("pod", "data")`` shards dimension ``i`` over both, pod major: rank
(p, d) holds shard ``p * D + d``, which is JAX's order.  Rules also derive
on an :class:`AbstractMesh` (names and sizes, no
ranks), where :meth:`NamedSharding.shard_shape` gives the per-rank shapes
the reference's ``NamedSharding.shard_shape`` gives.

Placement is communication-free: every rank holds the same full tensor
(drawn from the same seed or read from the same checkpoint) and keeps its
own chunk (:func:`shard_tensor`); :func:`gather` makes the full tensor
again (an all-gather over the sharded mesh dimensions).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from typing import Any

import torch

# the model stack loads only when a spec or state tree is walked: the
# package's RSP side imports this module and pulls in no model code
Tree = dict

MIN_KV_SHARD = 4

MeshAxes = tuple[str, ...] | str | None


class PartitionSpec(tuple):
    """``PartitionSpec(None, "model")``: one entry a tensor dimension, each
    ``None``, a mesh axis name or a tuple of names."""

    def __new__(cls, *entries: MeshAxes):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes with no process group behind them: the
    counterpart of the reference's ``Mesh`` over repeated host devices.
    ``shape`` maps each axis name to its size, as ``jax.sharding.Mesh``'s
    does; rules and shard shapes derive from it at production sizes."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.axis_sizes} vs axes {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))


def mesh_shape(mesh) -> dict[str, int]:
    """Axis name -> size of an :class:`AbstractMesh` or a named
    ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    names = mesh.mesh_dim_names
    if names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names to carry sharding rules")
    return dict(zip(names, mesh.mesh.shape))


def _names(entry: MeshAxes) -> tuple[str, ...]:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (a ``DeviceMesh`` or an ``AbstractMesh``)."""

    mesh: Any
    spec: PartitionSpec

    def placements(self) -> tuple:
        """DTensor placements, one a mesh dimension, in mesh order."""
        from torch.distributed.tensor import Replicate, Shard

        names = list(mesh_shape(self.mesh))
        out: list = [Replicate()] * len(names)
        for i, entry in enumerate(self.spec):
            pos = []
            for name in _names(entry):
                if name not in names:
                    raise ValueError(f"{self.spec}: the mesh has no axis {name!r} ({names})")
                k = names.index(name)
                if not isinstance(out[k], Replicate):
                    raise ValueError(f"{self.spec}: mesh axis {name!r} is used twice")
                pos.append(k)
                out[k] = Shard(i)
            if pos != sorted(pos):
                raise ValueError(f"{self.spec}: the axes of {entry} are not in mesh order"
                                 f" {tuple(names)}")
        return tuple(out)

    def shard_shape(self, shape) -> tuple[int, ...]:
        """Each rank's shape of a global ``shape`` (every sharded dimension
        divisible, as the reference's ``shard_shape`` requires)."""
        sizes = mesh_shape(self.mesh)
        if len(self.spec) > len(shape):
            raise ValueError(f"{self.spec} has more entries than {tuple(shape)} has dimensions")
        out = []
        for i, dim in enumerate(shape):
            n = math.prod(sizes[a] for a in _names(self.spec[i])) if i < len(self.spec) else 1
            if dim % n:
                raise ValueError(f"dimension {i} of {tuple(shape)} does not divide over"
                                 f" {self.spec[i]} ({n} ranks)")
            out.append(dim // n)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: Any                       # DeviceMesh | AbstractMesh
    rules: dict[str, MeshAxes]

    def spec_for(self, axes: tuple[str | None, ...]) -> PartitionSpec:
        return P(*[self.rules.get(a) if a is not None else None for a in axes])

    def named(self, axes: tuple[str | None, ...]) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec_for(axes))

    def placements(self, spec: PartitionSpec) -> tuple:
        """DTensor placements of ``spec`` on this mesh."""
        return NamedSharding(self.mesh, P(*spec)).placements()


def default_rules(mesh, *, num_kv_heads: int = 8, shard_kv_seq: bool = False,
                  cfg=None) -> ShardingRules:
    """Arch-aware rules.  Every model-axis assignment is gated on
    divisibility, as the reference's jit input shardings require:
      kv_heads: sharded iff kv % model == 0 (MQA/GQA below that replicates
                KV and lets the query-group dim carry the TP split)
      vocab:    sharded iff vocab % model == 0 (hubert's 504 and
                granite-moe's 49155 stay replicated)
      experts:  sharded iff E % model == 0; otherwise the per-expert hidden
                (expert_ff) takes the TP split instead (granite-moe: E=40)
    """
    sizes = mesh_shape(mesh)
    tp = int(sizes["model"]) if "model" in sizes else 1
    dp: MeshAxes = tuple(a for a in ("pod", "data") if a in sizes)
    if len(dp) == 1:
        dp = dp[0]
    if cfg is not None:
        num_kv_heads = cfg.num_kv_heads
        vocab = cfg.vocab_size
        experts = cfg.num_experts
        expert_ff = cfg.d_ff if cfg.num_experts else 0
        d_ff = cfg.d_ff
        head_dim = cfg.resolved_head_dim
    else:
        vocab, experts, expert_ff, d_ff, head_dim = 1 << 20, 0, 0, 1 << 20, 0

    kv_sharded = num_kv_heads % tp == 0 and num_kv_heads >= tp
    experts_sharded = experts > 0 and experts % tp == 0
    rules: dict[str, MeshAxes] = {
        "batch": dp,
        "heads": "model",
        "kv_heads": "model" if kv_sharded else None,
        # with replicated KV the query-group dim carries the TP split instead
        "heads_inner": None if kv_sharded else "model",
        "ff": "model" if d_ff % tp == 0 else None,
        "vocab": "model" if vocab % tp == 0 else None,
        "experts": "model" if experts_sharded else None,
        "expert_ff": None if experts_sharded or expert_ff % tp else "model",
        "embed": None,
        "moe_group": "data" if "data" in sizes else None,
        "kv_seq": "data" if shard_kv_seq and "data" in sizes else None,
        # decode KV caches: when kv heads are unshardable the cache head_dim
        # carries the model split (contraction-sharded attention)
        "kv_head_dim": "model" if (not kv_sharded and head_dim and head_dim % tp == 0) else None,
        "layers": None,
        "inner": None,
    }
    return ShardingRules(mesh=mesh, rules=rules)


# ---------------------------------------------------------------------------
# Param / state shardings
# ---------------------------------------------------------------------------

def _tree_map_path(fn, tree: Tree) -> Tree:
    from repro_torch.models.common import iter_leaves, set_leaf

    out: Tree = {}
    for path, leaf in iter_leaves(tree):
        set_leaf(out, path, fn(path, leaf))
    return out


def _tree_map(fn, tree: Tree) -> Tree:
    return _tree_map_path(lambda _, leaf: fn(leaf), tree)


def param_shardings(specs: Tree, rules: ShardingRules) -> Tree:
    """NamedSharding tree matching a ParamSpec tree."""
    return _tree_map(lambda s: rules.named(s.axes), specs)


def _data_axis_size(mesh) -> int:
    return int(mesh_shape(mesh).get("data", 1))


def zero_shard_spec(spec, rules: ShardingRules) -> PartitionSpec:
    """ZeRO-1: extend the param spec by sharding one replicated dim over
    'data'.  Picks the largest dimension that is unsharded and divisible."""
    base = list(rules.spec_for(spec.axes))
    dsize = _data_axis_size(rules.mesh)
    if dsize <= 1:
        return P(*base)
    cand = [
        (dim_size, i)
        for i, (dim_size, assigned) in enumerate(zip(spec.shape, base))
        if assigned is None and dim_size % dsize == 0 and dim_size >= dsize
    ]
    if not cand:
        return P(*base)
    _, idx = max(cand)
    base[idx] = "data"
    return P(*base)


def optimizer_shardings(specs: Tree, rules: ShardingRules) -> dict:
    """Shardings for the AdamW state {master, m, v, step}."""
    tree = _tree_map(lambda s: NamedSharding(rules.mesh, zero_shard_spec(s, rules)), specs)
    return {"master": tree, "m": tree, "v": tree, "step": NamedSharding(rules.mesh, P())}


def batch_shardings(batch_specs: Tree, rules: ShardingRules) -> Tree:
    """Inputs (leaves with a ``shape``): the leading dim is the global
    batch -> DP axes."""
    dp = rules.rules["batch"]

    def leaf(s):
        spec: list[MeshAxes] = [None] * len(s.shape)
        if s.shape and s.shape[0] > 1:
            spec[0] = dp
        return NamedSharding(rules.mesh, P(*spec))

    return _tree_map(leaf, batch_specs)


# ---------------------------------------------------------------------------
# Placing tensors
# ---------------------------------------------------------------------------

def local_chunk(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's chunk of the full tensor ``t`` under ``placements`` (a
    view; DTensor's ``torch.chunk`` split, nested over the mesh dimensions
    in order).  No communication."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    for k, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(k)
            if n == 1:
                continue
            parts = torch.chunk(t, n, dim=p.dim)
            t = parts[coord[k]] if coord[k] < len(parts) else t.narrow(p.dim, 0, 0)
    return t


def shard_tensor(t: torch.Tensor, sharding: NamedSharding):
    """The DTensor of the full tensor ``t`` (the same on every rank) placed
    at ``sharding``: each rank keeps a contiguous copy of its chunk (no
    copy where the chunk is all of ``t``), on the mesh's device."""
    from torch.distributed.tensor import DTensor

    mesh = sharding.mesh
    placements = sharding.placements()
    if mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(mesh.device_type)
    chunk = local_chunk(t, mesh, placements)
    local = chunk.to(device) if chunk.shape == t.shape else chunk.to(device).clone()
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=t.shape,
                              stride=t.stride() if t.is_contiguous() else None)


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def gather(x):
    """The full tensor of a DTensor (all-gathered over its sharded mesh
    dimensions; its local tensor itself where no dimension of more than one
    rank shards it); anything else as it is."""
    from torch.distributed.tensor import Shard

    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    if all(not isinstance(p, Shard) or mesh.size(k) == 1 for k, p in enumerate(x.placements)):
        return x.to_local()
    return x.full_tensor()


# ---------------------------------------------------------------------------
# Activation constraints (consulted from model code via `constrain`)
# ---------------------------------------------------------------------------

_ACTIVE: contextvars.ContextVar[ShardingRules | None] = contextvars.ContextVar(
    "sharding_rules", default=None
)


@contextlib.contextmanager
def activation_sharding(rules: ShardingRules | None):
    token = _ACTIVE.set(rules)
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def activation_spec(shape, axes: tuple[str | None, ...], rules: ShardingRules) -> PartitionSpec:
    """The spec ``constrain`` resolves for an activation of ``shape``.

    Size-aware: dims of extent 1 stay unsharded (single-stream decode), and
    if two logical axes resolve to the same mesh axis only the first keeps
    it (e.g. batch and kv_seq both wanting 'data' in long-context decode)."""
    if len(axes) != len(shape):
        raise ValueError(f"axes {axes} rank != array rank {len(shape)}")
    used: set[str] = set()
    spec: list[MeshAxes] = []
    for dim, a in zip(shape, axes):
        r = rules.rules.get(a) if a is not None else None
        if r is None or dim <= 1:
            spec.append(None)
            continue
        names = _names(r)
        if any(n in used for n in names):
            spec.append(None)
            continue
        used.update(names)
        spec.append(r)
    return P(*spec)


def constrain(x, axes: tuple[str | None, ...]):
    """The activation sharding constraint against the active rules: a
    no-op outside an :func:`activation_sharding` context.  Under rules a
    DTensor is redistributed to :func:`activation_spec`'s placements.  A
    plain tensor is returned as it is: outside tensor-parallel compute each
    rank holds it whole; inside (``distributed.tensor_parallel``) it is the
    rank's own part, and the layout is checked -- every dimension the spec
    puts on "model" must be one that compute splits."""
    rules = _ACTIVE.get()
    if rules is None:
        return x
    spec = activation_spec(tuple(x.shape), axes, rules)
    if is_dtensor(x):
        return x.redistribute(x.device_mesh, rules.placements(spec))
    from repro_torch.distributed.tensor_parallel import current

    tp = current()
    if tp is not None:
        for a, entry in zip(axes, spec):
            if "model" in _names(entry) and not tp.splits(a):
                raise ValueError(f"{axes}: {a!r} resolves to {entry}, which the"
                                 " tensor-parallel compute does not split")
    return x


def local_caches(caches: Tree, rules: ShardingRules) -> Tree:
    """This rank's chunk of every decode cache leaf at
    :func:`cache_shardings` (a contiguous copy; the length and position
    scalars as they are): the caches a tensor-parallel serving step
    reads and writes."""
    from repro_torch.models.common import iter_leaves, set_leaf

    shardings = dict(iter_leaves(cache_shardings(caches, rules)))
    out: Tree = {}
    for path, leaf in iter_leaves(caches):
        if isinstance(leaf, torch.Tensor) and leaf.ndim:
            leaf = local_chunk(leaf, rules.mesh, shardings[path].placements()).contiguous()
        set_leaf(out, path, leaf)
    return out


def cache_shardings(caches: Tree, rules: ShardingRules) -> Tree:
    """Shardings for decode caches, matched by leaf name.

    Cache layouts (leading dim = stacked layers / invocations):
      attn k/v   [L, B, Hkv, T, D] -> (None, batch, kv_heads, kv_seq, kv_head_dim)
      attn length                  -> replicated
      mamba conv [L, B, K-1, Ch]   -> (None, batch, None, heads)
      mamba ssm  [L, B, H, P, N]   -> (None, batch, heads, None, None)
      rwkv shift [L, B, 1, d]      -> (None, batch, None, None)
      rwkv wkv   [L, B, H, C, C]   -> (None, batch, heads, None, None)
      pos                          -> replicated
    Batch stays replicated when B == 1 (long-context single-stream decode).
    """
    from repro_torch.models.common import iter_leaves, set_leaf

    r = rules.rules

    def spec_for(name: str, shape) -> PartitionSpec:
        def b(dim: int) -> MeshAxes:
            return r["batch"] if shape[dim] > 1 else None

        if name in ("k", "v"):
            return P(None, b(1), r["kv_heads"], r["kv_seq"], r.get("kv_head_dim"))
        if name == "conv":
            return P(None, b(1), None, r["heads"])
        if name in ("ssm", "wkv"):
            return P(None, b(1), r["heads"], None, None)
        if name == "shift":
            return P(None, b(1), None, None)
        return P()  # length / pos scalars

    out: Tree = {}
    for path, leaf in iter_leaves(caches):
        shape = tuple(getattr(leaf, "shape", ()))
        set_leaf(out, path, NamedSharding(rules.mesh, spec_for(path[-1], shape)))
    return out


# ---------------------------------------------------------------------------
# Abstract trees: meta tensors paired with their shardings
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class ShardedMeta:
    """A leaf with no storage: a ``meta`` tensor (shape, dtype) and its
    sharding."""

    meta: torch.Tensor
    sharding: NamedSharding

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.meta.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.meta.dtype


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def attach_shardings(abstract: Tree, shardings: Tree) -> Tree:
    """Pair each leaf of ``abstract`` (anything with a shape and dtype) with
    its sharding, as :class:`ShardedMeta`."""
    from repro_torch.models.common import iter_leaves

    flat = dict(iter_leaves(shardings))
    return _tree_map_path(lambda path, a: ShardedMeta(_meta(a.shape, a.dtype), flat[path]),
                          abstract)


def abstract_state(specs: Tree, rules: ShardingRules) -> dict:
    """The AdamW state with ZeRO shardings, as meta leaves (for a dry run)."""
    tree = _tree_map(lambda s: ShardedMeta(_meta(s.shape, torch.float32),
                                           NamedSharding(rules.mesh, zero_shard_spec(s, rules))),
                     specs)
    return {"master": tree, "m": tree, "v": tree,
            "step": ShardedMeta(_meta((), torch.int32), NamedSharding(rules.mesh, P()))}


def abstract_compute_params(specs: Tree, rules: ShardingRules, dtype=None) -> Tree:
    """The compute parameters (bf16 unless ``dtype``) at their param
    shardings, as meta leaves."""
    dtype = dtype or torch.bfloat16
    return _tree_map(lambda s: ShardedMeta(_meta(s.shape, dtype), rules.named(s.axes)), specs)


def block_ownership(num_blocks: int, hosts=None, *, seed: int = 0):
    """Derive the RSP block -> host deal for a mesh.

    ``hosts`` may be a ``DeviceMesh`` (its rank count), an int, or
    ``None`` (the process group's world size, 1 without a group).  The deal itself is
    ``BlockOwnership.deal``'s deterministic epoch permutation: placement
    never changes the statistics (Theorem 1: any block union in corpus
    proportion is again an RSP block)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.distributed.ownership import BlockOwnership

    if hosts is None:
        num_hosts = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    elif isinstance(hosts, DeviceMesh):
        num_hosts = int(hosts.mesh.numel())
    else:
        num_hosts = int(hosts)
    return BlockOwnership.deal(num_blocks, num_hosts, seed=seed)
