"""AdamW with float32 master weights and bf16 compute parameters.

The state is the reference's tree, nested dicts mirroring the parameters::

    master -- float32 copy of the parameters (the source of truth)
    m, v   -- float32 first and second moments
    step   -- int32 scalar tensor

``adamw_update`` takes the bf16 gradients, clips them to a global norm,
and returns (new_state, new bf16 parameters, stats), with the reference's
arithmetic in float32: the bias corrections ``1 - b ** t`` with ``t``
the new step as float32, weight decay on every leaf.  Unlike the
reference's pure update, the state's master, m and v tensors are updated
in place, leaf by leaf (the returned state holds the same tensors), so a
step needs one leaf's temporaries and not a second copy of the whole
optimizer state; a leaf of more than :data:`SLICE_ELEMS` entries (an MoE
model's stacked experts: 4 GB of float32 in granite-moe-3b-a800m) is
updated in slices along its leading axis, so its temporaries stay a
slice's.  The update is elementwise, so slicing changes no bit; the
squared norm of such a leaf sums its slices' sums.

Under sharding rules (ZeRO-1, ``distributed.sharding``) master, m and v are
DTensors at their optimizer shardings: ``adamw_update`` takes this rank's
float32 gradient chunks at the parameters' shardings (its "model" chunk of
a split leaf, as tensor-parallel compute gives it, already reduced over
the data ranks), clips them by the norm of the full gradient -- the
squares of split leaves summed over the ranks that split them, those of
replicated leaves counted once -- updates only its chunk of each leaf (the
gradient chunk cut over "data"), and places the new bf16 parameters back
at their parameter shardings (an all-gather over "data").  The update
being elementwise, a rank's chunk holds the values a single card computes
for it, up to the norm's order of sums.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.models.common import Tree, iter_leaves, set_leaf


SLICE_ELEMS = 1 << 26   # a leaf past this many entries is updated a slice at a time


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def tree_map(fn, tree: Tree) -> Tree:
    """``fn`` on every leaf of a nested dict, in sorted key order."""
    out: Tree = {}
    for path, leaf in iter_leaves(tree):
        set_leaf(out, path, fn(leaf))
    return out


def leaves(tree: Tree) -> list[Any]:
    """The leaves of a nested dict in sorted key order (jax's flatten order)."""
    return [leaf for _, leaf in iter_leaves(tree)]


def adamw_init(params: Tree) -> dict:
    """{master: float32 copies of ``params``, m and v: zeros, step: 0}."""
    master = tree_map(lambda p: p.to(torch.float32, copy=True), params)
    zeros = lambda: tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                                   device=p.device), params)
    step = torch.zeros((), dtype=torch.int32, device=leaves(master)[0].device)
    return {"master": master, "m": zeros(), "v": zeros(), "step": step}


def _slices(t: torch.Tensor):
    """Index slices covering ``t`` along its leading axis, each of at most
    SLICE_ELEMS entries (one row at least); the whole tensor when it is no
    larger."""
    if t.ndim == 0 or t.numel() <= SLICE_ELEMS:
        return [...]
    rows = max(1, SLICE_ELEMS // (t.numel() // t.shape[0]))
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    parts = [torch.sum(torch.square(g[sl].to(torch.float32))) for sl in _slices(g)]
    return parts[0] if len(parts) == 1 else torch.sum(torch.stack(parts))


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's float32 sum of squares."""
    return torch.sqrt(torch.sum(torch.stack([_square_sum(g) for g in leaves(tree)])))


def _sharded_norm(grads: Tree, shardings: dict) -> torch.Tensor:
    """The global norm of gradient chunks at ``shardings`` (path ->
    ``NamedSharding``): each leaf's squares summed, the sums of leaves split
    over some mesh dimensions all-reduced over those, then added to the
    replicated leaves'."""
    from torch.distributed.tensor import Shard

    from repro_torch.distributed import tensor_parallel as tpl

    buckets: dict[tuple[int, ...], list[torch.Tensor]] = {}
    for path, g in iter_leaves(grads):
        sh = shardings[path]
        dims = tuple(k for k, p in enumerate(sh.placements())
                     if isinstance(p, Shard) and sh.mesh.size(k) > 1)
        buckets.setdefault(dims, []).append(_square_sum(g))
    mesh = next(iter(shardings.values())).mesh
    total = None
    for dims, parts in sorted(buckets.items()):
        s = torch.sum(torch.stack(parts))
        for k in dims:
            tpl.all_reduce(s, mesh.get_group(k))
        total = s if total is None else total + s
    return torch.sqrt(total)


def _local_update_chunk(g: torch.Tensor, mesh, from_placements, to_placements) -> torch.Tensor:
    """The chunk of a gradient chunk ``g`` (at ``from_placements``) that a
    leaf at ``to_placements`` holds: cut over the mesh dimensions only the
    latter shards (ZeRO's "data")."""
    from torch.distributed.tensor import Replicate, Shard

    coord = mesh.get_coordinate()
    for k, (a, b) in enumerate(zip(from_placements, to_placements)):
        if a == b or mesh.size(k) == 1:
            continue
        if not (isinstance(a, Replicate) and isinstance(b, Shard)):
            raise ValueError(f"a gradient at {from_placements} has no chunk at {to_placements}")
        parts = torch.chunk(g, mesh.size(k), dim=b.dim)
        g = parts[coord[k]] if coord[k] < len(parts) else g.narrow(b.dim, 0, 0)
    return g


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)


def clip_by_global_norm(grads: Tree, max_norm: float) -> tuple[Tree, torch.Tensor]:
    """float32 gradients scaled by ``min(1, max_norm / max(norm, 1e-12))``,
    and the norm."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), norm


def _update_leaf(master_leaf, m_leaf, v_leaf, g_leaf, cfg: AdamWConfig, scale, lr, bc1,
                 bc2) -> None:
    """AdamW on one leaf, in place, a slice at a time."""
    for sl in _slices(master_leaf):
        master, m, v = master_leaf[sl], m_leaf[sl], v_leaf[sl]
        g = g_leaf[sl].to(torch.float32) * scale
        m.copy_(cfg.b1 * m + (1.0 - cfg.b1) * g)
        v.copy_(cfg.b2 * v + (1.0 - cfg.b2) * torch.square(g))
        update = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
        master.copy_(master - lr * (update + cfg.weight_decay * master))
        del g, update


def adamw_update(
    state: dict,
    grads: Tree,
    cfg: AdamWConfig,
    *,
    lr_scale: torch.Tensor | float = 1.0,
    compute_dtype=torch.bfloat16,
    param_shardings: Tree | None = None,
) -> tuple[dict, Tree, dict]:
    """Returns (new_state, new_compute_params, {"grad_norm", "lr"}).  The
    gradients are clipped leaf by leaf as the update reads them, with
    ``clip_by_global_norm``'s scale, so no clipped copy of them is held.

    A sharded state (DTensor master, m and v; see the module docstring)
    takes the rank's reduced gradient chunks at ``param_shardings``, the
    parameters' ``NamedSharding`` tree, at which the new parameters are
    placed."""
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import is_dtensor

    sharded = is_dtensor(leaves(state["master"])[0])
    if sharded and param_shardings is None:
        raise ValueError("a sharded optimizer state needs the parameters' shardings")
    shardings = dict(iter_leaves(param_shardings)) if sharded else {}
    norm = _sharded_norm(grads, shardings) if sharded else global_norm(grads)
    scale = _clip_scale(norm, cfg.grad_clip)
    step_in = state["step"]
    step = (step_in.to_local() if is_dtensor(step_in) else step_in) + 1
    t = step.to(torch.float32)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=t.device)  # noqa: E731
    bc1 = 1.0 - f32(cfg.b1) ** t
    bc2 = 1.0 - f32(cfg.b2) ** t
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32, device=t.device)
    new_params: Tree = {}
    for (path, master_leaf), m_leaf, v_leaf, g_leaf in zip(
            iter_leaves(state["master"]), leaves(state["m"]), leaves(state["v"]), leaves(grads)):
        if not sharded:
            _update_leaf(master_leaf, m_leaf, v_leaf, g_leaf, cfg, scale, lr, bc1, bc2)
            set_leaf(new_params, path, master_leaf.to(compute_dtype))
            continue
        mesh, placements = master_leaf.device_mesh, master_leaf.placements
        local = master_leaf.to_local()
        g_chunk = _local_update_chunk(g_leaf, mesh, shardings[path].placements(), placements)
        _update_leaf(local, m_leaf.to_local(), v_leaf.to_local(), g_chunk, cfg, scale, lr, bc1,
                     bc2)
        # the bf16 chunk, then to the parameter's placements (cast first:
        # the all-gather moves half the bytes, and the cast is elementwise)
        chunk = DTensor.from_local(local.to(compute_dtype), mesh, placements, run_check=False,
                                   shape=master_leaf.shape, stride=master_leaf.stride())
        set_leaf(new_params, path, chunk.redistribute(mesh, shardings[path].placements()))
    if is_dtensor(step_in):
        step = DTensor.from_local(step, step_in.device_mesh, step_in.placements, run_check=False)
    new_state = {"master": state["master"], "m": state["m"], "v": state["v"], "step": step}
    return new_state, new_params, {"grad_norm": norm, "lr": lr}
