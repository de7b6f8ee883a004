"""Elastic membership: restore checkpoints onto any mesh, re-deal RSP
blocks on host churn.

Checkpoints store plain host arrays (a sharded state is gathered before it
is written); shardings are derived from the ParamSpec logical axes against
the *target* mesh at restore time (:func:`restore_for_mesh`), so the same
checkpoint restores onto one card, a gloo mesh of four ranks or a
different data/model split.

Node-failure recovery re-deals the failed hosts' RSP blocks
(:func:`redeal_departed`); a joining host triggers :func:`rebalance_join`.
Both are statistically free by Theorem 1: any union of RSP blocks in corpus
proportion is again an RSP block, so moving *where* a block is computed
never changes *what* the estimates see.  The
resulting deal round-trips through the store's ``ownership.json`` sidecar
(:func:`~repro_torch.distributed.ownership.save_ownership`), so a restarted
mesh re-opens exactly the deal it left.

Model-state helpers import the model stack lazily, so the RSP-side churn
helpers stay importable in lightweight (query-only) processes.
"""

from __future__ import annotations

from typing import Any, Sequence

from repro_torch.distributed.ownership import (
    BlockOwnership,
    load_ownership,
    save_ownership,
)


# ---------------------------------------------------------------------------
# RSP block churn (Theorem-1-valid re-deals)
# ---------------------------------------------------------------------------

def redeal_departed(
    ownership: BlockOwnership, departed: Sequence[int], *, store=None
) -> BlockOwnership:
    """Deal departed hosts' blocks round-robin onto the survivors.

    Deterministic given the same departed set (every survivor derives the
    identical map without communicating); persisted to ``store`` when one
    is given so a restarted mesh resumes the post-churn deal."""
    new = ownership.redeal(departed)
    if store is not None:
        save_ownership(store, new)
    return new


def rebalance_join(
    ownership: BlockOwnership, num_hosts: int, *, store=None
) -> BlockOwnership:
    """Fresh balanced deal over ``num_hosts`` (a joining host gets its
    proportional share of blocks; Theorem 1 makes the re-deal free)."""
    new = ownership.rebalance(num_hosts)
    if store is not None:
        save_ownership(store, new)
    return new


def open_or_deal(store, num_blocks: int, num_hosts: int, *, seed: int = 0) -> BlockOwnership:
    """The store's persisted deal when one matches, else a fresh deal
    (persisted).  A stored deal with a different block count or host set is
    replaced -- the store is the source of truth only while it matches the
    mesh it serves."""
    stored = load_ownership(store)
    if (
        stored is not None
        and stored.num_blocks == num_blocks
        and stored.num_hosts == num_hosts
    ):
        return stored
    fresh = BlockOwnership.deal(num_blocks, num_hosts, seed=seed)
    save_ownership(store, fresh)
    return fresh


# ---------------------------------------------------------------------------
# Model-state elasticity (lazy: the model stack)
# ---------------------------------------------------------------------------

def state_shardings(cfg, rules) -> dict:
    """``{"params": param_shardings, "opt": optimizer_shardings}`` of
    ``cfg``'s spec tree under ``rules``."""
    from repro_torch.distributed.sharding import optimizer_shardings, param_shardings
    from repro_torch.models import api

    specs = api.model_specs(cfg)
    return {
        "params": param_shardings(specs, rules),
        "opt": optimizer_shardings(specs, rules),
    }


def reshard_state(state: Any, shardings: Any) -> Any:
    """Every leaf of ``state`` placed at its sharding in ``shardings`` (a
    tree of the same paths): a plain tensor (the same on every rank) keeps
    this rank's chunk; a DTensor on the target mesh is redistributed; a
    DTensor on another mesh is gathered there first (a collective of that
    mesh's ranks) and then placed."""
    from repro_torch.distributed.sharding import gather, is_dtensor, shard_tensor
    from repro_torch.models.common import iter_leaves, set_leaf

    flat = dict(iter_leaves(shardings))
    out: dict = {}
    for path, leaf in iter_leaves(state):
        if path not in flat:
            raise KeyError(f"no sharding for {'/'.join(path)}")
        sh = flat[path]
        if is_dtensor(leaf) and leaf.device_mesh == sh.mesh:
            placed = leaf.redistribute(sh.mesh, sh.placements())
        else:
            placed = shard_tensor(gather(leaf), sh)
        set_leaf(out, path, placed)
    return out


def restore_for_mesh(
    root: str,
    step: int,
    cfg,
    rules,
    *,
    like: Any,
) -> tuple[Any, dict]:
    """Elastic restore: checkpoint (any origin mesh, or one card) ->
    target-mesh state.  ``like`` (a state tree of leaves with a shape and a
    dtype: tensors, meta tensors, ``ShardedMeta``; or None for the stored
    tree as it is) names the leaves to restore, their shapes and their
    dtypes.  Returns ``(state, extra)``."""
    import torch

    from repro_torch.checkpoint import store as ckpt
    from repro_torch.models.common import iter_leaves, set_leaf

    stored, extra = ckpt.restore(root, step, device="cpu")
    if like is not None:
        flat = dict(iter_leaves(stored))
        picked: dict = {}
        for path, want in iter_leaves(like):
            key = ckpt.keystr(path)
            if path not in flat:
                raise KeyError(f"checkpoint missing leaf {key}")
            leaf = flat[path]
            if tuple(leaf.shape) != tuple(want.shape):
                raise ValueError(f"{key}: checkpoint shape {tuple(leaf.shape)} != expected"
                                 f" {tuple(want.shape)}")
            dtype = getattr(want, "dtype", None)
            set_leaf(picked, path, leaf.to(dtype) if isinstance(dtype, torch.dtype) else leaf)
        stored = picked
    return reshard_state(stored, state_shardings(cfg, rules)), extra
