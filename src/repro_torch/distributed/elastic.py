"""Elastic membership of an RSP mesh: re-deal blocks on host churn.

Node-failure recovery re-deals the failed hosts' RSP blocks
(:func:`redeal_departed`); a joining host triggers :func:`rebalance_join`.
Both are statistically free by Theorem 1: any union of RSP blocks in corpus
proportion is again an RSP block, so moving *where* a block is computed
never changes *what* the estimates see.  The
resulting deal round-trips through the store's ``ownership.json`` sidecar
(:func:`~repro_torch.distributed.ownership.save_ownership`), so a restarted
mesh re-opens exactly the deal it left.  This module imports no model code.
"""

from __future__ import annotations

from typing import Sequence

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
