"""``repro_torch.distributed.ownership`` -- which host owns which RSP blocks.

An ownership map is a deterministic deal of the ``K`` stored blocks across
the mesh's hosts (``core.sampler.deal_blocks``: one epoch permutation,
strided across hosts).  Because every RSP block is a random sample of the
corpus (Definition 3) and unions of blocks in corpus proportion are again
RSP blocks (Theorem 1), *any* assignment of blocks to hosts -- and any
re-assignment after a host departs or joins -- is statistically free: the
set of blocks a query folds is unchanged, only where each one is computed
moves.  That theorem is what makes straggler stealing and elastic
re-balancing correctness-preserving operations rather than approximations.

The map round-trips through a stored partition as an ``ownership.json``
sidecar next to the manifest, so a re-started mesh re-opens the same deal.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Sequence

from repro_torch.core.sampler import HostAssignment, deal_blocks

OWNERSHIP_FILE = "ownership.json"


@dataclasses.dataclass(frozen=True)
class BlockOwnership:
    """A validated block -> host deal for one mesh epoch."""

    assignment: HostAssignment
    num_blocks: int
    seed: int = 0
    epoch: int = 0

    def __post_init__(self):
        owner: dict[int, int] = {}
        for h, blocks in self.assignment.host_blocks.items():
            for b in blocks:
                if b in owner:
                    raise ValueError(f"block {b} owned by hosts {owner[b]} and {h}")
                if not 0 <= b < self.num_blocks:
                    raise ValueError(f"block {b} outside [0, {self.num_blocks})")
                owner[b] = int(h)
        if len(owner) != self.num_blocks:
            missing = sorted(set(range(self.num_blocks)) - set(owner))
            raise ValueError(f"blocks {missing[:8]}... have no owner")
        object.__setattr__(self, "_owner", owner)

    @classmethod
    def deal(
        cls, num_blocks: int, num_hosts: int, *, seed: int = 0, epoch: int = 0
    ) -> "BlockOwnership":
        """Deterministic fresh deal (strided epoch permutation)."""
        return cls(
            assignment=deal_blocks(num_blocks, num_hosts, seed=seed, epoch=epoch),
            num_blocks=num_blocks,
            seed=seed,
            epoch=epoch,
        )

    # -- queries -----------------------------------------------------------
    def owner_of(self, block_id: int) -> int:
        return self._owner[int(block_id)]

    def blocks_of(self, host: int) -> list[int]:
        return list(self.assignment.blocks_for(int(host)))

    def hosts(self) -> list[int]:
        return sorted(self.assignment.host_blocks)

    @property
    def num_hosts(self) -> int:
        return len(self.assignment.host_blocks)

    # -- churn (Theorem-1-valid re-deals) ----------------------------------
    def redeal(self, departed: Sequence[int]) -> "BlockOwnership":
        """Re-deal departed hosts' blocks round-robin to the survivors.

        Deterministic given the same departed set, so every survivor derives
        the identical new map without communicating.  Statistically free by
        Theorem 1 (block unions in corpus proportion stay RSP blocks).
        """
        return dataclasses.replace(
            self, assignment=self.assignment.redistribute(departed),
            epoch=self.epoch + 1,
        )

    def rebalance(self, num_hosts: int) -> "BlockOwnership":
        """Fresh balanced deal over ``num_hosts`` hosts (a joining host gets
        its proportional share; Theorem 1 makes the re-deal free)."""
        return BlockOwnership.deal(
            self.num_blocks, num_hosts, seed=self.seed, epoch=self.epoch + 1
        )

    # -- (de)serialization -------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "num_blocks": self.num_blocks,
            "seed": self.seed,
            "epoch": self.epoch,
            "host_blocks": {
                str(h): [int(b) for b in blocks]
                for h, blocks in sorted(self.assignment.host_blocks.items())
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BlockOwnership":
        return cls(
            assignment=HostAssignment(
                {int(h): [int(b) for b in blocks] for h, blocks in d["host_blocks"].items()}
            ),
            num_blocks=int(d["num_blocks"]),
            seed=int(d.get("seed", 0)),
            epoch=int(d.get("epoch", 0)),
        )


def _store_root(store) -> str:
    root = getattr(store, "root", None)
    if root is None:
        raise TypeError("save/load_ownership need an RSPStore (or a .root path)")
    return root


def save_ownership(store, ownership: BlockOwnership) -> str:
    """Persist the deal as an ``ownership.json`` sidecar (atomic replace)."""
    root = _store_root(store)
    path = os.path.join(root, OWNERSHIP_FILE)
    fd, tmp = tempfile.mkstemp(dir=root, suffix=".tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(ownership.to_dict(), f)
    os.replace(tmp, path)
    return path


def load_ownership(store) -> BlockOwnership | None:
    """Load the stored deal, or ``None`` when the store carries none."""
    path = os.path.join(_store_root(store), OWNERSHIP_FILE)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return BlockOwnership.from_dict(json.load(f))
