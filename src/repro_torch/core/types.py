"""Core dataclasses for the Random Sample Partition (RSP) data model.

Terminology follows the paper:
  N  -- number of records in the big data set ``D``
  P  -- number of *original* data blocks (the chunking stage)
  K  -- number of RSP data blocks produced
  n  -- records per RSP data block (n = N / K)
  delta -- records per sub-block sliced from a randomized original block.

The paper states ``delta = n / K`` under its experimental setting P == K.  In
general each RSP block is assembled from one sub-block of each of the P
original blocks, hence ``delta = n / P = N / (P * K)``; we implement the
general form and keep the paper's P == K as the default configuration.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass(frozen=True)
class RSPSpec:
    """Static description of an RSP layout of a data set."""

    num_records: int            # N
    num_blocks: int             # K
    num_original_blocks: int    # P
    record_shape: tuple[int, ...] = ()
    dtype: str = "float32"
    seed: int = 0

    def __post_init__(self) -> None:
        if self.num_records <= 0 or self.num_blocks <= 0:
            raise ValueError("num_records and num_blocks must be positive")
        if self.num_records % self.num_blocks != 0:
            raise ValueError(
                f"N={self.num_records} must be divisible by K={self.num_blocks}"
            )
        if self.num_original_blocks <= 0:
            raise ValueError("num_original_blocks must be positive")
        if self.num_records % self.num_original_blocks != 0:
            raise ValueError(
                f"N={self.num_records} must be divisible by P="
                f"{self.num_original_blocks}"
            )
        if (self.num_records // self.num_original_blocks) % self.num_blocks != 0:
            raise ValueError(
                "original block size N/P must be divisible by K so sub-blocks"
                " have uniform size delta = N/(P*K)"
            )

    @property
    def block_size(self) -> int:
        """n -- records per RSP block."""
        return self.num_records // self.num_blocks

    @property
    def original_block_size(self) -> int:
        return self.num_records // self.num_original_blocks

    @property
    def slice_size(self) -> int:
        """delta -- records per sub-block."""
        return self.num_records // (self.num_original_blocks * self.num_blocks)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, payload: str) -> "RSPSpec":
        raw: dict[str, Any] = json.loads(payload)
        raw["record_shape"] = tuple(raw.get("record_shape", ()))
        return cls(**raw)


@dataclasses.dataclass(frozen=True)
class BlockDescriptor:
    """One RSP data block inside a stored RSP (see core.registry)."""

    block_id: int
    num_records: int
    path: str = ""
    checksum: str = ""


@dataclasses.dataclass
class SamplerState:
    """O(1) resumable state of the block-level sampler (Definition 4).

    ``seed``/``epoch`` regenerate the epoch permutation deterministically;
    ``cursor`` is the number of blocks already consumed this epoch.  This pair
    of integers *is* the entire data-pipeline checkpoint.
    """

    seed: int
    epoch: int = 0
    cursor: int = 0

    def to_dict(self) -> dict[str, int]:
        return {"seed": self.seed, "epoch": self.epoch, "cursor": self.cursor}

    @classmethod
    def from_dict(cls, d: dict[str, int]) -> "SamplerState":
        return cls(seed=int(d["seed"]), epoch=int(d["epoch"]), cursor=int(d["cursor"]))
