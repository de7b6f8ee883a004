"""Block-level data-quality / drift monitoring (paper Sec. 10 extension).

The paper notes that RSP blocks from *different data centres* may follow
different distributions and that a "combination criterion" is needed before
pooling them.  ``DriftMonitor`` operationalizes this: a reference sketch is
built from an initial block-level sample, and every incoming block is scored
with the Sec.-7 toolkit (MMD^2 + per-feature mean z-scores + a variance
ratio).  Blocks that exceed the thresholds are flagged instead of pooled.

The monitor works on its ``device``: the reference blocks' moments come
from :class:`~repro_torch.core.estimators.BlockLevelEstimator`, one
``block_sketch`` launch a reference block on the card (its plain version on
the CPU); MMD^2 and a scored block's mean and spread are plain torch there.
The subsamples are the reference package's ``rng.choice`` draws, made on
the host in the same order (the reference sample in the constructor, then
one per ``score``) and gathered on the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.estimators import BlockLevelEstimator
from repro_torch.core.similarity import median_heuristic_gamma, mmd2_rbf
from repro_torch.device import DEFAULT_DEVICE, as_tensor, resolve_device


@dataclasses.dataclass
class DriftReport:
    block_id: int
    mmd2: float
    max_mean_z: float
    worst_std_ratio: float    # max over features of max(s/s_ref, s_ref/s)
    drifted: bool


class DriftMonitor:
    """Score incoming RSP blocks against a reference block-level sample."""

    def __init__(
        self,
        reference_blocks,                      # [g, n, F] tensor or array
        *,
        mmd_threshold: float | None = None,
        z_threshold: float = 6.0,
        std_ratio_threshold: float = 1.5,
        max_points: int = 512,
        seed: int = 0,
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        self.device = resolve_device(device)
        self.std_ratio_threshold = std_ratio_threshold
        ref = as_tensor(reference_blocks, self.device)
        ref = ref.reshape(ref.shape[0], -1, ref.shape[-1]).to(torch.float32).contiguous()
        self._ref = ref.reshape(-1, ref.shape[-1])
        rng = np.random.default_rng(seed)
        take = min(max_points, self._ref.shape[0])
        idx = rng.choice(self._ref.shape[0], take, replace=False)
        self._ref_sample = self._ref[torch.from_numpy(idx).to(self.device)]
        self._gamma = median_heuristic_gamma(self._ref_sample)
        self._est = BlockLevelEstimator()
        for b in ref:
            self._est.update(b)
        stats = self._est.stats
        self._ref_mean = torch.as_tensor(stats.mean, dtype=torch.float64, device=self.device)
        self._ref_std = torch.as_tensor(stats.std, dtype=torch.float64, device=self.device)
        self._max_points = max_points
        self._rng = rng
        self.history: list[DriftReport] = []

        if mmd_threshold is None:
            # calibrate: MMD^2 between two halves of the reference, x8 margin
            half = self._ref_sample.shape[0] // 2
            base = float(
                mmd2_rbf(self._ref_sample[:half], self._ref_sample[half : 2 * half], self._gamma)
            )
            mmd_threshold = max(abs(base) * 8.0, 1e-3)
        self.mmd_threshold = mmd_threshold
        self.z_threshold = z_threshold

    def score(self, block, block_id: int = -1) -> DriftReport:
        x = as_tensor(block, self.device).reshape(-1, self._ref.shape[-1]).to(torch.float32)
        take = min(self._max_points, x.shape[0])
        idx = self._rng.choice(x.shape[0], take, replace=False)
        xs = x[torch.from_numpy(idx).to(self.device)]
        mmd = float(mmd2_rbf(xs, self._ref_sample, self._gamma))
        # the block's mean and spread in float64 on the device
        x64 = x.to(torch.float64)
        se = self._ref_std / np.sqrt(max(x.shape[0], 1)) + 1e-12
        z = float(((x64.mean(0) - self._ref_mean).abs() / se).max())
        # variance shift: catches dead/clipped features that keep their mean
        s_block = x64.std(0, correction=1) + 1e-12
        s_ref = self._ref_std + 1e-12
        ratio = float(torch.maximum(s_block / s_ref, s_ref / s_block).max())
        report = DriftReport(
            block_id=block_id,
            mmd2=mmd,
            max_mean_z=z,
            worst_std_ratio=ratio,
            drifted=(
                (mmd > self.mmd_threshold)
                or (z > self.z_threshold)
                or (ratio > self.std_ratio_threshold)
            ),
        )
        self.history.append(report)
        return report

    def drifted_blocks(self) -> list[int]:
        return [r.block_id for r in self.history if r.drifted]
