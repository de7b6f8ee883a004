"""Block-level statistics estimation (paper Sec. 8, Figs. 3/4).

Per-block summaries combine with Chan-style parallel moments, so the
estimator is a streaming fold over block-level samples: after ``b`` blocks
the estimate equals the record-level statistic over the union of those
blocks, and (because each block is a random sample) is an unbiased
estimator of the full-data statistic with SE shrinking as 1/sqrt(b*n).
Fixed-grid histograms combine by addition and invert to quantiles.

A block's moments (:func:`block_moments`) come from the ``block_sketch``
kernel in its moments-only mode (``bins=0``) on a CUDA tensor and from its
plain PyTorch version on a CPU tensor; the fold is host numpy, copied from
the reference package.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import as_numpy

@dataclasses.dataclass
class MomentStats:
    """Count / mean / M2 (+ extrema) per feature, combinable."""

    count: float
    mean: np.ndarray
    m2: np.ndarray
    min: np.ndarray
    max: np.ndarray

    @property
    def variance(self) -> np.ndarray:
        return self.m2 / np.maximum(self.count - 1.0, 1.0)

    @property
    def std(self) -> np.ndarray:
        return np.sqrt(self.variance)

    @property
    def stderr(self) -> np.ndarray:
        return self.std / np.sqrt(max(self.count, 1.0))


def combine_moments(a: MomentStats, b: MomentStats) -> MomentStats:
    """Chan et al. parallel combine -- exact, order-independent (delegates
    to the shared :func:`repro_torch.core.moments.chan_merge`)."""
    from repro_torch.core.moments import chan_merge

    n, mean, m2 = chan_merge(a.count, a.mean, a.m2, b.count, b.mean, b.m2)
    return MomentStats(
        count=n,
        mean=mean,
        m2=m2,
        min=np.minimum(a.min, b.min),
        max=np.maximum(a.max, b.max),
    )


def block_moments(block, *, impl: str = "auto") -> MomentStats:
    """Count / mean / M2 / extrema of one block (features flatten), in
    float32 like the reference's jit ``_block_moments``: one
    ``block_sketch`` call with ``bins=0`` (``impl="auto"``: the CUDA kernel
    on a CUDA tensor, the plain version on a CPU tensor)."""
    from repro_torch.kernels.block_sketch import block_sketch

    sk = block_sketch(block, bins=0, impl=impl)
    # the sketch's float64 fields hold float32 values: the casts are exact
    mean, m2, mn, mx = (np.asarray(a, np.float32) for a in (sk.mean, sk.m2, sk.min, sk.max))
    return MomentStats(count=float(block.shape[0]), mean=mean, m2=m2, min=mn, max=mx)


class BlockLevelEstimator:
    """Streaming block-level estimator with convergence history (Figs. 3/4).
    ``impl`` selects the sketch of each block (see :func:`block_moments`)."""

    def __init__(self, *, impl: str = "auto") -> None:
        self.impl = impl
        self._acc: MomentStats | None = None
        self.history_mean: list[np.ndarray] = []
        self.history_std: list[np.ndarray] = []
        self.blocks_seen = 0

    def update(self, block) -> None:
        stats = block_moments(block, impl=self.impl)
        self._acc = stats if self._acc is None else combine_moments(self._acc, stats)
        self.blocks_seen += 1
        self.history_mean.append(self._acc.mean.copy())
        self.history_std.append(self._acc.std.copy())

    def consume(
        self,
        blocks,
        *,
        rel_tol: float | None = None,
        window: int = 3,
    ) -> "BlockLevelEstimator":
        """Fold a block stream (e.g. ``BlockExecutor.map_blocks(None, ids)``)
        into the estimator.  With ``rel_tol`` set, stop early once
        :meth:`converged` fires -- on a prefetching stream the next blocks are
        already in flight, so the scan overlaps fetch and combine."""
        for block in blocks:
            self.update(block)
            if rel_tol is not None and self.converged(rel_tol, window):
                break
        return self

    @property
    def stats(self) -> MomentStats:
        if self._acc is None:
            raise ValueError("no blocks consumed yet")
        return self._acc

    def converged(self, rel_tol: float = 1e-3, window: int = 3) -> bool:
        """Plateau test: relative change of the mean over the last ``window``
        updates below ``rel_tol`` (the paper's stopping idea applied to
        estimation)."""
        if len(self.history_mean) <= window:
            return False
        cur = self.history_mean[-1]
        prev = self.history_mean[-1 - window]
        denom = np.maximum(np.abs(cur), 1e-12)
        return bool(np.max(np.abs(cur - prev) / denom) < rel_tol)


def streaming_estimate(
    executor,
    ids: Sequence[int],
    *,
    rel_tol: float | None = None,
    window: int = 3,
    impl: str = "auto",
) -> BlockLevelEstimator:
    """Run the block-level estimation loop over an executor's prefetched
    stream: ``executor`` is anything with ``map_blocks(fn, ids)`` (see
    ``repro_torch.rsp.engine.BlockExecutor``); blocks load ahead of the
    combine, and each is sketched on its device."""
    return BlockLevelEstimator(impl=impl).consume(
        executor.map_blocks(None, ids), rel_tol=rel_tol, window=window
    )


def batched_block_moments(blocks: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-block (mean, std with ddof=1) of a stacked block sample
    ``[g, n, ...]``, in float32 on the blocks' device."""
    x = blocks.reshape(blocks.shape[0], blocks.shape[1], -1).to(torch.float32)
    return x.mean(dim=1), x.std(dim=1, correction=1)


def block_histogram(block, *, bins: int, lo, hi) -> np.ndarray:
    """Fixed-grid histogram per feature [F, bins]; combinable by addition (for
    block-level quantile estimation).  ``lo`` / ``hi`` are scalars or
    per-feature arrays.  Mass outside ``[lo, hi]`` is clipped into the edge
    bins -- every histogram sums to the block's record count, so merged
    histograms stay consistent with merged counts (values beyond the grid
    used to be dropped silently, biasing tail quantiles inward)."""
    from repro_torch.kernels.block_sketch.ref import _grid, grid_histogram

    x = as_numpy(block).astype(np.float64)
    x = x.reshape(x.shape[0], -1)
    glo, ghi = _grid(lo, hi, x.shape[1])
    return grid_histogram(x, glo, ghi, bins)


def quantile_from_histogram(
    hist: np.ndarray, qs: Sequence[float], *, lo, hi
) -> np.ndarray:
    """Per-feature quantiles [F, Q] from a combined histogram [F, bins],
    linearly interpolated *within* the covering bin (quantiles used to snap
    to the bin's upper edge, a +half-bin-width bias).  ``lo`` / ``hi`` are
    scalars or per-feature arrays matching the histogram's grid."""
    hist = np.asarray(hist, dtype=np.float64)
    f, bins = hist.shape
    lo = np.broadcast_to(np.asarray(lo, dtype=np.float64), (f,))
    hi = np.broadcast_to(np.asarray(hi, dtype=np.float64), (f,))
    width = (hi - lo) / bins                                     # [F]
    qs = np.asarray(qs, dtype=np.float64)
    cdf = np.cumsum(hist, axis=-1)                               # [F, bins]
    total = np.maximum(cdf[:, -1:], 1.0)                         # [F, 1]
    target = qs[None, :] * total                                 # [F, Q]
    idx = np.argmax(cdf[:, None, :] >= target[:, :, None], axis=-1)  # [F, Q]
    below = np.where(idx > 0, np.take_along_axis(cdf, np.maximum(idx - 1, 0), 1), 0.0)
    in_bin = np.take_along_axis(hist, idx, axis=1)               # [F, Q]
    frac = np.clip((target - below) / np.maximum(in_bin, 1e-300), 0.0, 1.0)
    return lo[:, None] + (idx + frac) * width[:, None]
