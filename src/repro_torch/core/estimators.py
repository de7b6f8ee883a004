"""Block-level statistics estimation (paper Sec. 8, Figs. 3/4): the pieces
the sketch suite and the query layer need.

Per-block summaries combine with Chan-style parallel moments, so the
estimator is a streaming fold over block-level samples; fixed-grid
histograms combine by addition and invert to quantiles.  Host-side numpy,
copied from the reference package (the kernels that produce per-block
sketches live in ``repro_torch.kernels``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

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
