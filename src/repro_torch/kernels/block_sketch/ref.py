"""Oracle: the fused per-block sketch as plain numpy.

One conceptual pass over a block ``[n, ...]`` produces everything the query
layer needs from it: record count, per-feature mean / M2 / extrema
(Chan-combinable moments) and a per-feature fixed-grid histogram.  Mass
outside ``[lo, hi]`` is *clipped into the edge bins* -- the histogram always
sums to ``n`` per feature, so merged histograms stay consistent with the
merged counts (the silent-mass-drop bias the old ``block_histogram`` had).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class BlockSketch:
    """Combinable one-pass sketch of a single RSP block.

    ``hist`` is ``None`` when the sketch was computed with ``bins=0``
    (moments-only fast path).  ``lo`` / ``hi`` record the per-feature grid the
    histogram was computed on; sketches combine only on identical grids.
    """

    count: float
    mean: np.ndarray                  # [F]
    m2: np.ndarray                    # [F] sum of squared deviations
    min: np.ndarray                   # [F]
    max: np.ndarray                   # [F]
    hist: np.ndarray | None = None    # [F, bins] counts
    lo: np.ndarray | None = None      # [F] grid lower edges
    hi: np.ndarray | None = None      # [F] grid upper edges

    @property
    def variance(self) -> np.ndarray:
        return self.m2 / max(self.count - 1.0, 1.0)

    @property
    def sum(self) -> np.ndarray:
        return self.count * self.mean

    def to_dict(self) -> dict:
        """JSON-safe encoding, exact to the bit: Python's shortest-repr float
        serialization round-trips every finite float64, and the per-array
        dtype is carried so decoding restores identical arrays."""
        def arr(a):
            if a is None:
                return None
            a = np.asarray(a)
            return {"dtype": str(a.dtype), "shape": list(a.shape),
                    "data": a.ravel().tolist()}

        return {
            "count": float(self.count),
            "mean": arr(self.mean), "m2": arr(self.m2),
            "min": arr(self.min), "max": arr(self.max),
            "hist": arr(self.hist), "lo": arr(self.lo), "hi": arr(self.hi),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "BlockSketch":
        def arr(e):
            if e is None:
                return None
            return np.asarray(e["data"], dtype=np.dtype(e["dtype"])).reshape(e["shape"])

        return cls(
            count=float(d["count"]),
            mean=arr(d["mean"]), m2=arr(d["m2"]),
            min=arr(d["min"]), max=arr(d["max"]),
            hist=arr(d.get("hist")), lo=arr(d.get("lo")), hi=arr(d.get("hi")),
        )


def merge_sketches(a: BlockSketch, b: BlockSketch) -> BlockSketch:
    """Chan-style parallel combine of two sketches (histograms add); the
    moment algebra is the shared :func:`repro_torch.core.moments.chan_merge`."""
    from repro_torch.core.moments import chan_merge

    if a.count + b.count <= 0:
        return a
    hist = None
    if a.hist is not None and b.hist is not None:
        hist = a.hist + b.hist
    n, mean, m2 = chan_merge(a.count, a.mean, a.m2, b.count, b.mean, b.m2)
    return BlockSketch(
        count=n,
        mean=mean,
        m2=m2,
        min=np.minimum(a.min, b.min),
        max=np.maximum(a.max, b.max),
        hist=hist,
        lo=a.lo,
        hi=a.hi,
    )


def _grid(lo, hi, num_features: int) -> tuple[np.ndarray, np.ndarray]:
    lo = np.broadcast_to(np.asarray(lo, dtype=np.float64), (num_features,)).copy()
    hi = np.broadcast_to(np.asarray(hi, dtype=np.float64), (num_features,)).copy()
    return lo, hi


def grid_histogram(
    x: np.ndarray, lo: np.ndarray, hi: np.ndarray, bins: int
) -> np.ndarray:
    """Vectorized per-feature fixed-grid histogram of ``x`` [n, F] with
    out-of-range mass clipped into the edge bins."""
    n, f = x.shape
    width = (hi - lo) / bins
    safe = np.where(width > 0, width, 1.0)
    idx = np.clip(np.floor((x - lo) / safe).astype(np.int64), 0, bins - 1)
    flat = idx + np.arange(f, dtype=np.int64) * bins
    return np.bincount(flat.ravel(), minlength=f * bins).reshape(f, bins)


def block_sketch_ref(
    block: np.ndarray,
    *,
    bins: int = 0,
    lo=0.0,
    hi=1.0,
    dtype=np.float64,
) -> BlockSketch:
    """Reference fused sketch: moments + extrema (+ fixed-grid histogram when
    ``bins > 0``) of one block, flattened to ``[n, F]``."""
    x = np.asarray(block, dtype=dtype).reshape(np.shape(block)[0], -1)
    mean = x.mean(axis=0)
    m2 = ((x - mean) ** 2).sum(axis=0)
    sketch = BlockSketch(
        count=float(x.shape[0]),
        mean=mean,
        m2=m2,
        min=x.min(axis=0),
        max=x.max(axis=0),
    )
    if bins > 0:
        sketch.lo, sketch.hi = _grid(lo, hi, x.shape[1])
        sketch.hist = grid_histogram(x, sketch.lo, sketch.hi, bins)
    return sketch
