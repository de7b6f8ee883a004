"""Per-block summaries, computed once at partition time.

In the style of partition-selection summary stats (Rong et al., 2020), every
RSP block carries a small sketch suite -- record count, per-feature moments
and extrema, a KLL quantile sketch, a KMV distinct-count sketch, and (for
labelled data) a label histogram -- written alongside the block at
partition/store time.  Downstream consumers then answer questions like
"estimate the corpus mean / median / cardinality from the sketches" or "how
far is block k's label distribution from the corpus" without touching block
data at all: every member sketch merges exactly or within its analytic
error bound (see :mod:`repro_torch.rsp.sketch`).

``summarize_block`` returns a :class:`repro_torch.rsp.sketch.SketchSuite`; the
frozen :class:`BlockSummary` dataclass remains as the v1 manifest container
(old stores deserialize through it) and is attribute-compatible with the
suite, so consumers are agnostic to which one they hold.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.estimators import MomentStats
from repro_torch.core.moments import chan_merge
from repro_torch.device import as_numpy
from repro_torch.rsp.sketch import (
    DEFAULT_KLL_K,
    DEFAULT_KMV_K,
    MomentsSketch,
    SketchSuite,
)


@dataclasses.dataclass(frozen=True)
class BlockSummary:
    """Legacy (schema v1) container: moments + extrema (+ label histogram).

    New code receives :class:`repro_torch.rsp.sketch.SketchSuite` from
    ``summarize_block``; this dataclass persists as the v1 wire format and
    the minimal duck-type the consumers rely on."""

    block_id: int
    count: int
    mean: np.ndarray                 # [F] per flattened feature
    m2: np.ndarray                   # [F] sum of squared deviations
    min: np.ndarray                  # [F]
    max: np.ndarray                  # [F]
    label_hist: np.ndarray | None = None   # [num_classes] counts, optional

    @property
    def variance(self) -> np.ndarray:
        return self.m2 / max(self.count - 1.0, 1.0)

    @property
    def std(self) -> np.ndarray:
        return np.sqrt(self.variance)

    @property
    def label_distribution(self) -> np.ndarray:
        if self.label_hist is None:
            raise ValueError(f"block {self.block_id} has no label histogram")
        return self.label_hist / max(self.label_hist.sum(), 1)

    def moments(self) -> MomentStats:
        return MomentStats(
            count=float(self.count),
            mean=self.mean.copy(),
            m2=self.m2.copy(),
            min=self.min.copy(),
            max=self.max.copy(),
        )

    # -- manifest (de)serialization ----------------------------------------
    def to_dict(self) -> dict:
        d = {
            "block_id": self.block_id,
            "count": self.count,
            "mean": self.mean.tolist(),
            "m2": self.m2.tolist(),
            "min": self.min.tolist(),
            "max": self.max.tolist(),
        }
        if self.label_hist is not None:
            d["label_hist"] = self.label_hist.tolist()
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "BlockSummary":
        hist = d.get("label_hist")
        return cls(
            block_id=int(d["block_id"]),
            count=int(d["count"]),
            mean=np.asarray(d["mean"], dtype=np.float64),
            m2=np.asarray(d["m2"], dtype=np.float64),
            min=np.asarray(d["min"], dtype=np.float64),
            max=np.asarray(d["max"], dtype=np.float64),
            label_hist=None if hist is None else np.asarray(hist, dtype=np.int64),
        )


def summarize_block(
    block,
    block_id: int,
    *,
    label_column: int | None = None,
    num_classes: int | None = None,
    kll_k: int = DEFAULT_KLL_K,
    kmv_k: int = DEFAULT_KMV_K,
    seed: int = 0,
    kinds: tuple[str, ...] | list[str] | None = None,
) -> SketchSuite:
    """Compute one block's sketch suite.  ``label_column`` (with
    ``num_classes``) additionally records the label histogram of that column.
    ``kinds`` restricts which sketches are folded (default: the full suite)
    -- e.g. ``("moments",)`` when only exact moments are needed and the
    KLL/KMV folding cost would be waste.

    Moments/extrema come from the fused one-pass block sketch
    (``repro_torch.kernels.block_sketch``) -- the same primitive the query layer
    folds at read time -- wrapped unmodified into the suite's ``moments``
    member; the richer members (KLL quantiles, KMV distinct counts) fold the
    same rows on the host.  A block on the card is copied to the host first:
    partition-time summaries are numpy f64 work, as in the reference."""
    from repro_torch.kernels.block_sketch.ref import block_sketch_ref

    x = as_numpy(block).astype(np.float64)
    x = x.reshape(x.shape[0], -1)
    sk = block_sketch_ref(x)
    suite = SketchSuite.create(
        block_id,
        label_column=label_column,
        num_classes=num_classes,
        kll_k=kll_k,
        kmv_k=kmv_k,
        seed=seed,
        kinds=kinds,
    )
    suite.sketches["moments"] = MomentsSketch.from_block_sketch(sk)
    for kind, member in suite.sketches.items():
        if kind != "moments":
            member.update(x)
    return suite


def summarize_blocks(
    blocks: Iterable,
    *,
    label_column: int | None = None,
    num_classes: int | None = None,
    **kwargs,
) -> list[SketchSuite]:
    return [
        summarize_block(
            b, k, label_column=label_column, num_classes=num_classes, **kwargs
        )
        for k, b in enumerate(blocks)
    ]


def combine_summaries(
    summaries: Sequence,
    *,
    weights: Sequence[float] | np.ndarray | None = None,
    total_count: int | None = None,
) -> MomentStats:
    """Corpus-level moments from block sketches alone (no data reads).

    Accepts any mix of :class:`BlockSummary` and
    :class:`~repro_torch.rsp.sketch.SketchSuite` (they share the moment surface).
    Without ``weights`` this is the exact Chan-style parallel combine over
    the given sketches.  With ``weights`` (one per sketch, e.g. from
    ``SamplingPolicy.weights``) it is the Horvitz-Thompson estimate for a
    non-uniform block-level sample: block totals are expanded by their weight
    (``sum_k w_k * t_k`` estimates the corpus total), which undoes the
    selection bias of weighted/stratified policies.  Pass ``total_count``
    (the corpus record count ``N``, known from ``RSPSpec``) to normalize the
    mean by the true ``N`` -- the estimator is then exactly unbiased;
    otherwise the HT-estimated count is used (self-normalized / Hajek form).
    ``min``/``max`` are taken over the sampled sketches only.
    """
    if not summaries:
        raise ValueError("need at least one block summary")
    if weights is None:
        acc = summaries[0].moments()
        for s in summaries[1:]:
            m = s.moments()
            acc.count, acc.mean, acc.m2 = chan_merge(
                acc.count, acc.mean, acc.m2, m.count, m.mean, m.m2
            )
            acc.min = np.minimum(acc.min, m.min)
            acc.max = np.maximum(acc.max, m.max)
        return acc
    w = np.asarray(weights, dtype=np.float64)
    if w.shape != (len(summaries),) or np.any(w < 0):
        raise ValueError("weights must be non-negative, one per summary")
    counts = np.array([s.count for s in summaries], dtype=np.float64)
    means = np.stack([s.mean for s in summaries])
    m2s = np.stack([s.m2 for s in summaries])
    count_hat = float((w * counts).sum())
    n = float(total_count) if total_count is not None else count_hat
    if n <= 0:
        raise ValueError("estimated/total count must be positive")
    sum_hat = (w[:, None] * counts[:, None] * means).sum(axis=0)
    # HT estimate of the corpus sum of squares: per block, sum x^2 = m2 + c*mean^2
    sumsq_hat = (w[:, None] * (m2s + counts[:, None] * means**2)).sum(axis=0)
    mean = sum_hat / n
    m2 = np.maximum(sumsq_hat - n * mean**2, 0.0)
    return MomentStats(
        count=n,
        mean=mean,
        m2=m2,
        min=np.min([s.min for s in summaries], axis=0),
        max=np.max([s.max for s in summaries], axis=0),
    )


def max_divergence_from_summaries(summaries: Sequence) -> float:
    """Worst L-inf distance between any block's label distribution and the
    corpus label distribution, computed purely from the sketches (Fig. 2a)."""
    hists = [s.label_hist for s in summaries]
    if any(h is None for h in hists):
        raise ValueError("all blocks need label histograms")
    total = np.sum(hists, axis=0)
    corpus = total / max(total.sum(), 1)
    return float(
        max(np.max(np.abs(s.label_distribution - corpus)) for s in summaries)
    )
