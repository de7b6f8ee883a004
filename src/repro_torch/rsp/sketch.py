"""Unified mergeable-sketch subsystem for RSP blocks.

The per-block sketch is the load-bearing data structure of the whole stack:
a few RSP blocks stand in for the corpus, and everything the query / sampling
layers know about unread blocks comes from their sketches.  This module is
the single home for those sketches:

* a :class:`Sketch` protocol -- ``update(rows)``, ``merge(other)``, versioned
  ``to_dict`` / ``from_dict`` -- with a registry of implementations,
* :class:`MomentsSketch` (count / mean / M2 / extrema; wraps the same Chan
  fold the ``block_sketch`` and ``plan`` kernels produce),
* :class:`HistogramSketch` (mergeable fixed-grid histograms),
* :class:`KLLSketch` (mergeable quantile sketch, Karnin-Lang-Liberty style),
* :class:`DistinctSketch` (KMV / k-minimum-values distinct counting),
* :class:`LabelsSketch` (label histograms for labelled corpora),
* :class:`SketchSuite`, the per-block composition that partition backends
  write, manifests persist (``sketch_schema`` v2; v1 manifests upgrade
  lazily on read), and query / sampler layers consume.

``SketchSuite`` is attribute-compatible with the legacy ``BlockSummary``
(``count`` / ``mean`` / ``m2`` / ``min`` / ``max`` / ``std`` / ``variance`` /
``label_hist`` / ``label_distribution`` / ``moments()``) so every existing
consumer -- ``combine_summaries``, the sampling policies, the query engine --
reads suites without change.
"""

from __future__ import annotations

import math
from typing import Iterable, Sequence

import numpy as np

from repro_torch.core.estimators import MomentStats
from repro_torch.core.moments import chan_merge

#: Manifest schema version written by :meth:`SketchSuite.to_dict`.  v1 is the
#: flat pre-suite ``BlockSummary`` dict (no ``"sketches"`` key); v1 payloads
#: still load through :meth:`SketchSuite.from_dict` as a lazy in-memory
#: upgrade to a moments(+labels)-only suite.
SKETCH_SCHEMA_VERSION = 2

DEFAULT_KLL_K = 160
DEFAULT_KMV_K = 256

# ---------------------------------------------------------------------------
# Protocol + registry
# ---------------------------------------------------------------------------

SKETCH_KINDS: dict[str, type] = {}


def register_sketch(cls: type) -> type:
    """Class decorator: register a :class:`Sketch` implementation under its
    ``kind`` so :func:`sketch_from_dict` can revive it from a manifest."""
    if not getattr(cls, "kind", None):
        raise ValueError(f"{cls.__name__} needs a non-empty `kind`")
    SKETCH_KINDS[cls.kind] = cls
    return cls


def sketch_from_dict(d: dict) -> "Sketch":
    """Revive any registered sketch from its ``to_dict`` payload."""
    kind = d.get("kind")
    if kind not in SKETCH_KINDS:
        raise ValueError(
            f"unknown sketch kind {kind!r} (registered: {sorted(SKETCH_KINDS)})"
        )
    return SKETCH_KINDS[kind].from_dict(d)


class Sketch:
    """One mergeable per-block statistic.

    ``update(rows)`` folds a chunk of rows (``[n, F]`` float array) into the
    sketch; ``merge(other)`` folds another sketch of the same kind/params in
    place and returns ``self``; ``to_dict`` / ``from_dict`` round-trip the
    state losslessly through JSON (manifests).  All implementations are
    deterministic: any randomness (KLL compaction) is seeded from the
    sketch's own state, never from global RNG.
    """

    kind = ""

    def update(self, rows: np.ndarray) -> "Sketch":
        raise NotImplementedError

    def merge(self, other: "Sketch") -> "Sketch":
        raise NotImplementedError

    def to_dict(self) -> dict:
        raise NotImplementedError

    @classmethod
    def from_dict(cls, d: dict) -> "Sketch":
        raise NotImplementedError

    def _check_mergeable(self, other: "Sketch") -> None:
        if self.kind != getattr(other, "kind", None):
            raise ValueError(f"cannot merge {self.kind!r} with {getattr(other, 'kind', other)!r}")


def _as_rows(rows) -> np.ndarray:
    x = np.asarray(rows, dtype=np.float64)
    return x.reshape(x.shape[0], -1)


# ---------------------------------------------------------------------------
# Moments + extrema (the Chan fold the kernels produce)
# ---------------------------------------------------------------------------

@register_sketch
class MomentsSketch(Sketch):
    """Count / per-feature mean / M2 / extrema.  The merge is the shared
    :func:`repro_torch.core.moments.chan_merge` -- the same fold the
    ``block_sketch`` / ``plan`` kernels run on device, so kernel outputs
    wrap into this sketch without recomputation
    (:meth:`from_block_sketch`)."""

    kind = "moments"

    def __init__(self, count: float = 0.0, mean=None, m2=None, min=None, max=None):
        self.count = float(count)
        self.mean = None if mean is None else np.asarray(mean, dtype=np.float64)
        self.m2 = None if m2 is None else np.asarray(m2, dtype=np.float64)
        self.min = None if min is None else np.asarray(min, dtype=np.float64)
        self.max = None if max is None else np.asarray(max, dtype=np.float64)

    @classmethod
    def from_block_sketch(cls, sk) -> "MomentsSketch":
        """Wrap a kernel-produced ``BlockSketch`` (no recompute)."""
        return cls(count=float(sk.count), mean=sk.mean, m2=sk.m2, min=sk.min, max=sk.max)

    def update(self, rows) -> "MomentsSketch":
        x = _as_rows(rows)
        if x.shape[0] == 0:
            return self
        mean = x.mean(axis=0)
        m2 = ((x - mean) ** 2).sum(axis=0)
        return self.merge(
            MomentsSketch(float(x.shape[0]), mean, m2, x.min(axis=0), x.max(axis=0))
        )

    def merge(self, other: "MomentsSketch") -> "MomentsSketch":
        self._check_mergeable(other)
        if other.count <= 0:
            return self
        if self.count <= 0:
            self.count = other.count
            self.mean, self.m2 = other.mean.copy(), other.m2.copy()
            self.min, self.max = other.min.copy(), other.max.copy()
            return self
        self.count, self.mean, self.m2 = chan_merge(
            self.count, self.mean, self.m2, other.count, other.mean, other.m2
        )
        self.min = np.minimum(self.min, other.min)
        self.max = np.maximum(self.max, other.max)
        return self

    @property
    def variance(self) -> np.ndarray:
        return self.m2 / max(self.count - 1.0, 1.0)

    @property
    def std(self) -> np.ndarray:
        return np.sqrt(self.variance)

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "count": self.count,
            "mean": [] if self.mean is None else self.mean.tolist(),
            "m2": [] if self.m2 is None else self.m2.tolist(),
            "min": [] if self.min is None else self.min.tolist(),
            "max": [] if self.max is None else self.max.tolist(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "MomentsSketch":
        if d["count"] <= 0:
            return cls()
        return cls(d["count"], d["mean"], d["m2"], d["min"], d["max"])


# ---------------------------------------------------------------------------
# Fixed-grid histograms
# ---------------------------------------------------------------------------

@register_sketch
class HistogramSketch(Sketch):
    """Per-feature fixed-grid histogram ``[F, bins]``; merges by addition on
    *identical* grids only.  Out-of-range mass clips into the edge bins so
    every histogram sums to the row count."""

    kind = "histogram"

    def __init__(self, bins: int, lo, hi, hist=None):
        from repro_torch.kernels.block_sketch.ref import _grid

        if bins <= 0:
            raise ValueError("histogram sketch needs bins > 0")
        self.bins = int(bins)
        lo = np.atleast_1d(np.asarray(lo, dtype=np.float64))
        hi = np.atleast_1d(np.asarray(hi, dtype=np.float64))
        f = max(lo.shape[0], hi.shape[0])
        self.lo, self.hi = _grid(lo, hi, f)
        self.hist = (
            np.zeros((f, bins), dtype=np.int64)
            if hist is None
            else np.asarray(hist, dtype=np.int64)
        )
        if self.hist.shape != (f, bins):
            raise ValueError("hist shape must be [F, bins]")

    def update(self, rows) -> "HistogramSketch":
        from repro_torch.kernels.block_sketch.ref import grid_histogram

        x = _as_rows(rows)
        if x.shape[0]:
            self.hist = self.hist + grid_histogram(x, self.lo, self.hi, self.bins)
        return self

    def merge(self, other: "HistogramSketch") -> "HistogramSketch":
        self._check_mergeable(other)
        if (
            other.bins != self.bins
            or not np.array_equal(other.lo, self.lo)
            or not np.array_equal(other.hi, self.hi)
        ):
            raise ValueError("histogram sketches merge only on identical grids")
        self.hist = self.hist + other.hist
        return self

    def quantile(self, qs: Sequence[float]) -> np.ndarray:
        from repro_torch.core.estimators import quantile_from_histogram

        return quantile_from_histogram(self.hist, qs, lo=self.lo, hi=self.hi)

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "bins": self.bins,
            "lo": self.lo.tolist(),
            "hi": self.hi.tolist(),
            "hist": self.hist.tolist(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "HistogramSketch":
        return cls(d["bins"], d["lo"], d["hi"], hist=d["hist"])


# ---------------------------------------------------------------------------
# KLL quantile sketch
# ---------------------------------------------------------------------------

class _KLLColumn:
    """One column's KLL compactor stack.  ``levels[h]`` holds items of weight
    ``2**h``; level capacities shrink geometrically (ratio 2/3) below the top
    so total space is ``O(k)``.  Compaction keeps every other item of a
    sorted over-full level (random even/odd offset, seeded from the sketch's
    own compaction counter -- fully deterministic given fold order)."""

    __slots__ = ("k", "levels", "n", "seed", "compactions")

    _EMPTY = np.empty(0, dtype=np.float64)

    def __init__(self, k: int, seed: int):
        self.k = int(k)
        # numpy (not Python-list) levels: a list of floats costs ~4x the
        # bytes, which matters when thousands of columns accumulate during
        # a memory-capped ingest
        self.levels: list[np.ndarray] = [self._EMPTY]
        self.n = 0
        self.seed = int(seed)
        self.compactions = 0

    def _capacity(self, h: int) -> int:
        depth = len(self.levels) - 1 - h
        return max(int(math.ceil(self.k * (2.0 / 3.0) ** depth)), 2)

    def _size(self) -> int:
        return sum(lv.size for lv in self.levels)

    def _cap_total(self) -> int:
        return sum(self._capacity(h) for h in range(len(self.levels)))

    def update(self, values: np.ndarray) -> None:
        values = np.asarray(values, dtype=np.float64).ravel()
        if values.size == 0:
            return
        self.levels[0] = np.concatenate([self.levels[0], values])
        self.n += int(values.size)
        self._compress()

    def merge(self, other: "_KLLColumn") -> None:
        while len(self.levels) < len(other.levels):
            self.levels.append(self._EMPTY)
        for h, lv in enumerate(other.levels):
            if lv.size:
                self.levels[h] = np.concatenate([self.levels[h], lv])
        self.n += other.n
        self._compress()

    def _compress(self) -> None:
        while self._size() > self._cap_total():
            for h in range(len(self.levels)):
                if self.levels[h].size >= self._capacity(h) and self.levels[h].size >= 2:
                    self._compact(h)
                    break
            else:
                break

    def _compact(self, h: int) -> None:
        if h == len(self.levels) - 1:
            self.levels.append(self._EMPTY)
        buf = np.sort(self.levels[h])
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed & 0xFFFFFFFF, 0x6B11, self.compactions])
        )
        self.compactions += 1
        keep = self._EMPTY
        if buf.size % 2 == 1:           # odd leftover stays at this level
            keep = buf[-1:]
            buf = buf[:-1]
        offset = int(rng.integers(0, 2))
        self.levels[h + 1] = np.concatenate([self.levels[h + 1], buf[offset::2]])
        self.levels[h] = keep

    def _sorted_weighted(self) -> tuple[np.ndarray, np.ndarray]:
        if self._size() == 0:
            return np.empty(0), np.empty(0)
        v = np.concatenate(self.levels)
        w = np.concatenate(
            [np.full(lv.size, float(1 << h)) for h, lv in enumerate(self.levels)]
        )
        order = np.argsort(v, kind="stable")
        return v[order], w[order]

    def quantile(self, qs: np.ndarray) -> np.ndarray:
        v, w = self._sorted_weighted()
        if v.size == 0:
            return np.full(len(qs), np.nan)
        cum = np.cumsum(w)
        target = np.clip(np.asarray(qs, dtype=np.float64), 0.0, 1.0) * cum[-1]
        idx = np.minimum(np.searchsorted(cum, target, side="left"), v.size - 1)
        return v[idx]

    def rank(self, x: float) -> float:
        """Estimated fraction of items ``<= x``."""
        v, w = self._sorted_weighted()
        if v.size == 0:
            return 0.0
        i = int(np.searchsorted(v, x, side="right"))
        if i == 0:
            return 0.0
        return float(np.cumsum(w)[i - 1] / w.sum())

    def to_dict(self) -> dict:
        return {
            "n": self.n,
            "compactions": self.compactions,
            "levels": [lv.tolist() for lv in self.levels],
        }

    @classmethod
    def from_dict(cls, d: dict, *, k: int, seed: int) -> "_KLLColumn":
        col = cls(k, seed)
        col.n = int(d["n"])
        col.compactions = int(d["compactions"])
        col.levels = [np.asarray(lv, dtype=np.float64) for lv in d["levels"]]
        return col


def kll_rank_error_bound(k: int) -> float:
    """Analytic additive rank-error bound for a KLL sketch with parameter
    ``k`` at ~99% confidence: ``eps = 2.296 / k**0.9`` (the constant the
    Apache DataSketches implementation uses)."""
    return 2.296 / float(k) ** 0.9


@register_sketch
class KLLSketch(Sketch):
    """Mergeable per-column quantile sketch (Karnin-Lang-Liberty).

    Answers any quantile of any column to additive rank error
    :func:`kll_rank_error_bound` ``(k)`` from ``O(k)`` space per column, and
    merges without error growth -- so corpus quantiles come from the
    partition-time sketches with **zero** block reads."""

    kind = "kll"

    def __init__(self, k: int = DEFAULT_KLL_K, *, seed: int = 0, columns=None):
        if k < 8:
            raise ValueError("kll k must be >= 8")
        self.k = int(k)
        self.seed = int(seed)
        self._columns: list[_KLLColumn] | None = columns

    @property
    def num_features(self) -> int | None:
        return None if self._columns is None else len(self._columns)

    @property
    def n(self) -> int:
        return 0 if not self._columns else self._columns[0].n

    def _ensure_columns(self, f: int) -> list[_KLLColumn]:
        if self._columns is None:
            self._columns = [
                _KLLColumn(self.k, (self.seed << 8) + j) for j in range(f)
            ]
        if len(self._columns) != f:
            raise ValueError(
                f"kll sketch has {len(self._columns)} columns, rows have {f}"
            )
        return self._columns

    def update(self, rows) -> "KLLSketch":
        x = _as_rows(rows)
        if x.shape[0] == 0:
            return self
        for j, col in enumerate(self._ensure_columns(x.shape[1])):
            col.update(x[:, j])
        return self

    def merge(self, other: "KLLSketch") -> "KLLSketch":
        self._check_mergeable(other)
        if other.k != self.k:
            raise ValueError("kll sketches merge only with equal k")
        if other._columns is None:
            return self
        if self._columns is None:
            # adopt a deep copy so later folds never mutate `other`
            self._columns = [
                _KLLColumn.from_dict(c.to_dict(), k=self.k, seed=c.seed)
                for c in other._columns
            ]
            return self
        if len(self._columns) != len(other._columns):
            raise ValueError("kll sketches merge only with equal column counts")
        for mine, theirs in zip(self._columns, other._columns):
            mine.merge(theirs)
        return self

    def quantile(self, qs: Sequence[float]) -> np.ndarray:
        """Per-feature quantile estimates ``[F, Q]``."""
        if self._columns is None:
            raise ValueError("empty kll sketch")
        qs = np.atleast_1d(np.asarray(qs, dtype=np.float64))
        return np.stack([c.quantile(qs) for c in self._columns])

    def cdf(self, column: int, value: float) -> float:
        """Estimated fraction of column's values ``<= value``."""
        if self._columns is None:
            raise ValueError("empty kll sketch")
        return self._columns[int(column)].rank(float(value))

    def rank_error_bound(self) -> float:
        return kll_rank_error_bound(self.k)

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "k": self.k,
            "seed": self.seed,
            "columns": None
            if self._columns is None
            else [c.to_dict() for c in self._columns],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "KLLSketch":
        sk = cls(d["k"], seed=d.get("seed", 0))
        if d.get("columns") is not None:
            sk._columns = [
                _KLLColumn.from_dict(c, k=sk.k, seed=(sk.seed << 8) + j)
                for j, c in enumerate(d["columns"])
            ]
        return sk


# ---------------------------------------------------------------------------
# KMV distinct counting
# ---------------------------------------------------------------------------

_U64 = np.uint64
_HASH_SPACE = float(2**64)


def _splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over uint64 (wraps mod 2^64)."""
    z = x + _U64(0x9E3779B97F4A7C15)
    z = (z ^ (z >> _U64(30))) * _U64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> _U64(27))) * _U64(0x94D049BB133111EB)
    return z ^ (z >> _U64(31))


def _hash_values(values: np.ndarray) -> np.ndarray:
    """Hash float64 values by bit pattern (with ``-0.0`` canonicalized to
    ``+0.0`` so equal values always collide)."""
    v = np.asarray(values, dtype=np.float64).copy()
    v[v == 0.0] = 0.0
    return _splitmix64(v.view(np.uint64))


def _union_smallest(a: np.ndarray, b: np.ndarray, k: int) -> np.ndarray:
    """``np.union1d(a, b)[:k]``: the ``k`` smallest distinct values of both,
    sorted.  Computed by sort-and-mask, which is what ``np.unique`` did
    before numpy 2.3; its hash-table path since then was measured some 25x
    slower on the 110,000 distinct hashes of a HIGGS-sized block column."""
    h = np.concatenate((a, b))
    h.sort()
    if h.size > 1:
        keep = np.empty(h.size, dtype=bool)
        keep[0] = True
        np.not_equal(h[1:], h[:-1], out=keep[1:])
        h = h[keep]
    return h[:k]


@register_sketch
class DistinctSketch(Sketch):
    """KMV (k-minimum-values) distinct-count sketch per column.

    Keeps the ``k`` smallest 64-bit hashes of each column's values.  Below
    ``k`` observed hashes the count is exact; past it the estimate is
    ``(k - 1) / r_k`` with ``r_k`` the k-th smallest normalized hash
    (relative SE ~ ``1/sqrt(k - 2)``).  Merges by hash-set union + truncate,
    so the merged sketch equals the sketch of the concatenated data."""

    kind = "distinct"

    def __init__(self, k: int = DEFAULT_KMV_K, *, columns=None):
        if k < 8:
            raise ValueError("kmv k must be >= 8")
        self.k = int(k)
        self._columns: list[np.ndarray] | None = columns  # sorted uint64 [<=k]

    @property
    def num_features(self) -> int | None:
        return None if self._columns is None else len(self._columns)

    def _ensure_columns(self, f: int) -> list[np.ndarray]:
        if self._columns is None:
            self._columns = [np.empty(0, dtype=np.uint64) for _ in range(f)]
        if len(self._columns) != f:
            raise ValueError(
                f"distinct sketch has {len(self._columns)} columns, rows have {f}"
            )
        return self._columns

    def update(self, rows) -> "DistinctSketch":
        x = _as_rows(rows)
        if x.shape[0] == 0:
            return self
        cols = self._ensure_columns(x.shape[1])
        for j in range(x.shape[1]):
            cols[j] = _union_smallest(cols[j], _hash_values(x[:, j]), self.k)
        return self

    def merge(self, other: "DistinctSketch") -> "DistinctSketch":
        self._check_mergeable(other)
        if other.k != self.k:
            raise ValueError("distinct sketches merge only with equal k")
        if other._columns is None:
            return self
        if self._columns is None:
            self._columns = [c.copy() for c in other._columns]
            return self
        if len(self._columns) != len(other._columns):
            raise ValueError("distinct sketches merge only with equal column counts")
        for j in range(len(self._columns)):
            self._columns[j] = _union_smallest(self._columns[j], other._columns[j], self.k)
        return self

    def estimate(self) -> np.ndarray:
        """Per-feature distinct-count estimates ``[F]``."""
        if self._columns is None:
            raise ValueError("empty distinct sketch")
        out = np.empty(len(self._columns), dtype=np.float64)
        for j, h in enumerate(self._columns):
            if h.size < self.k:
                out[j] = float(h.size)
            else:
                r_k = (float(h[self.k - 1]) + 1.0) / _HASH_SPACE
                out[j] = (self.k - 1) / r_k
        return out

    def relative_error_bound(self) -> float:
        """~1-sigma relative standard error of the KMV estimator."""
        return 1.0 / math.sqrt(max(self.k - 2, 1))

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "k": self.k,
            "columns": None
            if self._columns is None
            else [[int(v) for v in c] for c in self._columns],
        }

    @classmethod
    def from_dict(cls, d: dict) -> "DistinctSketch":
        sk = cls(d["k"])
        if d.get("columns") is not None:
            sk._columns = [np.asarray(c, dtype=np.uint64) for c in d["columns"]]
        return sk


# ---------------------------------------------------------------------------
# Label histograms
# ---------------------------------------------------------------------------

@register_sketch
class LabelsSketch(Sketch):
    """Label histogram of one (integer-valued) column.  ``label_column`` may
    be ``None`` for suites upgraded from v1 manifests (histogram known,
    provenance lost) -- such sketches merge but cannot ``update``."""

    kind = "labels"

    def __init__(self, num_classes: int, label_column: int | None = None, hist=None):
        if num_classes <= 0:
            raise ValueError("labels sketch needs num_classes > 0")
        self.num_classes = int(num_classes)
        self.label_column = None if label_column is None else int(label_column)
        self.hist = (
            np.zeros(num_classes, dtype=np.int64)
            if hist is None
            else np.asarray(hist, dtype=np.int64)
        )
        if self.hist.shape != (self.num_classes,):
            raise ValueError("label hist shape must be [num_classes]")

    def update(self, rows) -> "LabelsSketch":
        if self.label_column is None:
            raise ValueError("labels sketch upgraded from v1 has no label column")
        x = _as_rows(rows)
        if x.shape[0] == 0:
            return self
        labels = x[:, self.label_column]
        ilabels = labels.astype(np.int64)
        if (
            np.any(ilabels != labels)
            or ilabels.min(initial=0) < 0
            or ilabels.max(initial=0) >= self.num_classes
        ):
            raise ValueError(
                f"label column {self.label_column} has values outside"
                f" 0..{self.num_classes - 1} (wrong label_column or num_classes?)"
            )
        self.hist = self.hist + np.bincount(ilabels, minlength=self.num_classes)
        return self

    def merge(self, other: "LabelsSketch") -> "LabelsSketch":
        self._check_mergeable(other)
        if other.num_classes != self.num_classes:
            raise ValueError("labels sketches merge only with equal num_classes")
        self.hist = self.hist + other.hist
        return self

    @property
    def distribution(self) -> np.ndarray:
        return self.hist / max(self.hist.sum(), 1)

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "num_classes": self.num_classes,
            "label_column": self.label_column,
            "hist": self.hist.tolist(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LabelsSketch":
        return cls(d["num_classes"], d.get("label_column"), hist=d["hist"])


# ---------------------------------------------------------------------------
# The per-block suite
# ---------------------------------------------------------------------------

class SketchSuite:
    """The composition of sketches one RSP block carries.

    Attribute-compatible with the legacy ``BlockSummary`` so the sampling
    policies, ``combine_summaries`` and the query layer consume suites
    unchanged; richer members (``kll`` / ``distinct``) unlock sketch-only
    quantile / distinct-count answers and query-aware block scoring."""

    def __init__(self, block_id: int, sketches: dict[str, Sketch]):
        if "moments" not in sketches:
            raise ValueError("every sketch suite needs a 'moments' member")
        self.block_id = int(block_id)
        self.sketches = dict(sketches)

    # -- construction ------------------------------------------------------
    @classmethod
    def create(
        cls,
        block_id: int,
        *,
        label_column: int | None = None,
        num_classes: int | None = None,
        kll_k: int = DEFAULT_KLL_K,
        kmv_k: int = DEFAULT_KMV_K,
        kinds: Sequence[str] | None = None,
        seed: int = 0,
    ) -> "SketchSuite":
        """An empty suite with the default members: moments + KLL + distinct
        (+ labels when ``label_column``/``num_classes`` are given).  Fixed-grid
        histograms are registered but not default -- their grid needs global
        extrema the writer does not have yet.  KLL compaction randomness is
        seeded per ``(seed, block_id)`` so partition writes are reproducible
        for any chunking of the stream."""
        default = ["moments", "kll", "distinct"]
        if label_column is not None and num_classes is not None:
            default.append("labels")
        sketches: dict[str, Sketch] = {}
        for kind in kinds if kinds is not None else default:
            if kind == "moments":
                sketches[kind] = MomentsSketch()
            elif kind == "kll":
                sketches[kind] = KLLSketch(kll_k, seed=(int(seed) << 20) ^ int(block_id))
            elif kind == "distinct":
                sketches[kind] = DistinctSketch(kmv_k)
            elif kind == "labels":
                if label_column is None or num_classes is None:
                    raise ValueError("labels sketch needs label_column and num_classes")
                sketches[kind] = LabelsSketch(num_classes, label_column)
            else:
                raise ValueError(f"no default constructor for sketch kind {kind!r}")
        return cls(block_id, sketches)

    # -- Sketch protocol, suite-wide --------------------------------------
    def update(self, rows) -> "SketchSuite":
        x = _as_rows(rows)
        for sk in self.sketches.values():
            sk.update(x)
        return self

    def merge(self, other: "SketchSuite") -> "SketchSuite":
        """Fold ``other`` in (shared kinds only -- a v1-upgraded suite merges
        into a v2 suite on the moments/labels they both carry)."""
        for kind in list(self.sketches):
            if kind in other.sketches:
                self.sketches[kind].merge(other.sketches[kind])
            else:
                del self.sketches[kind]
        return self

    def get(self, kind: str) -> Sketch | None:
        return self.sketches.get(kind)

    # -- BlockSummary-compatible surface -----------------------------------
    @property
    def _moments(self) -> MomentsSketch:
        return self.sketches["moments"]  # type: ignore[return-value]

    @property
    def count(self) -> int:
        return int(self._moments.count)

    @property
    def mean(self) -> np.ndarray:
        return self._moments.mean

    @property
    def m2(self) -> np.ndarray:
        return self._moments.m2

    @property
    def min(self) -> np.ndarray:
        return self._moments.min

    @property
    def max(self) -> np.ndarray:
        return self._moments.max

    @property
    def variance(self) -> np.ndarray:
        return self._moments.variance

    @property
    def std(self) -> np.ndarray:
        return self._moments.std

    @property
    def label_hist(self) -> np.ndarray | None:
        labels = self.sketches.get("labels")
        return None if labels is None else labels.hist

    @property
    def label_distribution(self) -> np.ndarray:
        labels = self.sketches.get("labels")
        if labels is None:
            raise ValueError(f"block {self.block_id} has no label histogram")
        return labels.distribution

    def moments(self) -> MomentStats:
        m = self._moments
        return MomentStats(
            count=float(m.count),
            mean=m.mean.copy(),
            m2=m.m2.copy(),
            min=m.min.copy(),
            max=m.max.copy(),
        )

    # -- query-aware helpers -----------------------------------------------
    def selectivity(self, predicates) -> float:
        """Estimated fraction of the block's rows passing the conjunctive
        ``predicates``.  Per-predicate marginals come from the block's KLL
        CDF when present, else from linear interpolation over the moment
        sketch's ``[min, max]`` span (v1 suites); conjunction assumes
        independence.  Always in ``[0, 1]``."""
        sel = 1.0
        kll = self.sketches.get("kll")
        for p in predicates:
            c, v = int(p.column), float(p.value)
            if kll is not None and kll.num_features is not None:
                frac_le = kll.cdf(c, v)
            else:
                lo, hi = float(self.min[c]), float(self.max[c])
                if hi <= lo:
                    frac_le = 1.0 if lo <= v else 0.0
                else:
                    frac_le = float(np.clip((v - lo) / (hi - lo), 0.0, 1.0))
            if p.op in ("lt", "le"):
                frac = frac_le
            elif p.op in ("gt", "ge"):
                frac = 1.0 - frac_le
            elif p.op == "eq":
                # point mass: visible to the sketch only through rank steps
                eps = 1e-9 * max(abs(v), 1.0)
                if kll is not None and kll.num_features is not None:
                    frac = max(frac_le - kll.cdf(c, v - eps), 0.0)
                else:
                    frac = 1.0 if float(self.min[c]) <= v <= float(self.max[c]) else 0.0
            else:  # ne
                frac = 1.0 - self.selectivity([type(p)(c, "eq", v)])
            sel *= float(np.clip(frac, 0.0, 1.0))
        return sel

    # -- versioned (de)serialization ---------------------------------------
    def to_dict(self) -> dict:
        return {
            "schema_version": SKETCH_SCHEMA_VERSION,
            "block_id": self.block_id,
            "count": self.count,
            "sketches": {kind: sk.to_dict() for kind, sk in self.sketches.items()},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "SketchSuite":
        """Revive a suite from a manifest entry.  v1 payloads (flat
        ``BlockSummary`` dicts, no ``"sketches"`` key) upgrade lazily to a
        moments(+labels)-only suite that answers every moment/label question
        identically to the original."""
        if "sketches" not in d:  # v1 lazy upgrade
            sketches: dict[str, Sketch] = {
                "moments": MomentsSketch(
                    float(d["count"]), d["mean"], d["m2"], d["min"], d["max"]
                )
            }
            hist = d.get("label_hist")
            if hist is not None:
                sketches["labels"] = LabelsSketch(len(hist), None, hist=hist)
            return cls(int(d["block_id"]), sketches)
        return cls(
            int(d["block_id"]),
            {kind: sketch_from_dict(sd) for kind, sd in d["sketches"].items()},
        )


def load_summaries(raw: Iterable[dict]) -> list[SketchSuite]:
    """Manifest ``summaries`` payload (any schema version) -> suites."""
    return [SketchSuite.from_dict(d) for d in raw]


def merge_suites(suites: Sequence[SketchSuite]) -> SketchSuite:
    """Corpus-level suite from per-block suites (shared kinds).  The result
    is a fresh object -- the inputs are never mutated."""
    if not suites:
        raise ValueError("need at least one suite")
    acc = SketchSuite.from_dict(suites[0].to_dict())
    for s in suites[1:]:
        acc.merge(s)
    acc.block_id = -1
    return acc


def sketch_schema_descriptor(suites: Sequence[SketchSuite]) -> dict:
    """The manifest's ``sketch_schema`` entry: version + the sketch kinds
    (and size parameters) every block of the store carries."""
    kinds: dict[str, dict] = {}
    if suites:
        for kind, sk in suites[0].sketches.items():
            params = {}
            if hasattr(sk, "k"):
                params["k"] = sk.k
            if hasattr(sk, "bins"):
                params["bins"] = sk.bins
            if hasattr(sk, "num_classes"):
                params["num_classes"] = sk.num_classes
            kinds[kind] = params
    return {"version": SKETCH_SCHEMA_VERSION, "kinds": kinds}
