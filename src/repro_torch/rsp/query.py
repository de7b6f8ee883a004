"""``repro_torch.rsp.query`` -- progressive approximate queries over RSP blocks.

The paper's central claim is that analysis of a big data set becomes
analysis of a few RSP blocks.  This module makes that loop explicit: a
:class:`Query` *declares* what is wanted -- aggregates (``mean`` / ``var`` /
``sum`` / ``count`` / ``quantile`` / ``histogram`` / ``distinct``,
optionally grouped by
label) plus a stopping rule (``target_rel_err``, ``confidence``,
``max_blocks``) -- and :class:`QueryExecutor` decides how many blocks to
read:

* **Sketch fast path** -- a query that needs only moments or label counts is
  answered from the partition-time sketches alone: *zero* block reads, and
  the answer is the exact corpus statistic (the sketches combine exactly).
  When the manifest carries the v2 sketch suite, ungrouped unfiltered
  ``quantile`` and ``distinct`` aggregates also answer sketch-only: KLL
  sketches give any quantile within an additive rank-error bound, KMV
  sketches give distinct counts within a known relative error -- both with
  honest (non-zero) intervals derived from those bounds.
* **Progressive path** -- otherwise blocks stream one at a time through the
  dataset's prefetching :class:`~repro_torch.rsp.engine.BlockExecutor` under a
  :class:`~repro_torch.core.sampler.SamplingPolicy`.  Each block is folded through
  the fused one-pass sketch kernel (``repro_torch.kernels.block_sketch``; the
  CUDA kernel for blocks on the card) into
  combinable per-aggregate state -- Chan moments for ``mean``/``var``/
  ``sum``/``count``, mergeable fixed-grid histograms for ``quantile``/
  ``histogram`` -- and after every block an *anytime* :class:`QueryResult`
  is emitted with confidence intervals.  The stream stops early once every
  interval is relatively tighter than ``target_rel_err``.

Confidence intervals follow the consistency framework of block-level
estimates (Karmakar & Mukhopadhyay, 2018): each RSP block is a random sample
of the corpus, so per-block estimates are i.i.d. and a CLT *across blocks*
applies -- Student-t intervals over the ``b`` per-block estimates, with a
finite-population correction under uniform without-replacement sampling.
Quantile intervals bootstrap over the per-block histograms (resample blocks
with replacement, re-merge, re-invert the CDF).  Under the ``weighted`` PPS
policy the per-draw estimates are Hansen-Hurwitz expansions (``t_k / p_k``),
which are i.i.d. by construction; ``stratified`` single-block draws are
marginally uniform-with-replacement and are treated as such (approximate).

Entry points: ``RSPDataset.query(...)`` (final result) and
``RSPDataset.query_stream(...)`` (one :class:`QueryResult` per block read).
"""

from __future__ import annotations

import dataclasses
import math
import re
import time
from typing import Iterator, Sequence

import numpy as np

from repro_torch import obs
from repro_torch.core.estimators import quantile_from_histogram
from repro_torch.core.sampler import SamplingPolicy, UniformPolicy, WeightedPolicy
from repro_torch.device import as_numpy
from repro_torch.kernels.block_sketch import BlockSketch, block_sketch
from repro_torch.kernels.plan import Predicate, QueryPlan, as_predicates, plan_sketch
from repro_torch.obs.convergence import ConvergenceStep, ConvergenceTrace
from repro_torch.rsp.engine import CallerStats, ExecutorStats

KINDS = ("mean", "var", "sum", "count", "quantile", "histogram", "distinct")
_SKETCH_ONLY_KINDS = ("mean", "var", "sum", "count")
_EPS = 1e-12


def derive_seed(*components: int) -> int:
    """Collapse integer identifiers (e.g. ``(service seed, query id)``) into
    one seed whose RNG stream is independent of every other combination.

    Concurrent serving needs this: two queries sharing one literal seed would
    share bootstrap/selection streams, and deriving seeds from *submission
    order* would make results depend on scheduling.  Deriving from stable ids
    keeps every query reproducible regardless of interleaving.
    """
    return int(np.random.SeedSequence(list(components)).generate_state(1)[0])


# ---------------------------------------------------------------------------
# Normal / Student-t quantiles (no scipy dependency)
# ---------------------------------------------------------------------------

def norm_ppf(p: float) -> float:
    """Inverse standard-normal CDF (Acklam's rational approximation,
    |err| < 1.2e-8 over (0, 1))."""
    if not 0.0 < p < 1.0:
        raise ValueError(f"p must be in (0, 1), got {p}")
    a = (-3.969683028665376e+01, 2.209460984245205e+02, -2.759285104469687e+02,
         1.383577518672690e+02, -3.066479806614716e+01, 2.506628277459239e+00)
    b = (-5.447609879822406e+01, 1.615858368580409e+02, -1.556989798598866e+02,
         6.680131188771972e+01, -1.328068155288572e+01)
    c = (-7.784894002430293e-03, -3.223964580411365e-01, -2.400758277161838e+00,
         -2.549732539343734e+00, 4.374664141464968e+00, 2.938163982698783e+00)
    d = (7.784695709041462e-03, 3.224671290700398e-01, 2.445134137142996e+00,
         3.754408661907416e+00)
    plow, phigh = 0.02425, 1 - 0.02425
    if p < plow:
        q = math.sqrt(-2 * math.log(p))
        num = ((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]
        return num / ((((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1)
    if p > phigh:
        return -norm_ppf(1 - p)
    q = p - 0.5
    r = q * q
    num = (((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]) * q
    return num / (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)


def t_ppf(p: float, df: int) -> float:
    """Inverse Student-t CDF: exact for df 1-2, Cornish-Fisher expansion in
    1/df above (plenty for CI construction; ~1% off at df=3, <0.1% by df=8)."""
    if df <= 0:
        raise ValueError("df must be positive")
    if df == 1:
        return math.tan(math.pi * (p - 0.5))
    if df == 2:
        u = 2 * p - 1
        return u * math.sqrt(2.0 / max(1 - u * u, _EPS))
    z = norm_ppf(p)
    v = float(df)
    return (
        z
        + (z**3 + z) / (4 * v)
        + (5 * z**5 + 16 * z**3 + 3 * z) / (96 * v**2)
        + (3 * z**7 + 19 * z**5 + 17 * z**3 - 15 * z) / (384 * v**3)
    )


# ---------------------------------------------------------------------------
# Query declaration
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Aggregate:
    """One requested aggregate.

    ``feature=None`` returns all (flattened) features; an int selects one
    column.  ``by_label=True`` computes the aggregate per class (needs
    ``num_classes`` on the dataset); the result gains a leading class axis.
    ``quantile`` needs ``q`` in (0, 1).
    """

    kind: str
    q: float | None = None
    feature: int | None = None
    by_label: bool = False
    name: str | None = None

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown aggregate kind {self.kind!r} (one of {KINDS})")
        if self.kind == "quantile":
            if self.q is None or not 0.0 < self.q < 1.0:
                raise ValueError("quantile aggregates need q in (0, 1)")
        elif self.q is not None:
            raise ValueError(f"q= only applies to quantile aggregates, not {self.kind!r}")
        if self.kind == "distinct" and self.by_label:
            raise ValueError("distinct aggregates do not support by_label")

    @property
    def label(self) -> str:
        if self.name:
            return self.name
        s = self.kind if self.q is None else f"p{self.q * 100:g}"
        if self.feature is not None:
            s += f"[{self.feature}]"
        if self.by_label:
            s += "/label"
        return s


_PCT = re.compile(r"^p(\d{1,2}(?:\.\d+)?)$")


def parse_aggregate(spec) -> Aggregate:
    """``"mean" | "var" | "sum" | "count" | "histogram" | "distinct" |
    "median" | "p95" | "p99.9"`` -> :class:`Aggregate` (instances pass
    through)."""
    if isinstance(spec, Aggregate):
        return spec
    if not isinstance(spec, str):
        raise TypeError(f"cannot parse aggregate from {type(spec).__name__}")
    s = spec.strip().lower()
    if s in KINDS and s != "quantile":
        return Aggregate(s)
    if s == "median":
        return Aggregate("quantile", q=0.5)
    m = _PCT.match(s)
    if m:
        return Aggregate("quantile", q=float(m.group(1)) / 100.0)
    raise ValueError(
        f"cannot parse aggregate {spec!r} (mean | var | sum | count | histogram"
        f" | distinct | median | pNN, or an Aggregate instance)"
    )


@dataclasses.dataclass
class Query:
    """A declarative aggregate query plus its stopping rule.

    The stream stops at the first of: every aggregate's relative CI
    half-width <= ``target_rel_err`` (after ``min_blocks``); ``max_blocks``
    blocks read (default: one epoch, i.e. all ``K``).  ``histogram`` and
    progressive ``distinct`` aggregates carry no CI and never drive
    stopping.  ``use_sketches``: ``"auto"`` answers from the partition-time
    sketches when they suffice -- moment/label-count queries exactly, and
    (given v2 suites) ungrouped unfiltered ``quantile``/``distinct``
    within the KLL/KMV error bounds; ``True`` forces the sketch path
    (error if the query needs block data), ``False`` always streams
    blocks.

    ``where=`` restricts every aggregate to the rows passing the
    conjunctive column predicates (``"c3 > 0.5"`` strings, ``(col, op,
    value)`` tuples, :class:`~repro_torch.kernels.plan.Predicate` instances, or a
    sequence of them).  ``columns=`` projects the answer onto those feature
    columns (``feature=`` on an aggregate then indexes the *projected*
    axis).  Either one routes execution through the plan-compiled fused
    kernels (``repro_torch.kernels.plan``): predicates, projection, moments and
    histograms all happen in one pass per block, and a filtered query
    reports its observed :attr:`QueryResult.selectivity`.  Queries with
    ``where=`` cannot use the sketch-only fast path (partition-time
    sketches are unfiltered), so ``use_sketches=True`` raises.

    ``policy="query_aware"`` scores blocks with the query's own shape --
    predicate selectivity from the KLL sketches, dispersion of the
    aggregated feature, class coverage for grouped aggregates -- so the
    progressive scan reads the blocks that matter for *this* query first
    (Horvitz-Thompson reweighting keeps the estimates unbiased).

    ``sketch_impl`` picks how each block is sketched: ``"ref"`` (the numpy
    float64 oracle on a host copy), ``"torch"`` (the plain PyTorch version on
    the block's device), ``"cuda"`` (the CUDA kernels; blocks must be on the
    card) or ``"auto"`` (``"cuda"`` for blocks on the card, ``"torch"``
    otherwise).

    ``seed`` drives block selection and the bootstrap; ``None`` (the
    default) means "no seed pinned": direct execution falls back to 0; a
    serving layer replaces it with :func:`derive_seed`\\ ``(service seed,
    query id)`` so every submitted query gets an independent,
    schedule-invariant RNG stream.
    """

    aggregates: tuple[Aggregate, ...]
    target_rel_err: float | None = None
    confidence: float = 0.95
    max_blocks: int | None = None
    min_blocks: int = 3
    policy: str | SamplingPolicy = "uniform"
    seed: int | None = None
    bins: int = 128
    bootstrap: int = 200
    use_sketches: bool | str = "auto"
    sketch_impl: str = "auto"
    where: tuple[Predicate, ...] = ()
    columns: tuple[int, ...] | None = None
    #: record a convergence step after *every* block (not only when the
    #: stopping rule forces result materialization), so ``result.trace``
    #: reproduces the paper's error-vs-blocks trajectory at full resolution
    explain: bool = False

    def __post_init__(self):
        self.where = as_predicates(self.where)
        if self.columns is not None:
            self.columns = tuple(int(c) for c in self.columns)
            if not self.columns:
                raise ValueError("columns= must name at least one column")
        if not self.aggregates:
            raise ValueError("query needs at least one aggregate")
        if not 0.0 < self.confidence < 1.0:
            raise ValueError("confidence must be in (0, 1)")
        if self.target_rel_err is not None and self.target_rel_err <= 0:
            raise ValueError("target_rel_err must be positive")
        if self.min_blocks < 2:
            raise ValueError("min_blocks must be >= 2 (CIs need two block estimates)")
        if self.bins < 1:
            raise ValueError("bins must be >= 1")
        if self.bootstrap < 1:
            raise ValueError("bootstrap must be >= 1")


def as_query(spec, **kwargs) -> Query:
    """Build a :class:`Query` from a ``Query`` (kwargs must be empty), one
    aggregate spec, or a sequence of aggregate specs."""
    if isinstance(spec, Query):
        if kwargs:
            raise ValueError("pass stopping-rule kwargs inside the Query instance")
        return spec
    if isinstance(spec, (str, Aggregate)):
        spec = [spec]
    return Query(aggregates=tuple(parse_aggregate(a) for a in spec), **kwargs)


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AggregateResult:
    """Anytime estimate of one aggregate.  ``estimate`` / ``ci_lo`` /
    ``ci_hi`` are scalars, ``[F]``, ``[C]`` or ``[C, F]`` arrays (class axis
    first for ``by_label``); entries are NaN until observable (e.g. a class
    not yet seen).  ``rel_err`` is the worst relative CI half-width (None
    for ``histogram``, inf while fewer than two block estimates exist)."""

    name: str
    kind: str
    estimate: np.ndarray | float
    ci_lo: np.ndarray | float | None
    ci_hi: np.ndarray | float | None
    rel_err: float | None


@dataclasses.dataclass(frozen=True)
class QueryResult:
    """One anytime answer: the per-aggregate estimates after ``blocks_read``
    of ``total_blocks`` blocks, plus how the answer was produced
    (``from_sketches``; ``executor_stats`` meters the query's own cache
    hits / misses / fetches so "answered from N of K blocks" is honest).
    ``selectivity`` is the HT-weighted fraction of scanned rows passing the
    query's ``where=`` predicates (``None`` for unfiltered queries) -- the
    quantity that keeps filtered expansions honest.  ``trace`` is the
    query's :class:`~repro_torch.obs.convergence.ConvergenceTrace` -- one step per
    progressive emission (every block with ``explain=True``); all anytime
    results of one query share the same growing trace object."""

    aggregates: tuple[AggregateResult, ...]
    blocks_read: int
    total_blocks: int
    confidence: float
    target_rel_err: float | None
    converged: bool
    from_sketches: bool
    executor_stats: ExecutorStats | None = None
    selectivity: float | None = None
    trace: ConvergenceTrace | None = None

    def __getitem__(self, name: str) -> AggregateResult:
        for a in self.aggregates:
            if a.name == name:
                return a
        raise KeyError(f"no aggregate {name!r} in {[a.name for a in self.aggregates]}")

    @property
    def max_rel_err(self) -> float:
        errs = [a.rel_err for a in self.aggregates if a.rel_err is not None]
        return max(errs) if errs else math.inf

    def __str__(self) -> str:
        how = "sketches" if self.from_sketches else f"{self.blocks_read} blocks"
        parts = ", ".join(
            f"{a.name}={np.asarray(a.estimate).ravel()[0]:.4g}"
            + (f"±{(np.asarray(a.ci_hi) - np.asarray(a.ci_lo)).ravel()[0] / 2:.2g}"
               if a.ci_lo is not None else "")
            for a in self.aggregates
        )
        return (
            f"QueryResult({parts}; from {how} of {self.total_blocks},"
            f" rel_err={self.max_rel_err:.3g}, converged={self.converged})"
        )


# ---------------------------------------------------------------------------
# Per-aggregate streaming state
# ---------------------------------------------------------------------------

class _Ctx:
    """Shared per-query constants handed to every aggregate state."""

    def __init__(
        self, *, K, N, confidence, uniform, num_classes, bootstrap, seed,
        filtered=False,
    ):
        self.K = K                      # total blocks
        self.N = N                      # total records
        self.confidence = confidence
        self.uniform = uniform          # uniform w/o replacement -> exact fold + FPC
        self.num_classes = num_classes
        self.bootstrap = bootstrap
        self.seed = seed
        self.filtered = filtered        # where= predicates: subpopulation size unknown

    def t_half(self, b: int) -> float:
        return t_ppf(0.5 + self.confidence / 2.0, b - 1)

    def fpc(self, b: int) -> float:
        if not self.uniform or self.K <= 1:
            return 1.0
        return math.sqrt(max(self.K - b, 0) / (self.K - 1))


def _sel(arr: np.ndarray, feature: int | None) -> np.ndarray:
    return arr if feature is None else arr[..., feature]


class _MomentAgg:
    """mean / var / sum / count.

    Under the uniform policy the point estimate is the exact Chan fold over
    the blocks read, with Student-t CLT intervals across per-block
    estimates.  Under non-uniform policies every draw contributes
    Hansen-Hurwitz expansions of the corpus totals ``(count, sum, sum x^2)``
    -- ``w_k * t_k`` with ``w_k = 1/p_k`` (or ``K`` for the marginally
    uniform stratified single-draw stream) -- and the point estimates are
    the HT/Hajek forms built from them (mirroring
    ``combine_summaries(weights=...)``), so selection bias divides back out
    for mean, var, and sum alike.  Grouped variants keep one fold and one
    sample list per class; grouped means use the Hajek ratio (class counts
    are unknown), with approximate intervals over per-block class means."""

    def __init__(self, agg: Aggregate, ctx: _Ctx):
        self.agg = agg
        self.ctx = ctx
        self.groups = ctx.num_classes if agg.by_label else 1
        self.acc: list[BlockSketch | None] = [None] * self.groups
        self.samples: list[list[np.ndarray]] = [[] for _ in range(self.groups)]
        # per-draw HH expansions (count_hat, sum_hat, sumsq_hat), non-uniform
        self.ht: list[list[tuple]] = [[] for _ in range(self.groups)]

    def update(self, sketches: Sequence[BlockSketch], weight: float | None) -> None:
        from repro_torch.kernels.block_sketch import merge_sketches

        for g, sk in enumerate(sketches):
            kind = self.agg.kind
            if sk.count > 0:
                self.acc[g] = sk if self.acc[g] is None else merge_sketches(self.acc[g], sk)
            scale = weight if weight is not None else float(self.ctx.K)
            if not self.ctx.uniform:
                self.ht[g].append(
                    (
                        scale * sk.count,
                        scale * sk.sum,
                        scale * (sk.m2 + sk.count * sk.mean**2),
                    )
                )
            if kind == "mean":
                if sk.count > 0:
                    if (
                        weight is not None
                        and not self.agg.by_label
                        and not self.ctx.filtered
                    ):
                        # Hansen-Hurwitz: per-draw corpus-sum expansion over N
                        e = weight * sk.sum / max(self.ctx.N, 1)
                    else:
                        # per-block (sub)population mean; filtered queries
                        # cannot expand over N (subpopulation size unknown)
                        e = sk.mean
                    self.samples[g].append(np.asarray(e, dtype=np.float64))
            elif kind == "var":
                if self.ctx.uniform and sk.count > 1:
                    self.samples[g].append(np.asarray(sk.variance, dtype=np.float64))
            elif kind == "sum":
                self.samples[g].append(np.asarray(scale * sk.sum, dtype=np.float64))
            elif kind == "count":
                self.samples[g].append(np.asarray(scale * sk.count, dtype=np.float64))

    def _ht_totals(self, g: int):
        """Averaged HH expansions -> (count_hat, sum_hat, sumsq_hat)."""
        counts, sums, sumsqs = zip(*self.ht[g])
        return (
            float(np.mean(counts)),
            np.mean(sums, axis=0),
            np.mean(sumsqs, axis=0),
        )

    def _ht_var(self, g: int) -> tuple[np.ndarray, list[np.ndarray]] | None:
        """(point, per-draw plug-in samples) for var under non-uniform
        selection: ``(E_hat[sum x^2] - n * mu^2) / (n - 1)`` with the known
        corpus ``N`` (ungrouped) or the HT class count (grouped)."""
        if not self.ht[g]:
            return None
        c_hat, sum_hat, ss_hat = self._ht_totals(g)
        # filtered subpopulations have unknown size: use the HT count
        use_N = not self.agg.by_label and not self.ctx.filtered
        n = float(self.ctx.N) if use_N else c_hat
        if n <= 1:
            return None
        mu = sum_hat / n
        denom = n - 1.0
        point = np.maximum(ss_hat - n * mu**2, 0.0) / denom
        draws = [
            np.maximum(ss_i - n * mu**2, 0.0) / denom for (_, _, ss_i) in self.ht[g]
        ]
        return point, draws

    def _point(self, g: int) -> np.ndarray | None:
        acc, kind, ctx = self.acc[g], self.agg.kind, self.ctx
        samples = self.samples[g]
        if kind in ("sum", "count"):
            if not samples:
                return None
            return np.mean(samples, axis=0)
        if acc is None:
            return None
        if kind == "mean":
            if not ctx.uniform:
                if self.agg.by_label or ctx.filtered:
                    # Hajek ratio: HT (sub)population sum over HT count --
                    # selection bias divides out without knowing the size
                    c_hat, sum_hat, _ = self._ht_totals(g)
                    return sum_hat / max(c_hat, _EPS) if c_hat > 0 else None
                return np.mean(samples, axis=0)
            return acc.mean
        if not ctx.uniform:  # var under PPS: HT-expanded, not the raw fold
            ht = self._ht_var(g)
            return None if ht is None else ht[0]
        return acc.variance  # var, uniform: exact fold over blocks read

    def _ci_samples(self, g: int) -> list[np.ndarray]:
        if self.agg.kind == "var" and not self.ctx.uniform:
            ht = self._ht_var(g)
            return [] if ht is None else ht[1]
        return self.samples[g]

    def result(self) -> AggregateResult:
        ests, los, his, rels = [], [], [], []
        for g in range(self.groups):
            pt = self._point(g)
            samples = self._ci_samples(g)
            b = len(samples)
            if pt is None:
                ests.append(None)
                los.append(None)
                his.append(None)
                continue
            sl = self.agg.feature if self.agg.kind != "count" else None
            pt = _sel(np.asarray(pt, dtype=np.float64), sl)
            if b >= 2:
                arr = np.stack(samples)
                se = _sel(arr, sl).std(axis=0, ddof=1) / math.sqrt(b)
                half = self.ctx.t_half(b) * self.ctx.fpc(b) * se
            else:
                half = np.full(np.shape(pt), np.inf)
            ests.append(pt)
            los.append(pt - half)
            his.append(pt + half)
            rels.append(float(np.max(half / np.maximum(np.abs(pt), _EPS))))
        est, lo, hi = (_stack_groups(v, self.agg.by_label) for v in (ests, los, his))
        rel = max(rels) if rels and len(rels) == self.groups else math.inf
        return AggregateResult(self.agg.label, self.agg.kind, est, lo, hi, rel)


class _HistAgg:
    """quantile / histogram: mergeable fixed-grid histograms per block, with
    bootstrap-over-block-histograms intervals for quantiles."""

    def __init__(self, agg: Aggregate, ctx: _Ctx, lo: np.ndarray, hi: np.ndarray):
        self.agg = agg
        self.ctx = ctx
        self.lo = lo
        self.hi = hi
        self.groups = ctx.num_classes if agg.by_label else 1
        self.hists: list[list[np.ndarray]] = [[] for _ in range(self.groups)]
        self.weights: list[float] = []

    def update(self, sketches: Sequence[BlockSketch], weight: float | None) -> None:
        for g, sk in enumerate(sketches):
            self.hists[g].append(sk.hist.astype(np.float64))
        self.weights.append(weight if weight is not None else float(self.ctx.K))

    def _weighted(self, g: int) -> np.ndarray:
        """Per-block histograms HT-expanded by their draw weights [b, F, bins]
        (uniform policy: constant K, so quantiles are unaffected)."""
        w = np.asarray(self.weights)[:, None, None]
        return w * np.stack(self.hists[g])

    def _merged(self, g: int) -> np.ndarray:
        """HT estimate of the corpus histogram (counts scaled to N)."""
        return self._weighted(g).sum(axis=0) / len(self.weights)

    def _quantile(self, merged: np.ndarray) -> np.ndarray:
        q = quantile_from_histogram(merged, [self.agg.q], lo=self.lo, hi=self.hi)[:, 0]
        return _sel(q, self.agg.feature)

    def result(self) -> AggregateResult:
        if self.agg.kind == "histogram":
            f = self.agg.feature
            ests = [
                m if f is None else m[f]
                for m in (self._merged(g) for g in range(self.groups))
            ]
            est = _stack_groups(ests, self.agg.by_label)
            return AggregateResult(self.agg.label, "histogram", est, None, None, None)
        ests, los, his, rels = [], [], [], []
        alpha = 1.0 - self.ctx.confidence
        for g in range(self.groups):
            b = len(self.hists[g])
            merged = self._merged(g)
            if merged.sum() <= 0:
                ests.append(None)
                los.append(None)
                his.append(None)
                continue
            pt = self._quantile(merged)
            if b >= 2:
                rng = np.random.default_rng(
                    np.random.SeedSequence([self.ctx.seed, 0xB0075, g, b])
                )
                stacked = self._weighted(g)              # [b, F, bins] HT-scaled
                idx = rng.integers(0, b, size=(self.ctx.bootstrap, b))
                boots = stacked[idx].sum(axis=1)         # [B, F, bins]
                B, F, nbins = boots.shape
                qs = quantile_from_histogram(
                    boots.reshape(B * F, nbins),
                    [self.agg.q],
                    lo=np.tile(self.lo, B),
                    hi=np.tile(self.hi, B),
                )[:, 0].reshape(B, F)
                qs = _sel(qs, self.agg.feature)
                lo = np.quantile(qs, alpha / 2, axis=0)
                hi = np.quantile(qs, 1 - alpha / 2, axis=0)
            else:
                lo = np.full(np.shape(pt), -np.inf)
                hi = np.full(np.shape(pt), np.inf)
            half = (np.asarray(hi) - np.asarray(lo)) / 2.0
            ests.append(pt)
            los.append(lo)
            his.append(hi)
            rels.append(float(np.max(half / np.maximum(np.abs(pt), _EPS))))
        est, lo, hi = (_stack_groups(v, self.agg.by_label) for v in (ests, los, his))
        rel = max(rels) if rels and len(rels) == self.groups else math.inf
        return AggregateResult(self.agg.label, "quantile", est, lo, hi, rel)


class _DistinctAgg:
    """distinct: one KMV sketch per (projected) feature, fed the filtered
    rows of every read block.  A distinct count over a *sample* of blocks is
    a lower bound on the corpus count -- unseen blocks may hold unseen
    values -- so the running estimate carries no CI and never drives early
    stopping; after a full scan it is the KMV estimate of the true count."""

    def __init__(self, agg: Aggregate, ctx: _Ctx):
        from repro_torch.rsp.sketch import DistinctSketch

        self.agg = agg
        self.ctx = ctx
        self.sketch = DistinctSketch()

    def update(self, sketches: Sequence[BlockSketch], weight: float | None) -> None:
        pass  # fed per-block KMV sketches via merge_block, not moments

    def merge_block(self, block_sketch) -> None:
        """Fold one block's KMV sketch.  k-min-of-union == union-of-k-mins,
        so merging per-block sketches is *exactly* equal to feeding the raw
        rows -- which is what lets distributed hosts ship sketches instead
        of rows."""
        if block_sketch is not None:
            self.sketch = self.sketch.merge(block_sketch)

    def result(self) -> AggregateResult:
        try:
            vals = self.sketch.estimate()
        except ValueError:  # no rows survived the predicates yet
            return AggregateResult(self.agg.label, "distinct", math.nan, None, None, None)
        est = _sel(np.asarray(vals, dtype=np.float64), self.agg.feature)
        est = float(est) if np.ndim(est) == 0 else np.asarray(est)
        return AggregateResult(self.agg.label, "distinct", est, None, None, None)


def _stack_groups(values: list, by_label: bool):
    """Stack per-class results into a leading class axis (NaN for classes
    not yet observed); scalar-ize ungrouped single-element results."""
    shaped = [np.asarray(v, dtype=np.float64) for v in values if v is not None]
    if not shaped:
        return math.nan if not by_label else np.full(len(values), np.nan)
    proto = np.full(shaped[0].shape, np.nan)
    filled = [np.asarray(v, np.float64) if v is not None else proto for v in values]
    if not by_label:
        out = filled[0]
        return float(out.reshape(-1)[0]) if out.shape in ((), (1,)) else out
    return np.stack(filled)


def _scalar0(value) -> float:
    """First element of an estimate, for compact convergence-trace rows."""
    arr = np.asarray(value, dtype=np.float64).ravel()
    return float(arr[0]) if arr.size else math.nan


def _half_width(r: AggregateResult) -> float:
    """Worst CI half-width of one aggregate (NaN when it carries no CI)."""
    if r.ci_lo is None or r.ci_hi is None:
        return math.nan
    half = (
        np.asarray(r.ci_hi, dtype=np.float64) - np.asarray(r.ci_lo, dtype=np.float64)
    ) / 2.0
    half = np.atleast_1d(half)
    return float(np.nanmax(half)) if np.any(~np.isnan(half)) else math.nan


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

class QueryExecutor:
    """Runs one :class:`Query` against an ``RSPDataset``-like object (needs
    ``spec``, ``num_blocks``, ``executor``, ``policy()``, ``summaries`` /
    ``has_summaries``, and ``num_classes`` / ``label_column`` for grouped
    aggregates)."""

    def __init__(self, dataset, query: Query):
        self.ds = dataset
        self.q = query
        self.seed = 0 if query.seed is None else int(query.seed)
        # every access this query makes is attributed here (as well as to the
        # executor's global counters) -- snapshot deltas of the shared
        # executor would claim other queries' I/O the moment two interleave
        self.counter = CallerStats()
        self._t0 = time.perf_counter()
        # root span for this query; its context is handed explicitly to the
        # engine workers (and by QueryService to its scheduler/sweeper) so
        # cross-thread spans parent under it.  None when telemetry is off.
        self.span = (
            obs.get_tracer().start_span(
                "query",
                attrs={"aggs": ",".join(a.label for a in query.aggregates)},
            )
            if obs.enabled()
            else None
        )
        if any(a.by_label for a in query.aggregates) and dataset.num_classes is None:
            raise ValueError("by_label aggregates need num_classes on the dataset")
        # where= / columns= route block passes through the plan-compiled
        # fused kernels instead of the legacy whole-block sketch
        self.planned = bool(query.where) or query.columns is not None

    @property
    def ctx(self):
        """Trace context of this query's root span (None when telemetry is
        off) -- pass as ``parent=`` / ``trace=`` across threads."""
        return self.span.ctx if self.span is not None else None

    def end_span(self) -> None:
        """Idempotently close the root span.  Called when the stream
        finishes or is closed; QueryService also calls it at retire time so
        never-started generators don't leak open spans."""
        if self.span is not None:
            self.span.end()

    def _plan(self, *, grouped: bool) -> QueryPlan:
        if grouped:
            return QueryPlan(
                predicates=self.q.where,
                columns=self.q.columns,
                group_by=self.ds.label_column,
                num_classes=self.ds.num_classes,
            )
        return QueryPlan(predicates=self.q.where, columns=self.q.columns)

    # -- sketch fast path --------------------------------------------------
    def _suites_have(self, kind: str) -> bool:
        """Whether the dataset's sketch suites carry a ``kind`` member.  A
        sketch-less dataset reports True: forcing the fast path computes
        fresh suites, which carry the full default kind set."""
        if not self.ds.has_summaries:
            return True
        summaries = self.ds.summaries
        if not summaries:
            return False
        s = summaries[0]
        return callable(getattr(s, "get", None)) and s.get(kind) is not None

    def _sketch_eligible(self) -> bool:
        if self.q.where:
            # partition-time sketches are unfiltered; a predicate needs rows
            return False
        for a in self.q.aggregates:
            if a.kind in _SKETCH_ONLY_KINDS:
                if a.by_label and a.kind != "count":
                    return False
            elif a.kind == "quantile":
                # KLL answers any ungrouped quantile within its rank bound
                if a.by_label or not self._suites_have("kll"):
                    return False
            elif a.kind == "distinct":
                if not self._suites_have("distinct"):
                    return False
            else:  # histogram needs the query's own grid/bins -> block data
                return False
        return True

    def _merged_sketch(self, summaries, kind: str):
        """Corpus-level sketch of one kind: union of the per-block sketches
        (fresh object -- the stored suites are never mutated)."""
        from repro_torch.rsp.sketch import sketch_from_dict

        acc = None
        for s in summaries:
            sk = s.get(kind) if callable(getattr(s, "get", None)) else None
            if sk is None:
                raise ValueError(
                    f"sketch-only answers need {kind!r} sketches in the"
                    " manifest (re-partition the store, or pass"
                    " use_sketches=False)"
                )
            if acc is None:
                acc = sketch_from_dict(sk.to_dict())
            else:
                acc.merge(sk)
        return acc

    def _answer_from_sketches(self) -> QueryResult:
        from repro_torch.rsp.summaries import combine_summaries

        # forcing this path on a sketch-less dataset computes the sketches
        # (a full-corpus pass through the executor) -- meter it honestly
        summaries = self._materialized_summaries()
        stats = combine_summaries(summaries)
        cols = None
        if self.q.columns is not None:
            f = np.asarray(stats.mean).shape[-1]
            cols = [c % f for c in self.q.columns]

        def proj(arr):
            # columns= projection: sketches cover all features, so a
            # projected query just selects before feature indexing
            return arr if cols is None else np.asarray(arr)[..., cols]

        def shape(v):
            v = np.asarray(v, dtype=np.float64)
            return float(v) if v.ndim == 0 else v

        merged_cache: dict = {}

        def merged(kind):
            if kind not in merged_cache:
                merged_cache[kind] = self._merged_sketch(summaries, kind)
            return merged_cache[kind]

        out = []
        for a in self.q.aggregates:
            lo_v = hi_v = None
            rel = 0.0
            if a.kind == "count" and a.by_label:
                hists = [s.label_hist for s in summaries]
                if any(h is None for h in hists):
                    raise ValueError("grouped count needs label histograms in the sketches")
                est = np.sum(hists, axis=0).astype(np.float64)
            elif a.kind == "count":
                est = float(stats.count)
            elif a.kind == "mean":
                est = _sel(proj(stats.mean), a.feature)
            elif a.kind == "var":
                est = _sel(proj(stats.variance), a.feature)
            elif a.kind == "sum":
                est = _sel(proj(stats.count * stats.mean), a.feature)
            elif a.kind == "quantile":
                # KLL: point at rank q, interval at ranks q -+ eps -- the
                # sketch's additive rank-error bound, mapped through the
                # value axis (an honest, data-dependent interval)
                kll = merged("kll")
                eps = kll.rank_error_bound()
                vals = kll.quantile(
                    [max(a.q - eps, 0.0), a.q, min(a.q + eps, 1.0)]
                )  # [F, 3]
                lo_v = shape(_sel(proj(vals[:, 0]), a.feature))
                est = _sel(proj(vals[:, 1]), a.feature)
                hi_v = shape(_sel(proj(vals[:, 2]), a.feature))
                half = (np.asarray(hi_v) - np.asarray(lo_v)) / 2.0
                rel = float(
                    np.max(half / np.maximum(np.abs(np.asarray(est)), _EPS))
                )
            else:  # distinct: KMV estimate with its known relative SE
                kmv = merged("distinct")
                rel = float(kmv.relative_error_bound())
                est = _sel(proj(kmv.estimate()), a.feature)
                lo_v = shape(np.asarray(est) * (1.0 - rel))
                hi_v = shape(np.asarray(est) * (1.0 + rel))
            est = shape(est)
            if lo_v is None:
                # all K sketches combined == the exact corpus statistic
                lo_v = hi_v = est
            out.append(AggregateResult(a.label, a.kind, est, lo_v, hi_v, rel))
        rels = [r.rel_err for r in out if r.rel_err is not None]
        max_rel = max(rels) if rels else 0.0
        trace = ConvergenceTrace(
            confidence=self.q.confidence, target_rel_err=self.q.target_rel_err
        )
        trace.record(
            ConvergenceStep(
                blocks_read=0,
                block_id=None,
                max_rel_err=max_rel,
                estimates={r.name: _scalar0(r.estimate) for r in out},
                half_widths={r.name: _half_width(r) for r in out},
                cum_fetch_s=self.counter.fetch_seconds(),
                elapsed_s=time.perf_counter() - self._t0,
            )
        )
        return QueryResult(
            aggregates=tuple(out),
            blocks_read=0,
            total_blocks=self.ds.num_blocks,
            confidence=self.q.confidence,
            target_rel_err=self.q.target_rel_err,
            converged=(
                self.q.target_rel_err is None or max_rel <= self.q.target_rel_err
            ),
            from_sketches=True,
            executor_stats=self.counter.stats(),
            trace=trace,
        )

    def _materialized_summaries(self):
        """``ds.summaries``, with a lazy full-corpus sketch pass attributed
        to this query's counter (it is this query's I/O)."""
        if not self.ds.has_summaries:
            self.ds._summaries = self.ds._compute_summaries(counter=self.counter)
        return self.ds.summaries

    # -- progressive path --------------------------------------------------
    def _grid(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-feature histogram grid for the progressive path: the
        partition-time sketches' global extrema, tightened by the merged KLL
        sketch when the query is a pure unfiltered, ungrouped quantile --
        the fixed bin budget then resolves the rank range the query asks
        about instead of stretching over heavy tails (mass outside still
        clips into the edge bins, so merged counts stay consistent).
        Projected onto the query's ``columns=`` when set (filtered data
        always lies inside the unfiltered extrema)."""
        summaries = self._materialized_summaries()
        lo = np.min([s.min for s in summaries], axis=0).astype(np.float64)
        hi = np.max([s.max for s in summaries], axis=0).astype(np.float64)
        tight = self._kll_grid(summaries, lo, hi)
        if tight is not None:
            lo, hi = tight
        pad = np.maximum(1e-9, 1e-9 * (hi - lo))
        lo, hi = lo - pad, hi + pad
        if self.q.columns is not None:
            cols = [c % lo.shape[0] for c in self.q.columns]
            lo, hi = lo[cols], hi[cols]
        return lo, hi

    def _kll_grid(self, summaries, lo, hi):
        """KLL-seeded ``(lo, hi)``, or None to keep the extrema grid.  Only
        safe when every grid consumer is an ungrouped, unfiltered quantile:
        filtered or per-class distributions can concentrate in a corpus
        tail the tightened grid would clip to one bin."""
        aggs = self.q.aggregates
        qs = [a.q for a in aggs if a.kind == "quantile" and not a.by_label]
        if (
            not qs
            or self.q.where
            or any(a.kind == "histogram" for a in aggs)
            or any(a.kind == "quantile" and a.by_label for a in aggs)
        ):
            return None
        try:
            kll = self._merged_sketch(summaries, "kll")
        except ValueError:  # v1 suites: no KLL -> extrema grid
            return None
        eps = kll.rank_error_bound()
        vals = kll.quantile(
            [max(min(qs) - 2.0 * eps, 0.0), min(max(qs) + 2.0 * eps, 1.0)]
        )  # [F, 2]
        margin = 0.05 * (vals[:, 1] - vals[:, 0])
        tlo = np.maximum(vals[:, 0] - margin, lo)
        thi = np.minimum(vals[:, 1] + margin, hi)
        # constant / degenerate features keep their extrema span
        bad = ~np.isfinite(tlo) | ~np.isfinite(thi) | ~(thi > tlo)
        return np.where(bad, lo, tlo), np.where(bad, hi, thi)

    def _make_states(self, needs_hist: bool):
        ctx = _Ctx(
            K=self.ds.num_blocks,
            N=self.ds.spec.num_records,
            confidence=self.q.confidence,
            uniform=isinstance(self._pol, UniformPolicy),
            num_classes=self.ds.num_classes,
            bootstrap=self.q.bootstrap,
            seed=self.seed,
            filtered=bool(self.q.where),
        )
        lo = hi = None
        if needs_hist:
            lo, hi = self._grid()
        states = []
        for a in self.q.aggregates:
            if a.kind in ("quantile", "histogram"):
                states.append(_HistAgg(a, ctx, lo, hi))
            elif a.kind == "distinct":
                states.append(_DistinctAgg(a, ctx))
            else:
                states.append(_MomentAgg(a, ctx))
        return states, lo, hi

    def _plan_sketches(self, block, lo, hi, needs_hist, grouped, need_whole) -> dict:
        """Plan-compiled path for ``where=`` / ``columns=`` queries: one
        fused filter+project+sketch pass per needed grouping, through the
        plan compile cache."""
        bins = self.q.bins if needs_hist else 0
        kw = dict(bins=bins) if not needs_hist else dict(bins=bins, lo=lo, hi=hi)
        whole = per_class = None
        res = None
        if need_whole:
            res = plan_sketch(
                block, self._plan(grouped=False), impl=self.q.sketch_impl, **kw
            )
            whole = res.sketches[0]
        if grouped:
            res_g = plan_sketch(
                block, self._plan(grouped=True), impl=self.q.sketch_impl, **kw
            )
            per_class = res_g.sketches
            res = res if res is not None else res_g
        return {
            "whole": whole,
            "per_class": per_class,
            "rows_total": res.rows_total,
            "rows_selected": res.rows_selected,
        }

    def _block_sketches(self, block, lo, hi, needs_hist, grouped, need_whole) -> dict:
        """One fused pass over the block; per-class sub-sketches on demand.
        ``need_whole=False`` (every aggregate grouped) skips the dead
        whole-block pass."""
        if self.planned:
            return self._plan_sketches(block, lo, hi, needs_hist, grouped, need_whole)
        bins = self.q.bins if needs_hist else 0
        kw = dict(bins=bins) if not needs_hist else dict(bins=bins, lo=lo, hi=hi)
        impl = self.q.sketch_impl
        whole = block_sketch(block, impl=impl, **kw) if need_whole else None
        per_class = None
        if grouped:
            per_class = self._class_sketches(block, impl, bins, kw)
        n = int(block.shape[0])
        return {
            "whole": whole, "per_class": per_class,
            "rows_total": n, "rows_selected": n,
        }

    def _class_sketches(self, block, impl, bins, kw) -> list[BlockSketch]:
        """Per-class sketches of an unplanned grouped query.  ``ref`` splits
        a host copy of the block by truncated label and sketches each class
        in float64; every other impl keeps the block on its device and runs
        the plan pass with ``group_by = label_column`` (the CUDA kernel for
        a block on the card).  Both produce the same fields, an empty class
        included: zero moments, infinite extrema, a zero histogram and no
        grid."""
        from repro_torch.kernels.block_sketch import block_sketch_ref

        f = int(np.prod(block.shape[1:]))
        needs_hist = bins > 0

        def empty() -> BlockSketch:
            return BlockSketch(
                count=0.0,
                mean=np.zeros(f),
                m2=np.zeros(f),
                min=np.full(f, np.inf),
                max=np.full(f, -np.inf),
                hist=np.zeros((f, bins), np.int64) if needs_hist else None,
            )

        if impl == "ref":
            x = as_numpy(block).reshape(block.shape[0], -1)
            labels = x[:, self.ds.label_column % x.shape[1]].astype(np.int64)
            out = []
            for c in range(self.ds.num_classes):
                rows = x[labels == c]
                out.append(empty() if rows.shape[0] == 0 else block_sketch_ref(rows, **kw))
            return out
        plan = QueryPlan(group_by=self.ds.label_column, num_classes=self.ds.num_classes)
        res = plan_sketch(block, plan, impl=impl, **kw)
        return [sk if sk.count > 0 else empty() for sk in res.sketches]

    def _make_payload(
        self, block, lo, hi, needs_hist, needs_rows, grouped, need_whole
    ) -> dict:
        """Everything the fold needs from one block, as mergeable state.

        The payload is a pure function of ``(block bytes, query shape)`` --
        no draw-order or host-local state -- which is what makes distributed
        execution bit-identical to single-host: any host computing this
        block's payload produces the same dict, so *where* it is computed is
        irrelevant to the fold."""
        payload = self._block_sketches(block, lo, hi, needs_hist, grouped, need_whole)
        payload["distinct"] = (
            self._distinct_sketch(block) if needs_rows else None
        )
        return payload

    def _distinct_sketch(self, block):
        """Per-block KMV sketch of the filtered/projected rows (k-min of a
        union == union of k-mins, so folding these per-block sketches is
        exactly the single-pass sketch of all surviving rows)."""
        from repro_torch.rsp.sketch import DistinctSketch

        q = self.q
        rows = as_numpy(block).astype(np.float64)  # KMV hashing runs on the host
        rows = rows.reshape(rows.shape[0], -1)
        if q.where:
            xf = rows.astype(np.float32)
            keep = np.ones(rows.shape[0], dtype=bool)
            for p in q.where:
                keep &= p.mask(xf)
            rows = rows[keep]
        if q.columns is not None:
            cols = [c % rows.shape[1] for c in q.columns]
            rows = rows[:, cols]
        sk = DistinctSketch()
        if rows.size:
            sk.update(rows)
        return sk

    def _payload_source(
        self, ids, lo, hi, *, needs_hist, needs_rows, grouped, need_whole
    ) -> Iterator[tuple[int, dict]]:
        """Yield ``(block_id, payload)`` in selection order.

        This is the single seam between *selecting and computing* blocks and
        *folding* them: the single-host source streams local blocks through
        the executor; a multi-host source overrides only this method to
        gather peer-computed payloads, so both paths fold the same payloads
        through identical code.  Blocks arrive as tensors on the dataset's
        device and their payloads are computed on this (the caller's)
        thread."""
        executor = self.ds.executor
        for bid, block in executor.map_blocks(
            None, ids, with_ids=True, counter=self.counter, trace=self.ctx
        ):
            yield bid, self._make_payload(
                block, lo, hi, needs_hist, needs_rows, grouped, need_whole
            )

    def stream(self) -> Iterator[QueryResult]:
        """One anytime :class:`QueryResult` per block read."""
        return self._stream(anytime=True)

    def _stream(self, *, anytime: bool) -> Iterator[QueryResult]:
        try:
            yield from self._stream_impl(anytime=anytime)
        finally:
            # covers run(), exhausted streams, and gen.close() on a started
            # generator; QueryService additionally closes never-started ones
            self.end_span()

    def _stream_impl(self, *, anytime: bool) -> Iterator[QueryResult]:
        q = self.q
        if q.use_sketches is True or (
            q.use_sketches == "auto" and self._sketch_eligible() and self.ds.has_summaries
        ):
            if not self._sketch_eligible():
                raise ValueError(
                    "use_sketches=True but the query needs block data"
                    " (where= predicates, histogram, grouped non-count"
                    " aggregates, or quantile/distinct without the matching"
                    " partition-time sketches)"
                )
            res = self._answer_from_sketches()
            # auto mode falls through to the progressive path when the
            # sketch error bound (KLL/KMV) cannot meet the requested target;
            # forcing use_sketches=True returns the bound-limited answer
            if q.use_sketches is True or res.converged:
                yield res
                return

        # sketch probabilities (weighted/stratified) and the histogram grid
        # both come from ds.summaries, which on a sketch-less dataset reads
        # every block -- those passes belong in this query's honest I/O count
        if isinstance(q.policy, str) and q.policy != "uniform":
            self._materialized_summaries()
        pol_kwargs = {}
        if q.policy == "query_aware":
            # hand the policy this query's shape: its predicates (KLL
            # selectivity), the aggregated feature (dispersion), and
            # whether it groups by label (class coverage)
            feature = None
            feats = {a.feature for a in q.aggregates if a.feature is not None}
            if len(feats) == 1:
                feature = next(iter(feats))
                if q.columns is not None:  # map back to corpus column ids
                    feature = q.columns[feature % len(q.columns)]
            pol_kwargs = dict(
                predicates=q.where,
                feature=feature,
                by_label=any(a.by_label for a in q.aggregates),
            )
        self._pol = self.ds.policy(q.policy, seed=self.seed, **pol_kwargs)
        uniform = isinstance(self._pol, UniformPolicy)
        K = self.ds.num_blocks
        max_blocks = q.max_blocks if q.max_blocks is not None else K
        if uniform:
            max_blocks = min(max_blocks, K)
        if max_blocks < 1:
            raise ValueError("max_blocks must be >= 1")
        needs_hist = any(a.kind in ("quantile", "histogram") for a in q.aggregates)
        needs_rows = any(a.kind == "distinct" for a in q.aggregates)
        grouped = any(a.by_label for a in q.aggregates)
        need_whole = any(not a.by_label for a in q.aggregates)
        states, lo, hi = self._make_states(needs_hist)

        def gen_ids():
            for _ in range(max_blocks):
                yield self._pol.sample(1)[0]

        b = 0
        filtered = bool(q.where)
        sel_rows = tot_rows = 0.0  # HT-weighted selectivity ratio estimator
        trace = ConvergenceTrace(confidence=q.confidence, target_rel_err=q.target_rel_err)
        source = self._payload_source(
            gen_ids(), lo, hi, needs_hist=needs_hist, needs_rows=needs_rows,
            grouped=grouped, need_whole=need_whole,
        )
        try:
            for bid, sk in source:
                weight = None
                if isinstance(self._pol, WeightedPolicy):
                    weight = float(self._pol.weights([bid])[0])
                if needs_rows:
                    for state in states:
                        if isinstance(state, _DistinctAgg):
                            state.merge_block(sk["distinct"])
                scale = weight if weight is not None else float(K)
                sel_rows += scale * sk["rows_selected"]
                tot_rows += scale * sk["rows_total"]
                for agg, state in zip(q.aggregates, states):
                    state.update(
                        sk["per_class"] if agg.by_label else [sk["whole"]], weight
                    )
                b += 1
                # materializing results is not free (quantile CIs bootstrap
                # over all b histograms); when nothing can stop the scan early
                # and the caller only wants the final answer, skip the
                # intermediate ones
                must_emit = (
                    anytime or q.explain or q.target_rel_err is not None
                    or b == max_blocks
                )
                if not must_emit:
                    continue
                results = tuple(s.result() for s in states)
                errs = [r.rel_err for r in results if r.rel_err is not None]
                converged = (
                    q.target_rel_err is not None
                    and b >= q.min_blocks
                    and bool(errs)
                    and max(errs) <= q.target_rel_err
                )
                trace.record(
                    ConvergenceStep(
                        blocks_read=b,
                        block_id=int(bid),
                        max_rel_err=max(errs) if errs else math.inf,
                        estimates={r.name: _scalar0(r.estimate) for r in results},
                        half_widths={r.name: _half_width(r) for r in results},
                        cum_fetch_s=self.counter.fetch_seconds(),
                        elapsed_s=time.perf_counter() - self._t0,
                    )
                )
                yield QueryResult(
                    aggregates=results,
                    blocks_read=b,
                    total_blocks=K,
                    confidence=q.confidence,
                    target_rel_err=q.target_rel_err,
                    converged=converged,
                    from_sketches=False,
                    executor_stats=self.counter.stats(),
                    selectivity=(
                        sel_rows / max(tot_rows, 1.0) if filtered else None
                    ),
                    trace=trace,
                )
                if converged:
                    return
        finally:
            # GeneratorExit / convergence must reach the source's own finally
            # (a distributed source publishes its stop marker there)
            source.close()

    def run(self) -> QueryResult:
        result = None
        for result in self._stream(anytime=False):
            pass
        assert result is not None  # max_blocks >= 1 guarantees one emission
        return result
