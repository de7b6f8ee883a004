"""``repro_torch.obs.convergence`` -- per-query statistical convergence traces.

The paper's claim is that estimates from a few RSP blocks converge to
the whole-data answer; a :class:`ConvergenceTrace` records that
trajectory for a *live* query: one :class:`ConvergenceStep` per
progressive emission, carrying blocks consumed, per-aggregate point
estimates and CI half-widths, the worst relative CI half-width, and
cumulative fetch latency.  The trace rides on ``QueryResult.trace``
(enable with ``ds.query(..., explain=True)`` or any progressive
streaming query) and renders a terminal report via :meth:`report`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class ConvergenceStep:
    """One progressive emission of a running query."""

    blocks_read: int
    block_id: int | None
    #: worst relative CI half-width across aggregates (inf until defined)
    max_rel_err: float
    #: per-aggregate point estimate, keyed by aggregate name
    estimates: dict[str, float]
    #: per-aggregate CI half-width ((hi - lo) / 2), NaN when CI undefined
    half_widths: dict[str, float]
    #: cumulative seconds this query's caller spent in fetcher.fetch()
    cum_fetch_s: float
    #: seconds since the query started
    elapsed_s: float


@dataclass
class ConvergenceTrace:
    """Append-only trajectory of a progressive query.

    The same trace object is shared by every ``QueryResult`` a streaming
    query emits, so the final result's trace holds the full history.
    """

    confidence: float = 0.95
    target_rel_err: float | None = None
    steps: list[ConvergenceStep] = field(default_factory=list)

    def record(self, step: ConvergenceStep) -> None:
        self.steps.append(step)

    def __len__(self) -> int:
        return len(self.steps)

    @property
    def blocks(self) -> list[int]:
        return [s.blocks_read for s in self.steps]

    @property
    def rel_errs(self) -> list[float]:
        return [s.max_rel_err for s in self.steps]

    def half_widths(self, name: str) -> list[float]:
        """CI half-width trajectory for one aggregate."""
        return [s.half_widths.get(name, math.nan) for s in self.steps]

    def to_dict(self) -> dict:
        return {
            "confidence": self.confidence,
            "target_rel_err": self.target_rel_err,
            "steps": [
                {
                    "blocks_read": s.blocks_read,
                    "block_id": s.block_id,
                    "max_rel_err": s.max_rel_err,
                    "estimates": dict(s.estimates),
                    "half_widths": dict(s.half_widths),
                    "cum_fetch_s": s.cum_fetch_s,
                    "elapsed_s": s.elapsed_s,
                }
                for s in self.steps
            ],
        }

    def report(self, *, width: int = 32, max_rows: int | None = 24) -> str:
        """Terminal-friendly error-vs-blocks report with a log-scale bar
        per step -- the paper's convergence plot, in ASCII.  Traces longer
        than ``max_rows`` are evenly subsampled (first and last steps always
        shown); pass ``max_rows=None`` for every step."""
        if not self.steps:
            return "(no convergence steps recorded)"
        shown = self.steps
        if max_rows is not None and len(shown) > max(2, max_rows):
            last = len(shown) - 1
            idx = sorted({round(i * last / (max_rows - 1)) for i in range(max_rows)})
            shown = [self.steps[i] for i in idx]
        lines = [
            f"convergence: {len(self.steps)} steps, "
            f"{self.steps[-1].blocks_read} blocks, "
            f"{int(self.confidence * 100)}% CI"
            + (f", target rel err {self.target_rel_err:g}" if self.target_rel_err else "")
            + (f" (showing {len(shown)} of {len(self.steps)} steps)"
               if len(shown) < len(self.steps) else "")
        ]
        finite = [s.max_rel_err for s in self.steps if math.isfinite(s.max_rel_err)]
        lo = min(finite) if finite else 1.0
        hi = max(finite) if finite else 1.0
        lo = max(lo, 1e-12)
        span = math.log(max(hi, 1e-12) / lo) or 1.0
        for s in shown:
            if math.isfinite(s.max_rel_err):
                frac = math.log(max(s.max_rel_err, 1e-12) / lo) / span
                bar = "#" * max(1, round(frac * width))
                err = f"{s.max_rel_err:9.2e}"
            else:
                bar, err = "?", "      inf"
            mark = ""
            if self.target_rel_err is not None and s.max_rel_err <= self.target_rel_err:
                mark = "  <- target met"
            lines.append(
                f"  blocks={s.blocks_read:4d}  rel_err={err}  "
                f"fetch={s.cum_fetch_s * 1e3:8.1f}ms  |{bar}{mark}"
            )
        return "\n".join(lines)


__all__ = ["ConvergenceStep", "ConvergenceTrace"]
