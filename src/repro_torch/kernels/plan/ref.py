"""Oracle for the fused plan kernels: mask, project, then sketch with the
plain-numpy :func:`~repro_torch.kernels.block_sketch.ref.block_sketch_ref`.

This is the *two-pass* baseline the fused kernels are benchmarked against
(materialize the boolean mask, copy the surviving rows, then sketch them
per group) and the parity reference the fused results must match to 1e-5
on moments.  Histograms carry the repo's standing bin-edge caveat: values
lying exactly on a bin edge may land in adjacent bins between the f32
fused paths and this f64 reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.kernels.block_sketch.ref import BlockSketch, _grid, block_sketch_ref
from repro_torch.kernels.plan.plan import QueryPlan


def empty_sketch(
    num_features: int,
    bins: int = 0,
    lo: np.ndarray | None = None,
    hi: np.ndarray | None = None,
) -> BlockSketch:
    """The identity element: a sketch of zero rows (inf/-inf extrema, zero
    histogram) that merges as a no-op."""
    f = int(num_features)
    return BlockSketch(
        count=0.0,
        mean=np.zeros(f),
        m2=np.zeros(f),
        min=np.full(f, np.inf),
        max=np.full(f, -np.inf),
        hist=np.zeros((f, bins), np.int64) if bins > 0 else None,
        lo=lo,
        hi=hi,
    )


@dataclasses.dataclass
class PlanResult:
    """Outcome of one fused block pass: how many rows the block held, how
    many survived the predicates, and one sketch per plan group (length 1
    ungrouped, ``num_classes`` grouped) over the *projected* features of
    the surviving rows."""

    rows_total: int
    rows_selected: int
    sketches: list[BlockSketch]

    @property
    def selectivity(self) -> float:
        return self.rows_selected / max(self.rows_total, 1)


def plan_sketch_ref(
    block,
    plan: QueryPlan,
    *,
    bins: int = 0,
    lo=0.0,
    hi=1.0,
) -> PlanResult:
    """Reference execution of ``plan`` over one block: float32 predicate
    mask -> row materialization -> per-group f64 ``block_sketch_ref`` on the
    projected columns."""
    x = np.asarray(block, dtype=np.float32).reshape(np.shape(block)[0], -1)
    n, f = x.shape
    cols = list(plan.resolve_columns(f))
    fp = len(cols)
    glo = ghi = None
    if bins > 0:
        glo, ghi = _grid(lo, hi, fp)
    sel = x[plan.mask(x)] if plan.predicates else x
    kw = dict(bins=bins) if bins == 0 else dict(bins=bins, lo=glo, hi=ghi)

    def sketch(rows: np.ndarray) -> BlockSketch:
        if rows.shape[0] == 0:
            return empty_sketch(fp, bins, glo, ghi)
        return block_sketch_ref(rows[:, cols], **kw)

    if plan.group_by is None:
        sketches = [sketch(sel)]
    else:
        labels = sel[:, plan.group_by % f].astype(np.int64)
        sketches = [sketch(sel[labels == g]) for g in range(plan.num_classes)]
    return PlanResult(
        rows_total=int(n), rows_selected=int(sel.shape[0]), sketches=sketches
    )
