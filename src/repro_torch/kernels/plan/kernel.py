"""Plan-compiled fused query pass on tensors: the CUDA kernel and its plain
version.

One pass over a ``[n, F]`` float32 block does, for a
:class:`~repro_torch.kernels.plan.plan.QueryPlan`:

1. the conjunctive predicate mask (``lt/le/gt/ge/eq/ne`` against float32
   constants);
2. the column projection (a gather of the plan's columns);
3. the group-by: the ``group_by`` column is truncated toward zero, as the
   reference's numpy and jit paths do, and rows whose label falls outside
   ``[0, G)`` join no group;
4. per group, (count, mean, M2, min, max) and a fixed-grid histogram of the
   projected features.

Both versions return ``(stats [G*5, Fp] float32, hist [G*Fp, bins] int64 or
None, nsel)``, where ``nsel`` counts every row that passes the predicates,
whatever its label.

* :func:`plan_sketch_cuda` launches ``csrc/plan_sketch.cu`` (the port of
  the Pallas ``plan_sketch_pallas``) and counts the launch in
  :data:`LAUNCHES`.  CUDA tensors only; the plan arrives as
  :class:`PlanArrays`, prepared once per plan key (see ``ops.py``).
* :func:`plan_sketch_plain` is the same function in plain PyTorch.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _cuda
from repro_torch.kernels.block_sketch.kernel import bin_index
from repro_torch.kernels.plan.plan import OPS, QueryPlan

LAUNCHES = _cuda.LaunchCounter("plan_sketch")

MAX_PREDICATES = 16

_THREADS = 256
_TILE_BYTES = 32 * 1024
_SMEM_LIMIT = 200 * 1024

_TORCH_OPS = {
    "lt": torch.lt,
    "le": torch.le,
    "gt": torch.gt,
    "ge": torch.ge,
    "eq": torch.eq,
    "ne": torch.ne,
}


@dataclasses.dataclass(frozen=True)
class PlanArrays:
    """A plan as the small device arrays the kernel reads: predicate
    columns / ops / values, projected columns, group column and count."""

    num_features: int
    pcol: torch.Tensor    # [P] int32
    pop: torch.Tensor     # [P] int32 (index into plan.OPS)
    pval: torch.Tensor    # [P] float32
    cols: torch.Tensor    # [Fp] int32
    gcol: int             # -1 when ungrouped
    groups: int

    @classmethod
    def build(cls, plan: QueryPlan, num_features: int, device) -> "PlanArrays":
        f = int(num_features)
        preds = plan.predicates
        if len(preds) > MAX_PREDICATES:
            raise ValueError(
                f"the plan kernel takes at most {MAX_PREDICATES} predicates, got {len(preds)}"
            )
        for p in preds:
            if p.column >= f:
                raise ValueError(f"predicate column {p.column} out of range for F={f}")
        cols = plan.resolve_columns(f)

        def ints(v):
            return torch.tensor(list(v), dtype=torch.int32, device=device)

        return cls(
            num_features=f,
            pcol=ints(p.column for p in preds),
            pop=ints(OPS.index(p.op) for p in preds),
            pval=torch.tensor([p.value for p in preds], dtype=torch.float32, device=device),
            cols=ints(cols),
            gcol=-1 if plan.group_by is None else plan.group_by % f,
            groups=plan.groups,
        )


def _check_args(x: torch.Tensor, plan: QueryPlan, lo, inv_width, bins: int) -> int:
    if x.ndim != 2:
        raise ValueError(f"block must be [n, F], got shape {tuple(x.shape)}")
    if bins < 0:
        raise ValueError("bins must be >= 0")
    fp = len(plan.resolve_columns(x.shape[1]))
    if bins > 0 and (lo.shape != (fp,) or inv_width.shape != (fp,)):
        raise ValueError(f"lo / inv_width must be [{fp}] (the projected features)")
    return fp


def plan_sketch_plain(
    x: torch.Tensor, plan: QueryPlan, lo, inv_width, *, bins: int
) -> tuple[torch.Tensor, torch.Tensor | None, int]:
    """Plain PyTorch version of the fused plan pass (any device)."""
    fp = _check_args(x, plan, lo, inv_width, bins)
    x = x.to(torch.float32)
    n, f = x.shape
    mask = torch.ones(n, dtype=torch.bool, device=x.device)
    for p in plan.predicates:
        value = torch.tensor(p.value, dtype=torch.float32, device=x.device)
        mask &= _TORCH_OPS[p.op](x[:, p.column], value)
    nsel = int(mask.sum())
    cols = torch.tensor(plan.resolve_columns(f), dtype=torch.int64, device=x.device)
    xp = x.index_select(1, cols)
    g_count = plan.groups
    if plan.group_by is None:
        group = torch.zeros(n, dtype=torch.int64, device=x.device)
    else:
        lab = x[:, plan.group_by % f]
        inside = (lab > -1.0) & (lab < float(g_count))
        group = torch.where(inside, lab, torch.full_like(lab, -1.0)).to(torch.int64)
    stats = torch.zeros((g_count * 5, fp), dtype=torch.float32, device=x.device)
    hist = None
    if bins > 0:
        hist = torch.zeros((g_count * fp, bins), dtype=torch.int64, device=x.device)
        lo = lo.to(torch.float32)
        inv_width = inv_width.to(torch.float32)
    offs = torch.arange(fp, device=x.device, dtype=torch.int64) * bins
    for g in range(g_count):
        rows = xp[mask & (group == g)]
        c = rows.shape[0]
        s = stats[5 * g : 5 * g + 5]
        if c == 0:
            s[3] = float("inf")
            s[4] = float("-inf")
            continue
        mean = rows.mean(dim=0)
        s[0] = float(c)
        s[1] = mean
        s[2] = ((rows - mean) ** 2).sum(dim=0)
        s[3] = rows.amin(dim=0)
        s[4] = rows.amax(dim=0)
        if bins > 0:
            flat = bin_index(rows, lo, inv_width, bins) + offs
            hist[g * fp : (g + 1) * fp] = torch.bincount(
                flat.reshape(-1), minlength=fp * bins
            ).reshape(fp, bins)
    return stats, hist, nsel


def plan_sketch_cuda(
    x: torch.Tensor, arrays: PlanArrays, lo, inv_width, *, bins: int
) -> tuple[torch.Tensor, torch.Tensor | None, int]:
    """Launch the CUDA kernel on a CUDA tensor with prepared plan arrays
    (on the block's device)."""
    plan_tensors = {"pcol": arrays.pcol, "pop": arrays.pop, "pval": arrays.pval,
                    "cols": arrays.cols}
    grid = {"lo": lo, "inv_width": inv_width} if bins > 0 else {}
    _cuda.require_same_device(x.device, **plan_tensors, **grid)
    _cuda.require_cuda(x, "x", torch.float32)
    for name, t in plan_tensors.items():
        _cuda.require_cuda(t, name, torch.float32 if name == "pval" else torch.int32)
    if x.ndim != 2:
        raise ValueError(f"block must be [n, F], got shape {tuple(x.shape)}")
    n, f = x.shape
    if f != arrays.num_features:
        raise ValueError(f"plan arrays were built for F={arrays.num_features}, block has F={f}")
    if n >= 2**31:
        raise ValueError("the kernel takes fewer than 2**31 rows per block")
    fp = arrays.cols.shape[0]
    g_count = arrays.groups
    if fp < 1 or fp > _THREADS * 4:
        raise ValueError(f"the kernel takes 1 <= Fp <= {_THREADS * 4} projected features")
    tile_rows = min(256, _TILE_BYTES // (4 * f))
    if tile_rows < 1:
        raise ValueError(f"the kernel takes F <= {_TILE_BYTES // 4} features, got {f}")
    if bins > 0:
        if lo.shape != (fp,) or inv_width.shape != (fp,):
            raise ValueError(f"lo / inv_width must be [{fp}] (the projected features)")
        _cuda.require_cuda(lo, "lo", torch.float32)
        _cuda.require_cuda(inv_width, "inv_width", torch.float32)
    lib = _cuda.library()
    lanes = max(1, _THREADS // fp)
    threads = -(-(fp * lanes) // 32) * 32
    base = lib.plan_sketch_smem_bytes(threads, f, tile_rows, fp, g_count, bins, 0)
    if base > _SMEM_LIMIT:
        raise ValueError(
            f"plan too large for the kernel's shared memory ({base} bytes for"
            f" G={g_count}, F={f}, Fp={fp})"
        )
    in_smem = int(
        bins > 0
        and lib.plan_sketch_smem_bytes(threads, f, tile_rows, fp, g_count, bins, 1)
        <= _SMEM_LIMIT
    )
    ctas = lib.plan_sketch_num_ctas(n, tile_rows)
    dev = x.device
    pmom = torch.empty((ctas, g_count, 3, fp), dtype=torch.float64, device=dev)
    pext = torch.empty((ctas, g_count, 2, fp), dtype=torch.float32, device=dev)
    stats = torch.empty((g_count * 5, fp), dtype=torch.float32, device=dev)
    hist = torch.zeros((g_count * fp, max(bins, 1)), dtype=torch.int32, device=dev)
    nsel = torch.zeros(1, dtype=torch.int32, device=dev)
    npred = arrays.pcol.shape[0]
    code = lib.plan_sketch_launch(
        x.data_ptr(), n, f, tile_rows, threads, lanes, npred,
        arrays.pcol.data_ptr() if npred else None,
        arrays.pop.data_ptr() if npred else None,
        arrays.pval.data_ptr() if npred else None,
        arrays.cols.data_ptr(), fp, arrays.gcol, g_count,
        lo.data_ptr() if bins > 0 else None,
        inv_width.data_ptr() if bins > 0 else None,
        bins, in_smem, pmom.data_ptr(), pext.data_ptr(), stats.data_ptr(),
        hist.data_ptr(), nsel.data_ptr(), _cuda.stream_handle(dev),
    )
    _cuda.check(code, "plan_sketch kernel")
    LAUNCHES.add()
    return stats, (hist.to(torch.int64) if bins > 0 else None), int(nsel.item())
