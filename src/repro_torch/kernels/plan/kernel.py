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
None, nsel [1] int64)`` on the block's device, without synchronising;
``nsel`` counts every row that passes the predicates, whatever its label.

* :func:`plan_sketch_cuda` launches ``csrc/plan_sketch.cu`` (the port of
  the Pallas ``plan_sketch_pallas``) once and counts the launch in
  :data:`LAUNCHES`, whose ``last`` record names the read path.  CUDA
  tensors only; the plan arrives as :class:`PlanArrays`, prepared once per
  plan key (see ``ops.py``); the outputs are views of one packed buffer
  (:func:`plan_sketch_packed`, ``kernels/_sketch.py``).
* :func:`plan_sketch_plain` is the same function in plain PyTorch.

The kernel reads a block one of two ways, chosen by :func:`read_path` from
the share of the block's 32-byte sectors that the plan's columns touch:
``"gather"`` stages only the touched columns (a narrow plan, such as a
``where=`` / ``columns=`` query over two columns), ``"stage"`` whole rows.
A caller may name the path (``PlanArrays.build(..., path=)``) and the
launch's other parameters (:class:`PlanConfig`: the thread budget, the
staged tile's bytes, the histogram's place), as the autotuner's candidates
do; the defaults are those above.  A configuration changes the fold order
(mean and M2 within 1e-5 of the plain version); counts stay exact.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _cuda, _sketch
from repro_torch.kernels.block_sketch.kernel import bin_index
from repro_torch.kernels.plan.plan import OPS, QueryPlan

LAUNCHES = _cuda.LaunchCounter("plan_sketch")
KERNELS = ("plan_sketch_fused",)   # the device kernels one call launches

MAX_PREDICATES = 16
GATHER_SHARE = 0.5     # gather the touched columns below this share of sectors
SECTOR_BYTES = 32

# a CTA's threads: Fp * J, J the largest power of two that fits (measured on
# the H100 at the main path's plans: 464 beat 232 for query (c)'s staged
# plan, 128 beat 256 and 512 for query (b)'s gathered one)
_THREADS = {"stage": 512, "gather": 128}
_MAX_PROJECTED = 1024
_TILE_ROWS = 128          # rows a tile of the kernel's four-tile ring
_TILE_BYTES = 8 * 1024    # ... unless the tile's rows are wider than this
_MAX_ROW_BYTES = 32 * 1024
_SMEM_LIMIT = 200 * 1024

PATHS = ("stage", "gather")


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """A plan launch's tunable parameters (its read path is its
    :class:`PlanArrays`'): ``threads``, the budget a CTA's Fp * J threads
    fit in (None: the path's default, ``_THREADS``); ``tile_bytes``, the
    bytes a staged tile's rows may span (at most ``_TILE_ROWS`` rows);
    ``hist_in_smem``, the histogram in shared memory where it fits."""

    threads: int | None = None
    tile_bytes: int = _TILE_BYTES
    hist_in_smem: bool = True

    def __post_init__(self):
        if self.threads is not None and not 1 <= self.threads <= 1024:
            raise ValueError(f"a thread budget in [1, 1024], got {self.threads}")
        if self.tile_bytes < 4:
            raise ValueError("tile_bytes must be >= 4")


DEFAULT_CONFIG = PlanConfig()

_TORCH_OPS = {
    "lt": torch.lt,
    "le": torch.le,
    "gt": torch.gt,
    "ge": torch.ge,
    "eq": torch.eq,
    "ne": torch.ne,
}


def read_share(num_features: int, touched) -> float:
    """The share of a row-major ``[n, num_features]`` float32 block's
    32-byte sectors that hold the ``touched`` columns (exact for n a
    multiple of 8: eight rows span ``num_features`` whole sectors)."""
    f = int(num_features)
    cols = sorted(set(int(c) for c in touched))
    sectors = {(r * f + c) * 4 // SECTOR_BYTES for r in range(8) for c in cols}
    return len(sectors) / f


def read_path(num_features: int, touched) -> str:
    """``"gather"`` (read only the touched columns) when they hold under
    ``GATHER_SHARE`` of the block's sectors, else ``"stage"`` (whole rows)."""
    return "gather" if read_share(num_features, touched) < GATHER_SHARE else "stage"


def touched_columns(plan: QueryPlan, num_features: int) -> tuple[int, ...]:
    """The block columns a plan reads: predicate, projected and label
    columns, sorted."""
    f = int(num_features)
    cols = {p.column for p in plan.predicates} | set(plan.resolve_columns(f))
    if plan.group_by is not None:
        cols.add(plan.group_by % f)
    return tuple(sorted(cols))


@dataclasses.dataclass(frozen=True)
class PlanArrays:
    """A plan as the small device arrays the kernel reads.  The kernel's
    shared-memory tile holds whole rows (``path == "stage"``) or only the
    ``touched`` columns (``"gather"``), and the column indices below are
    the tile's."""

    num_features: int
    path: str               # read_path(num_features, touched)
    touched: tuple          # block columns the plan reads, sorted
    pcol: torch.Tensor      # [P] int32 tile columns of the predicates
    pop: torch.Tensor       # [P] int32 (index into plan.OPS)
    pval: torch.Tensor      # [P] float32
    cols: torch.Tensor      # [Fp] int32 tile columns of the projected features
    bcols: torch.Tensor     # [Fp] int32 their block columns
    src: torch.Tensor       # [len(touched)] int32: block column of each gathered tile column
    gcol: int               # tile column of the label, -1 when ungrouped
    groups: int
    launches: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @classmethod
    def build(cls, plan: QueryPlan, num_features: int, device,
              path: str | None = None) -> "PlanArrays":
        """The plan's device arrays for a read ``path`` (default:
        :func:`read_path`'s pick)."""
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
        touched = touched_columns(plan, f)
        if path is None:
            path = read_path(f, touched)
        elif path not in PATHS:
            raise ValueError(f"unknown read path {path!r} (one of {PATHS})")
        tile = {c: i for i, c in enumerate(touched)} if path == "gather" else None

        def ints(v):
            v = [int(c) for c in v]
            return torch.tensor([tile[c] for c in v] if tile else v, dtype=torch.int32,
                                device=device)

        def block_ints(v):
            return torch.tensor([int(c) for c in v], dtype=torch.int32, device=device)

        gcol = -1 if plan.group_by is None else plan.group_by % f
        return cls(
            num_features=f,
            path=path,
            touched=touched,
            pcol=ints(p.column for p in preds),
            pop=block_ints(OPS.index(p.op) for p in preds),
            pval=torch.tensor([p.value for p in preds], dtype=torch.float32, device=device),
            cols=ints(cols),
            bcols=block_ints(cols),
            src=block_ints(touched),
            gcol=gcol if gcol < 0 or tile is None else tile[gcol],
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
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor]:
    """Plain PyTorch version of the fused plan pass (any device)."""
    fp = _check_args(x, plan, lo, inv_width, bins)
    x = x.to(torch.float32)
    n, f = x.shape
    mask = torch.ones(n, dtype=torch.bool, device=x.device)
    for p in plan.predicates:
        value = torch.tensor(p.value, dtype=torch.float32, device=x.device)
        mask &= _TORCH_OPS[p.op](x[:, p.column], value)
    nsel = mask.sum().reshape(1)
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


def _plan_tensors(arrays: PlanArrays) -> dict:
    return {"pcol": arrays.pcol, "pop": arrays.pop, "pval": arrays.pval, "cols": arrays.cols,
            "bcols": arrays.bcols, "src": arrays.src}


def _launch_params(arrays: PlanArrays, dev: torch.device, stream: int, n: int, f: int,
                   bins: int, cfg: PlanConfig) -> tuple:
    """``(tile_rows, width, J, hist_in_smem, ctas, rows_per_cta, ld,
    scratch, records)`` of a launch, computed once a plan, shape, stream and
    configuration (and kept on the plan's arrays, whose tensors' types are
    checked then); ``records`` holds the launch records :data:`LAUNCHES`
    keeps."""
    key = (dev.index, stream, n, bins, cfg)
    params = arrays.launches.get(key)
    if params is not None:
        return params
    for name, t in _plan_tensors(arrays).items():
        _cuda.require_cuda(t, name, torch.float32 if name == "pval" else torch.int32)
    fp = arrays.cols.shape[0]
    g_count = arrays.groups
    if fp < 1 or fp > _MAX_PROJECTED:
        raise ValueError(f"the kernel takes 1 <= Fp <= {_MAX_PROJECTED} projected features")
    width = len(arrays.touched) if arrays.path == "gather" else f   # the tile's columns
    if 4 * width > _MAX_ROW_BYTES:
        raise ValueError(f"the kernel takes F <= {_MAX_ROW_BYTES // 4} features, got {f}")
    tile_rows = max(1, min(_TILE_ROWS, cfg.tile_bytes // (4 * width)))
    if tile_rows >= 4:
        tile_rows -= tile_rows % 4
    if g_count * fp * bins >= 2**31:
        raise ValueError("the kernel takes fewer than 2**31 histogram bins in all")
    lib = _cuda.library()
    budget = _THREADS[arrays.path] if cfg.threads is None else cfg.threads
    lanes = _sketch.pow2_floor(budget // fp)   # J: threads a projected feature
    threads = fp * lanes
    base = lib.plan_sketch_smem_bytes(threads, tile_rows, width, fp, g_count, bins, 0)
    if base > _SMEM_LIMIT:
        raise ValueError(
            f"plan too large for the kernel's shared memory ({base} bytes for"
            f" G={g_count}, F={f}, Fp={fp})"
        )
    in_smem = int(
        bins > 0 and cfg.hist_in_smem
        and lib.plan_sketch_smem_bytes(threads, tile_rows, width, fp, g_count, bins, 1)
        <= _SMEM_LIMIT
    )
    ld = min(_sketch.MAX_CLUSTERS, _sketch.clusters(
        lib.plan_sketch_max_clusters, threads, tile_rows, width, fp, g_count, bins, in_smem))
    ctas, rows = _sketch.launch_geometry(n, _sketch.max_ctas(ld))
    scratch = _sketch.scratch(dev, stream, g_count * fp, bins, ld)
    geometry = {"ctas": ctas, "rows_per_cta": rows, "threads": threads, "tile_rows": tile_rows,
                "clusters_held": ld, "hist_in_smem": in_smem}
    records = {"gather": {"path": "gather", **geometry},
               True: {"path": "stage vec4", **geometry}, False: {"path": "stage scalar", **geometry}}
    params = (tile_rows, width, lanes, in_smem, ctas, rows, ld, scratch, records)
    if len(arrays.launches) >= _sketch.SCRATCH_ENTRIES:
        arrays.launches.clear()
    arrays.launches[key] = params
    return params


def plan_sketch_packed(
    x: torch.Tensor, arrays: PlanArrays, lo, inv_width, *, bins: int,
    config: PlanConfig | None = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on a CUDA tensor with prepared plan arrays
    (on the block's device) at ``config`` (:data:`DEFAULT_CONFIG` when
    None); returns its packed output (``_sketch.unpack(packed,
    arrays.groups, Fp, bins)``)."""
    grid = {"lo": lo, "inv_width": inv_width} if bins > 0 else {}
    _cuda.require_same_device(x.device, **_plan_tensors(arrays), **grid)
    _cuda.require_cuda(x, "x", torch.float32)
    if x.ndim != 2:
        raise ValueError(f"block must be [n, F], got shape {tuple(x.shape)}")
    n, f = x.shape
    if f != arrays.num_features:
        raise ValueError(f"plan arrays were built for F={arrays.num_features}, block has F={f}")
    if n >= 2**31:
        raise ValueError("the kernel takes fewer than 2**31 rows per block")
    fp = arrays.cols.shape[0]
    if bins > 0:
        if lo.shape != (fp,) or inv_width.shape != (fp,):
            raise ValueError(f"lo / inv_width must be [{fp}] (the projected features)")
        _cuda.require_cuda(lo, "lo", torch.float32)
        _cuda.require_cuda(inv_width, "inv_width", torch.float32)
    dev = x.device
    stream = _cuda.stream_handle(dev)
    tile_rows, width, lanes, in_smem, ctas, rows, ld, scratch, records = _launch_params(
        arrays, dev, stream, n, f, bins, DEFAULT_CONFIG if config is None else config)
    gather = arrays.path == "gather"
    vec = not gather and tile_rows % 4 == 0 and x.data_ptr() % 16 == 0
    packed, stats, hist, nsel = _sketch.new_packed(arrays.groups * fp, bins, dev)
    npred = arrays.pcol.shape[0]
    code = _cuda.library().plan_sketch_launch(
        x.data_ptr(), n, f, rows, ctas, tile_rows, width, int(gather), int(vec), npred,
        arrays.pcol.data_ptr() if npred else None,
        arrays.pop.data_ptr() if npred else None,
        arrays.pval.data_ptr() if npred else None,
        fp, lanes, arrays.cols.data_ptr(), arrays.bcols.data_ptr(), arrays.src.data_ptr(),
        arrays.gcol, arrays.groups,
        lo.data_ptr() if bins > 0 else None,
        inv_width.data_ptr() if bins > 0 else None,
        bins, in_smem, scratch.data_ptr(), ld, stats, hist, nsel, stream,
    )
    _cuda.check(code, "plan_sketch kernel")
    LAUNCHES.add(records["gather" if gather else vec])
    return packed


def plan_sketch_cuda(
    x: torch.Tensor, arrays: PlanArrays, lo, inv_width, *, bins: int,
    config: PlanConfig | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None, torch.Tensor]:
    """Launch the CUDA kernel on a CUDA tensor with prepared plan arrays
    (on the block's device): one launch, ``(stats, hist, nsel)`` views of
    its packed output."""
    packed = plan_sketch_packed(x, arrays, lo, inv_width, bins=bins, config=config)
    return _sketch.unpack(packed, arrays.groups, arrays.cols.shape[0], bins)
