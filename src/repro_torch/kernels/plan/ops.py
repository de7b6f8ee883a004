"""Plan-compiled fused query passes: compile cache + impl dispatcher.

``plan_sketch(block, plan, ...)`` runs one :class:`~repro_torch.kernels.plan.
plan.QueryPlan` (predicates + projection + optional group-by) over one block
in a single pass and returns a :class:`~repro_torch.kernels.plan.ref.
PlanResult`:

* ``impl="ref"``   -- the copied mask-then-sketch numpy oracle, on a host
  copy of the block.
* ``impl="torch"`` -- the plain PyTorch version, on the block's device.
* ``impl="cuda"``  -- the hand-written CUDA kernel (CUDA tensors only).
* ``impl="auto"``  -- ``"cuda"`` for a CUDA tensor, ``"torch"`` otherwise;
  on the card the kernel launches at the autotuner's configuration
  (:func:`plan_config`: the read path, thread budget, staged tile and
  histogram place, once a shape bucket and the plan's groups, predicates,
  columns and bins), where ``impl="cuda"`` keeps the default.

Executors are **compiled per plan**: :func:`compile_plan` memoizes on
``(plan.key(), features, bins, impl, tuned, device)``.  The CUDA kernel is
one build for every plan, so what the cache keeps for it are the plan's
prepared device arrays (predicates, columns, group column) for each read
path it launches -- re-running a plan hits the cache, changing any
predicate misses.  A tuned executor resolves its configuration at each
launch (a cache hit of the tuner after the first), so a cached executor
never keeps a stale one.  The outputs come back to the host in one
device-to-host copy of the packed buffer (``kernels/_sketch.py``).
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import DEFAULT_DEVICE, as_numpy, resolve_device
from repro_torch.kernels import _sketch, autotune
from repro_torch.kernels.autotune import Candidate
from repro_torch.kernels.block_sketch.ops import IMPLS, as_block_tensor, grid_tensors, resolve_impl
from repro_torch.kernels.block_sketch.ref import BlockSketch, _grid
from repro_torch.kernels.plan.kernel import (
    _THREADS,
    DEFAULT_CONFIG,
    PATHS,
    PlanArrays,
    PlanConfig,
    plan_sketch_packed,
    plan_sketch_plain,
    read_path,
    touched_columns,
)

PLAN_THREADS = (128, 256, 512, 1024)   # thread budgets the tuner times
PLAN_TILE_BYTES = (4096, 8192, 16384)  # staged tile bytes the tuner times
from repro_torch.kernels.plan.plan import QueryPlan
from repro_torch.kernels.plan.ref import PlanResult, plan_sketch_ref

_CACHE: dict[tuple, Callable] = {}
_CACHE_LOCK = threading.Lock()
_HITS = 0
_MISSES = 0


def cache_info() -> dict:
    """Compile-cache counters: ``hits`` / ``misses`` / ``size``."""
    with _CACHE_LOCK:
        return {"hits": _HITS, "misses": _MISSES, "size": len(_CACHE)}


def cache_clear() -> None:
    global _HITS, _MISSES
    with _CACHE_LOCK:
        _CACHE.clear()
        _HITS = _MISSES = 0


def _result(plan, fp, bins, glo, ghi, *, n, packed) -> PlanResult:
    """A packed output on the host -> a PlanResult of numpy per-group
    sketches."""
    g_count = plan.groups
    stats, hist, nsel = _sketch.unpack(packed, g_count, fp, bins)
    st = stats.numpy().astype(np.float64).reshape(g_count, 5, fp)
    h = None if bins == 0 else hist.numpy().astype(np.int64).reshape(g_count, fp, bins)
    sketches = [
        BlockSketch(
            count=float(st[g, 0, 0]),
            mean=st[g, 1],
            m2=np.maximum(st[g, 2], 0.0),
            min=st[g, 3],
            max=st[g, 4],
            hist=None if h is None else h[g],
            lo=glo,
            hi=ghi,
        )
        for g in range(g_count)
    ]
    return PlanResult(rows_total=int(n), rows_selected=int(nsel[0]), sketches=sketches)


def _build_ref(plan, bins):
    def run(x, glo, ghi):
        lo = 0.0 if glo is None else glo
        hi = 1.0 if ghi is None else ghi
        return plan_sketch_ref(as_numpy(x), plan, bins=bins, lo=lo, hi=hi)

    return run


@functools.lru_cache(maxsize=2)
def _candidates(with_hist: bool) -> tuple[Candidate, ...]:
    places = (True, False) if with_hist else (False,)
    return tuple(Candidate.of("cuda", path=p, threads=t, tile_bytes=b, hist_in_smem=h)
                 for p in PATHS for t in PLAN_THREADS for b in PLAN_TILE_BYTES for h in places)


def plan_candidates(bins: int) -> tuple[Candidate, ...]:
    """The kernel configurations the tuner times: every read path, thread
    budget, staged tile and histogram place (shared memory only where there
    is a histogram).  Kernel configurations only."""
    return _candidates(bins > 0)


def default_candidate(plan: QueryPlan, f: int, bins: int) -> Candidate:
    """The configuration of an untuned launch of ``plan`` over F columns
    at ``bins`` (with no histogram its place means nothing, and the
    candidates name it ``False``)."""
    path = read_path(f, touched_columns(plan, f))
    return Candidate.of("cuda", path=path, threads=_THREADS[path],
                        tile_bytes=DEFAULT_CONFIG.tile_bytes,
                        hist_in_smem=DEFAULT_CONFIG.hist_in_smem and bins > 0)


def as_config(c: Candidate) -> PlanConfig:
    return PlanConfig(threads=c.get("threads"), tile_bytes=c.get("tile_bytes"),
                      hist_in_smem=c.get("hist_in_smem"))


def plan_key(plan: QueryPlan, n: int, f: int, bins: int) -> str:
    """The tuner's key: the shape bucket, the plan's groups, predicates and
    projected columns, and the bins (the reference's key)."""
    return (autotune.shape_key(n, f)
            + f"|g{plan.groups}p{len(plan.predicates)}c{len(plan.resolve_columns(f))}b{bins}")


class _PathArrays:
    """A plan's device arrays by read path, built at first use."""

    def __init__(self, plan, f, device):
        self._plan, self._f, self._device = plan, f, device
        self._by_path: dict[str, PlanArrays] = {}
        self._lock = threading.Lock()

    def __call__(self, path: str) -> PlanArrays:
        with self._lock:
            arrays = self._by_path.get(path)
            if arrays is None:
                arrays = PlanArrays.build(self._plan, self._f, self._device, path=path)
                self._by_path[path] = arrays
            return arrays


def plan_config(plan: QueryPlan, x: torch.Tensor, lo, invw, *, bins: int,
                arrays=None, default: Candidate | None = None) -> Candidate:
    """The tuned configuration (read path and :class:`PlanConfig`
    parameters) of ``plan`` over ``x [n, F]``: ``default`` (that of
    :func:`default_candidate`) with tuning off or on a CPU tensor.
    ``arrays(path)`` gives the plan's device arrays."""
    n, f = x.shape
    arrays = _PathArrays(plan, f, x.device) if arrays is None else arrays
    default = default_candidate(plan, f, bins) if default is None else default
    xs = autotune.Rotation(x)

    def measure(c: Candidate) -> float:
        a, cfg = arrays(c.get("path")), as_config(c)
        return autotune.cuda_seconds(
            lambda i: plan_sketch_packed(xs(i), a, lo, invw, bins=bins, config=cfg), x.device)

    return autotune.choose("plan_sketch", plan_key(plan, n, f, bins), plan_candidates(bins),
                           measure, default=default, device=x.device)


def _build_tensor(plan, f, bins, impl, tuned, device):
    arrays = _PathArrays(plan, f, device) if impl == "cuda" else None
    default = default_candidate(plan, f, bins)
    fp = len(plan.resolve_columns(f))

    def run(x, glo, ghi):
        lo = invw = None
        if bins > 0:
            lo, invw = grid_tensors(glo, ghi, bins, x.device)
        if impl == "cuda":
            if tuned:
                c = plan_config(plan, x, lo, invw, bins=bins, arrays=arrays, default=default)
                a, cfg = arrays(c.get("path")), as_config(c)
            else:
                a, cfg = arrays(default.get("path")), None
            packed = plan_sketch_packed(x, a, lo, invw, bins=bins, config=cfg)
        else:
            packed = _sketch.pack(*plan_sketch_plain(x, plan, lo, invw, bins=bins))
        return _result(plan, fp, bins, glo, ghi, n=x.shape[0], packed=packed.cpu())

    return run


def compile_plan(
    plan: QueryPlan,
    *,
    num_features: int,
    bins: int = 0,
    impl: str = "torch",
    device: str | torch.device = DEFAULT_DEVICE,
    tuned: bool = False,
) -> Callable:
    """The compiled executor ``run(x, glo, ghi) -> PlanResult`` for ``plan``
    at this shape and device (the card unless asked for the CPU), memoized
    on ``(plan.key(), features, bins, impl, tuned, device)`` -- the
    plan-keyed compile cache.  The executor takes blocks on ``device``
    only; with ``tuned`` a ``cuda`` executor launches at
    :func:`plan_config`'s configuration, else at the default."""
    global _HITS, _MISSES
    if impl not in IMPLS or impl == "auto":
        raise ValueError(f"compile_plan impl must be concrete, got {impl!r}")
    device = resolve_device(device)
    tuned = bool(tuned) and impl == "cuda"
    key = (plan.key(), int(num_features), int(bins), impl, tuned, str(device))
    telemetry = obs.enabled()
    with _CACHE_LOCK:
        fn = _CACHE.get(key)
        if fn is not None:
            _HITS += 1
            if telemetry:
                obs.get_registry().counter(
                    "rsp_plan_compile_total", "plan-cache lookups", outcome="hit"
                ).inc()
            return fn
    t0 = time.perf_counter()
    if impl == "ref":
        fn = _build_ref(plan, bins)
    else:
        fn = _build_tensor(plan, int(num_features), bins, impl, tuned, device)
    if telemetry:
        reg = obs.get_registry()
        reg.counter("rsp_plan_compile_total", "plan-cache lookups", outcome="miss").inc()
        reg.histogram(
            "rsp_plan_compile_seconds", "executor build time on a cache miss", impl=impl,
        ).observe(time.perf_counter() - t0)
    with _CACHE_LOCK:
        fn = _CACHE.setdefault(key, fn)
        _MISSES += 1
    return fn


def plan_sketch(
    block,
    plan: QueryPlan,
    *,
    bins: int = 0,
    lo=0.0,
    hi=1.0,
    impl: str = "auto",
) -> PlanResult:
    """Execute ``plan`` over one block (tensor or array, any ``[n, ...]``
    shape; features flatten) in a single fused pass.  ``bins=0`` skips
    histograms; ``lo`` / ``hi`` are scalars or arrays over the *projected*
    features."""
    x = as_block_tensor(block)
    n, f = x.shape
    fp = len(plan.resolve_columns(f))
    glo = ghi = None
    if bins > 0:
        glo, ghi = _grid(lo, hi, fp)
    tuned = impl == "auto"
    if impl != "ref":
        impl = resolve_impl(impl, x)  # validates the name
    fn = compile_plan(plan, num_features=f, bins=bins, impl=impl, device=x.device, tuned=tuned)
    return fn(x, glo, ghi)
