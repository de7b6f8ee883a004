"""Plan-compiled fused query passes: compile cache + impl dispatcher.

``plan_sketch(block, plan, ...)`` runs one :class:`~repro_torch.kernels.plan.
plan.QueryPlan` (predicates + projection + optional group-by) over one block
in a single pass and returns a :class:`~repro_torch.kernels.plan.ref.
PlanResult`:

* ``impl="ref"``   -- the copied mask-then-sketch numpy oracle, on a host
  copy of the block.
* ``impl="torch"`` -- the plain PyTorch version, on the block's device.
* ``impl="cuda"``  -- the hand-written CUDA kernel (CUDA tensors only).
* ``impl="auto"``  -- ``"cuda"`` for a CUDA tensor, ``"torch"`` otherwise.

Executors are **compiled per plan**: :func:`compile_plan` memoizes on
``(plan.key(), features, bins, impl, device)``.  The CUDA kernel is one
build for every plan, so what the cache keeps for it are the plan's
prepared device arrays (predicates, columns, group column) -- re-running a
plan hits the cache, changing any predicate misses.
"""

from __future__ import annotations

import threading
import time
from typing import Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import DEFAULT_DEVICE, as_numpy, resolve_device
from repro_torch.kernels.block_sketch.ops import IMPLS, as_block_tensor, grid_tensors, resolve_impl
from repro_torch.kernels.block_sketch.ref import BlockSketch, _grid
from repro_torch.kernels.plan.kernel import PlanArrays, plan_sketch_cuda, plan_sketch_plain
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


def _result(plan, bins, glo, ghi, *, nsel, n, stats, hist) -> PlanResult:
    """Assemble ``stats [G*5, Fp]`` / ``hist [G*Fp, bins]`` tensors into a
    PlanResult of numpy per-group sketches."""
    g_count = plan.groups
    st = stats.cpu().numpy().astype(np.float64).reshape(g_count, 5, -1)
    fp = st.shape[2]
    h = None if bins == 0 else hist.cpu().numpy().astype(np.int64).reshape(g_count, fp, bins)
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
    return PlanResult(rows_total=int(n), rows_selected=int(nsel), sketches=sketches)


def _build_ref(plan, bins):
    def run(x, glo, ghi):
        lo = 0.0 if glo is None else glo
        hi = 1.0 if ghi is None else ghi
        return plan_sketch_ref(as_numpy(x), plan, bins=bins, lo=lo, hi=hi)

    return run


def _build_tensor(plan, f, bins, impl, device):
    arrays = PlanArrays.build(plan, f, device) if impl == "cuda" else None

    def run(x, glo, ghi):
        lo = invw = None
        if bins > 0:
            lo, invw = grid_tensors(glo, ghi, bins, x.device)
        if impl == "cuda":
            stats, hist, nsel = plan_sketch_cuda(x, arrays, lo, invw, bins=bins)
        else:
            stats, hist, nsel = plan_sketch_plain(x, plan, lo, invw, bins=bins)
        return _result(plan, bins, glo, ghi, nsel=nsel, n=x.shape[0], stats=stats, hist=hist)

    return run


def compile_plan(
    plan: QueryPlan,
    *,
    num_features: int,
    bins: int = 0,
    impl: str = "torch",
    device: str | torch.device = DEFAULT_DEVICE,
) -> Callable:
    """The compiled executor ``run(x, glo, ghi) -> PlanResult`` for ``plan``
    at this shape and device (the card unless asked for the CPU), memoized
    on ``(plan.key(), features, bins, impl, device)`` -- the plan-keyed
    compile cache.  The executor takes blocks on ``device`` only."""
    global _HITS, _MISSES
    if impl not in IMPLS or impl == "auto":
        raise ValueError(f"compile_plan impl must be concrete, got {impl!r}")
    device = resolve_device(device)
    key = (plan.key(), int(num_features), int(bins), impl, str(device))
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
        fn = _build_tensor(plan, int(num_features), bins, impl, device)
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
    if impl != "ref":
        impl = resolve_impl(impl, x)  # validates the name
    fn = compile_plan(plan, num_features=f, bins=bins, impl=impl, device=x.device)
    return fn(x, glo, ghi)
