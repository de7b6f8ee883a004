#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA card.

    python3 chip_smoke.py [--seed S] [--records N] [--out DIR]

Phases, one line each with its seconds:

1. build     -- compile the three CUDA kernels (``src/repro_torch/csrc``) with
                nvcc for sm_90a, at first use, into ``build/``;
2. parity    -- each kernel against its plain PyTorch version on the card, at
                the main path's shapes: rsp_shuffle bit for bit, block_sketch
                and plan_sketch stats within 1e-5 relative and histograms
                equal (plan cases: predicate, projection, G=2, empty
                selection, labels out of range, ragged row count);
3. main path -- a class-sorted HIGGS-shaped corpus (N x 29 float32, label in
                the last column) partitioned into K blocks on the card by the
                ``cuda`` backend (checked bit for bit against the plain
                gather), summarized, saved, reopened, and queried three ways
                (unfiltered mean+p95: block_sketch; ``where=``/``columns=``
                mean: plan_sketch; per-class mean: plan_sketch with G=2),
                with every kernel's launch count read after the run;
4. agreement -- the same queries with ``sketch_impl="torch"``: the same
                blocks read, estimates and CI ends within 1e-5; every mean CI
                covers the full-scan answer computed on the card; then one
                run of each query under ``torch.profiler`` gives the device's
                busy and idle share, and one under ``cProfile`` the host
                functions that take the caller's time;
5. times     -- each kernel's time per call with CUDA events around a run
                of back-to-back calls (the wrapper as the query path calls
                it, so host work that outlasts the kernel shows) beside its
                plain version, its bound and (for the shuffle)
                ``index_select``; and ``device_ms``, the device's busy time
                per call from ``torch.profiler``.  plan_sketch is timed on
                query (c)'s grouped plan, which carries most of its main-path
                launches, and on query (b)'s plan on a line of its own; a
                plan's bound reads only the 32-byte sectors of the columns
                it touches.

Phase 3 also times one block's partition-time summary by stage (copy off
the card, float64 moments, each host sketch).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Any failed check exits non-zero.  The
script needs one CUDA card and the repository's ``src/`` beside it; without
either it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
BLOCKS = 100                  # K = P, the paper's HIGGS setting
QUERY_RUNS = 3                # query latency is the median of these
REPS = 20                     # timed launches per kernel
MOMENT_RTOL = 1e-5
COVERAGE_CONFIDENCE = 0.999999
BINS = 128


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def phase(name: str, t0: float, extra: str = "") -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s{(' ' + extra) if extra else ''}",
          flush=True)


def rel_err(a, b) -> float:
    """Largest |a - b| / max(|b|, 1) over finite entries; infinities must match."""
    import torch

    a = torch.as_tensor(a, dtype=torch.float64).cpu()
    b = torch.as_tensor(b, dtype=torch.float64).cpu()
    fin = torch.isfinite(b)
    check(bool(torch.equal(torch.isfinite(a), fin)), "finite entries differ")
    check(bool(torch.equal(a[~fin], b[~fin])), "infinite entries differ")
    if not bool(fin.any()):
        return 0.0
    d = (a[fin] - b[fin]).abs() / b[fin].abs().clamp(min=1.0)
    return float(d.max())


def max_abs(a, b) -> float:
    import torch

    a = torch.as_tensor(a, dtype=torch.float64).cpu()
    b = torch.as_tensor(b, dtype=torch.float64).cpu()
    fin = torch.isfinite(a) & torch.isfinite(b)
    return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0


def time_cuda(fn, *, reps: int, windows: int = 3) -> float:
    """Milliseconds per call of ``fn(i)``: CUDA events around ``reps``
    back-to-back calls (i = 0 .. reps-1), divided by ``reps``; the median
    over ``windows`` such windows, after one warm-up call."""
    import torch

    fn(0)
    torch.cuda.synchronize()
    per_call = []
    for _ in range(windows):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(reps):
            fn(i)
        stop.record()
        stop.synchronize()
        per_call.append(start.elapsed_time(stop) / reps)
    return statistics.median(per_call)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sector_bytes(n: int, f: int, cols) -> int:
    """Bytes of the 32-byte memory sectors that hold columns ``cols`` of an
    ``[n, f]`` float32 row-major block: what a pass that needs only those
    columns must read."""
    import numpy as np

    cols = np.unique(np.asarray(cols, np.int64))
    addr = (np.arange(n, dtype=np.int64)[:, None] * f + cols[None, :]) * 4
    return 32 * int(np.unique(addr // 32).size)


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version, at the main path's shapes
# ---------------------------------------------------------------------------

def make_block(n: int, seed: int, device):
    """A HIGGS-shaped [n, 29] float32 block: 28 features, label in {0, 1}."""
    import torch

    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((n, 29), generator=g, device=device) * 1.3 + 0.2
    x[:, 28] = (torch.rand(n, generator=g, device=device) < 0.53).float()
    return x


def grid_of(x, cols=None):
    import numpy as np

    lo = x.amin(0).double().cpu().numpy()
    hi = x.amax(0).double().cpu().numpy()
    pad = np.maximum(1e-9, 1e-9 * (hi - lo))
    lo, hi = lo - pad, hi + pad
    if cols is not None:
        lo, hi = lo[list(cols)], hi[list(cols)]
    return lo, hi


def compare_sketch(name, got, want, hist_got, hist_want, errs) -> None:
    import torch

    e = rel_err(got, want)
    check(e <= MOMENT_RTOL, f"{name}: stats differ from the plain version by {e:.3g}")
    check(bool(torch.equal(got[0::5], want[0::5])), f"{name}: counts differ")
    if hist_want is not None:
        check(bool(torch.equal(hist_got, hist_want)), f"{name}: histograms differ")
    errs.append(max_abs(got, want))


def parity(args, device) -> dict:
    import torch

    from repro_torch.kernels.block_sketch.kernel import block_sketch_cuda, block_sketch_plain
    from repro_torch.kernels.block_sketch.ops import grid_tensors
    from repro_torch.kernels.plan import PlanArrays, QueryPlan
    from repro_torch.kernels.plan.kernel import plan_sketch_cuda, plan_sketch_plain
    from repro_torch.kernels.rsp_shuffle import (
        partition_permutations, rsp_shuffle_cuda, rsp_shuffle_plain)

    P = K = BLOCKS
    R = args.records // P
    delta = R // K
    n = args.records // K
    errs = {"rsp_shuffle": [], "block_sketch": [], "plan_sketch": []}

    # rsp_shuffle: the whole corpus in one batched launch, as the cuda backend does
    x = torch.randn((P, R, 29), generator=torch.Generator(device=device).manual_seed(args.seed),
                    device=device)
    tp, ip = (torch.from_numpy(a).to(device) for a in partition_permutations(args.seed, P, K, delta))
    got = rsp_shuffle_cuda(x, tp, ip, tile_rows=delta)
    want = rsp_shuffle_plain(x, tp, ip, tile_rows=delta)
    torch.cuda.synchronize()
    check(bool(torch.equal(got, want)), "rsp_shuffle: kernel differs from the plain gather")
    errs["rsp_shuffle"].append(float((got - want).abs().max()))
    del x, got, want, tp, ip

    # block_sketch: one RSP block, with and without the histogram
    blk = make_block(n, args.seed + 1, device)
    glo, ghi = grid_of(blk)
    lo, invw = grid_tensors(glo, ghi, BINS, device)
    for bins in (BINS, 0):
        s1, h1 = block_sketch_cuda(blk, lo, invw, bins=bins)
        s2, h2 = block_sketch_plain(blk, lo, invw, bins=bins)
        compare_sketch(f"block_sketch bins={bins}", s1, s2, h1, h2, errs["block_sketch"])
    # inv_width = 0 sends everything to bin 0
    s1, h1 = block_sketch_cuda(blk, lo, torch.zeros_like(invw), bins=BINS)
    s2, h2 = block_sketch_plain(blk, lo, torch.zeros_like(invw), bins=BINS)
    compare_sketch("block_sketch inv_width=0", s1, s2, h1, h2, errs["block_sketch"])
    check(bool((h1[:, 0] == n).all()), "block_sketch: inv_width=0 must fill bin 0")

    # plan_sketch: the cases the query layer sends
    odd = blk.clone()
    odd[:, 28] = torch.tensor([-2.0, -0.5, 0.0, 1.0, 1.5, 2.0, 3.0], device=device)[
        torch.arange(n, device=device) % 7]
    cases = {
        "predicate": (blk, QueryPlan(predicates="c0 > 0.5")),
        "projection": (blk, QueryPlan(columns=(0, 3, 28))),
        "grouped G=2": (blk, QueryPlan(predicates="c1 < 1.0", group_by=28, num_classes=2)),
        "empty selection": (blk, QueryPlan(predicates="c0 > 1e9")),
        "labels out of range": (odd, QueryPlan(group_by=28, num_classes=2)),
        "ragged rows": (blk[: n - 37].contiguous(),
                        QueryPlan(predicates=["c2 >= 0.1", "c5 != 0.0"], columns=(1, 2))),
    }
    for name, (xb, plan) in cases.items():
        cols = plan.resolve_columns(29)
        glo, ghi = grid_of(xb, cols)
        for bins in (BINS, 0):
            lo, invw = grid_tensors(glo, ghi, BINS, device) if bins else (None, None)
            arrays = PlanArrays.build(plan, 29, device)
            s1, h1, n1 = plan_sketch_cuda(xb, arrays, lo, invw, bins=bins)
            s2, h2, n2 = plan_sketch_plain(xb, plan, lo, invw, bins=bins)
            check(n1 == n2, f"plan {name}: nsel {n1} != {n2}")
            compare_sketch(f"plan {name} bins={bins}", s1, s2, h1, h2, errs["plan_sketch"])
    return {k: max(v) for k, v in errs.items()}


# ---------------------------------------------------------------------------
# Phases 3-4: the main path
# ---------------------------------------------------------------------------

def make_corpus(records: int, seed: int):
    import numpy as np

    from repro_torch.data import make_nonrandom_higgs_like

    x, y = make_nonrandom_higgs_like(records, seed=seed)
    data = np.empty((records, 29), np.float32)
    data[:, :28] = x
    data[:, 28] = y
    return data


def queries():
    from repro_torch.rsp import Aggregate

    common = dict(target_rel_err=0.01, confidence=COVERAGE_CONFIDENCE, use_sketches=False)
    return {
        "a_mean_p95": (["mean", "p95"], dict(common)),
        "b_where_columns": ("mean", dict(common, where="c0 > 0.5", columns=(0, 28))),
        "c_by_label": (Aggregate("mean", by_label=True), dict(common)),
    }


def truths(data_dev) -> dict:
    import torch

    x = data_dev.double()
    sel = data_dev[:, 0] > torch.tensor(0.5, dtype=torch.float32, device=data_dev.device)
    lab = data_dev[:, 28].to(torch.int64)
    return {
        "a_mean_p95": x.mean(0).cpu().numpy(),
        "b_where_columns": x[sel][:, [0, 28]].mean(0).cpu().numpy(),
        "c_by_label": torch.stack([x[lab == c].mean(0) for c in (0, 1)]).cpu().numpy(),
    }


def covers(agg, truth) -> bool:
    import numpy as np

    lo = np.asarray(agg.ci_lo, np.float64)
    hi = np.asarray(agg.ci_hi, np.float64)
    # the float32 rounding of per-block sketches, folded in float64
    tol = 1e-5 * np.maximum(np.abs(truth), 1.0)
    return bool(np.all(lo - tol <= truth) and np.all(truth <= hi + tol))


def agree(r1, r2) -> float:
    """Largest relative deviation between two results' estimates and CI ends."""
    worst = 0.0
    for a, b in zip(r1.aggregates, r2.aggregates):
        for f in ("estimate", "ci_lo", "ci_hi"):
            worst = max(worst, rel_err(getattr(a, f), getattr(b, f)))
    return worst


def summary_probe(block) -> dict:
    """Seconds of one block's partition-time summary, split by stage (the
    device-to-host copy, the float64 moments, then each host sketch)."""
    import os

    import numpy as np

    from repro_torch.kernels.block_sketch.ref import block_sketch_ref
    from repro_torch.rsp.sketch import SketchSuite

    out = {}
    t0 = time.perf_counter()
    x = block.cpu().numpy()
    out["copy_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    x64 = x.astype(np.float64).reshape(x.shape[0], -1)
    block_sketch_ref(x64)
    out["moments_s"] = time.perf_counter() - t0
    suite = SketchSuite.create(0, label_column=28, num_classes=2)
    for kind, member in suite.sketches.items():
        if kind != "moments":
            t0 = time.perf_counter()
            member.update(x64)
            out[f"{kind}_s"] = time.perf_counter() - t0
    out["host"] = {"cpus": len(os.sched_getaffinity(0)), "numpy": np.__version__}
    return out


def profiled(fn) -> tuple[float, float | None, dict]:
    """Run ``fn()`` under ``torch.profiler``: (wall seconds, seconds in the
    union of the device's busy intervals -- kernels, fills and copies -- or
    None when the profiler saw no device event, device seconds by name)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    spans, by_name = [], {}
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA:
            continue
        spans.append((evt.time_range.start, evt.time_range.end))
        by_name[evt.name] = by_name.get(evt.name, 0.0) + evt.time_range.elapsed_us() / 1e6
    busy, end = 0.0, float("-inf")
    for s, e in sorted(spans):
        if e > end:
            busy += e - max(s, end)
            end = e
    return wall, (busy / 1e6 if spans else None), by_name


def device_share(ds, aggs, kw) -> dict:
    """One profiled run of a query: wall and device-busy seconds and the
    four largest device items."""
    wall, busy, by_name = profiled(lambda: ds.query(aggs, **kw))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return {"wall_s": wall, "busy_s": busy, "top": [(name[:60], sec) for name, sec in top]}


def host_profile(ds, aggs, kw, top: int = 10) -> dict:
    """One run of a query under ``cProfile``: wall seconds and the ``top``
    functions by own time and by cumulative time.  The per-block payloads
    and the fold run on the caller's thread; from Python 3.12 ``cProfile``
    also sees the fetch workers' threads, so where they overlap the caller
    the times of several threads add up.  Array indexing is not a call, so
    its time counts as the own time of the function that indexes."""
    import cProfile
    import pstats

    import torch

    prof = cProfile.Profile()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prof.enable()
    ds.query(aggs, **kw)
    torch.cuda.synchronize()
    prof.disable()
    wall = time.perf_counter() - t0
    rows = [
        (f"{Path(file).name}:{line}({fn})", tt, ct)
        for (file, line, fn), (_, _, tt, ct, _) in pstats.Stats(prof).stats.items()
    ]
    return {
        "wall_s": wall,
        "own_s": [(name, tt) for name, tt, _ in sorted(rows, key=lambda r: -r[1])[:top]],
        "cumulative_s": [(name, ct) for name, _, ct in sorted(rows, key=lambda r: -r[2])[:top]],
    }


def device_ms(fn, reps: int) -> float | None:
    """Device-busy milliseconds per call of ``fn(i)``, i = 0 .. reps-1 (the
    host's launch overhead between calls left out), or None when the
    profiler saw no device event."""
    def run():
        for i in range(reps):
            fn(i)

    _, busy, _ = profiled(run)
    return None if busy is None else busy / reps * 1e3


def main_path(args, device) -> dict:
    import numpy as np
    import torch

    from repro_torch import kernels, rsp
    from repro_torch.kernels.rsp_shuffle import partition_permutations, rsp_shuffle_plain

    K = BLOCKS
    t0 = time.perf_counter()
    data = make_corpus(args.records, args.seed)
    phase("corpus", t0, f"records={args.records} shape={list(data.shape)} class-sorted")

    kernels.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ds = rsp.partition(data, blocks=K, seed=args.seed, num_classes=2, summaries=False,
                       device="cuda")
    torch.cuda.synchronize()
    partition_s = time.perf_counter() - t0
    phase("partition", t0, f"backend={ds.backend} K={K} n={ds.block_size}")
    check(ds.backend == "cuda", f"auto chose backend {ds.backend!r}, expected 'cuda'")

    t0 = time.perf_counter()
    summaries = ds.summaries
    summaries_s = time.perf_counter() - t0
    div = ds.label_divergence()
    phase("summaries", t0, f"host numpy f64, {len(summaries)} blocks;"
          f" worst block label divergence {div:.3g} (sequential chunking: 0.5)")
    check(div < 0.05, f"label divergence {div} is not near 0")
    probe = summary_probe(ds.block(0))
    print(f"summaries of one block, by stage: {json.dumps(probe)}", flush=True)

    tmp = tempfile.mkdtemp(prefix="rsp_smoke_")
    try:
        t0 = time.perf_counter()
        ds.save(tmp)
        save_s = time.perf_counter() - t0
        phase("save", t0, f"{sum(p.stat().st_size for p in Path(tmp).iterdir()) / 1e9:.3f} GB")
        ds_open = rsp.open(tmp, device="cuda")
        check(len(ds_open.summaries) == K, "reopened store lost its sketches")

        results, lat = {}, {}
        for name, (aggs, kw) in queries().items():
            runs = []
            for _ in range(QUERY_RUNS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r = ds_open.query(aggs, **kw)
                runs.append(time.perf_counter() - t0)
            results[name] = r
            lat[name] = runs
            fetch_s = r.trace.steps[-1].cum_fetch_s if r.trace and r.trace.steps else 0.0
            phase(f"query {name}", t0, f"p50 {statistics.median(runs) * 1e3:.1f} ms,"
                  f" blocks_read={r.blocks_read}, converged={r.converged},"
                  f" store fetch {fetch_s * 1e3:.1f} ms of the last run")
        counts = kernels.launch_counts()   # the main path ends here
        print(f"launches on the main path: {json.dumps(counts)}", flush=True)
        for k, v in counts.items():
            check(v > 0, f"kernel {k} was not launched on the main path")

        # plain-version partition on the card, bit for bit
        t0 = time.perf_counter()
        P, R, delta = ds.spec.num_original_blocks, ds.spec.original_block_size, ds.spec.slice_size
        x_dev = torch.from_numpy(data).to(device)
        tp, ip = (torch.from_numpy(a).to(device)
                  for a in partition_permutations(args.seed, P, K, delta))
        plain = rsp_shuffle_plain(x_dev.reshape(P, R, 29), tp, ip, tile_rows=delta)
        plain = plain.reshape(P, K, delta, 29).transpose(0, 1).reshape(K, P * delta, 29)
        check(bool(torch.equal(plain, ds.stacked())),
              "cuda partition differs from the plain gather")
        del plain, tp, ip
        phase("partition check", t0, "equal to the plain gather bit for bit")

        t0 = time.perf_counter()
        truth = truths(x_dev)
        worst = 0.0
        for name, (aggs, kw) in queries().items():
            r_torch = ds_open.query(aggs, **dict(kw, sketch_impl="torch"))
            r = results[name]
            check(r_torch.blocks_read == r.blocks_read,
                  f"{name}: blocks_read {r.blocks_read} (cuda) vs {r_torch.blocks_read} (torch)")
            dev = agree(r, r_torch)
            check(dev <= MOMENT_RTOL, f"{name}: cuda and torch answers differ by {dev:.3g}")
            worst = max(worst, dev)
            mean = r.aggregates[0]
            est = np.asarray(mean.estimate, np.float64)
            check(est.shape == np.shape(truth[name]) and np.all(np.isfinite(est)),
                  f"{name}: estimate shape {est.shape} or non-finite values")
            check(covers(mean, truth[name]), f"{name}: mean CI misses the full-scan answer")
        phase("agreement", t0, f"cuda vs torch max deviation {worst:.3g};"
              f" every mean CI covers the full-scan answer at {COVERAGE_CONFIDENCE}")
        del x_dev

        t0 = time.perf_counter()
        shares = {name: device_share(ds_open, aggs, kw) for name, (aggs, kw) in queries().items()}
        for name, s in shares.items():
            idle = "not measured" if s["busy_s"] is None else f"{1 - s['busy_s'] / s['wall_s']:.4f}"
            print(f"device share {name}: wall {s['wall_s']:.3f} s, busy {s['busy_s']} s,"
                  f" idle share {idle}, top {json.dumps(s['top'])}", flush=True)
        phase("device share", t0, "one profiled run of each query")

        t0 = time.perf_counter()
        hosts = {name: host_profile(ds_open, aggs, kw) for name, (aggs, kw) in queries().items()}
        for name, h in hosts.items():
            print(f"host profile {name}: {json.dumps(h)}", flush=True)
        phase("host profile", t0, "one cProfile run of each query")
        ds_open.close()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ds.close()
    n = ds.block_size
    e2e = {
        "partition_s": partition_s,
        "summaries_s": summaries_s,
        "save_s": save_s,
        "summary_probe": probe,
        "device_share": shares,
        "host_profile": hosts,
        "queries": {
            k: {"p50_ms": statistics.median(v) * 1e3, "runs_ms": [t * 1e3 for t in v],
                "blocks_read": results[k].blocks_read,
                "rows_per_s": results[k].blocks_read * n / statistics.median(v)}
            for k, v in lat.items()
        },
    }
    return {"counts": counts, "e2e": e2e}


# ---------------------------------------------------------------------------
# Phase 5: times
# ---------------------------------------------------------------------------

def times(args, device) -> dict:
    import torch

    from repro_torch.kernels.block_sketch.kernel import block_sketch_cuda, block_sketch_plain
    from repro_torch.kernels.block_sketch.ops import grid_tensors
    from repro_torch.kernels.plan import PlanArrays, QueryPlan
    from repro_torch.kernels.plan.kernel import plan_sketch_cuda, plan_sketch_plain
    from repro_torch.kernels.rsp_shuffle import (
        flat_gather_index, partition_permutations, rsp_shuffle_cuda, rsp_shuffle_plain)

    P = K = BLOCKS
    R = args.records // P
    delta = R // K
    n = args.records // K
    F = 29
    out = {}
    x = torch.randn((P, R, F), device=device)
    tp, ip = (torch.from_numpy(a).to(device) for a in partition_permutations(args.seed, P, K, delta))
    flat = flat_gather_index(tp, ip, delta)
    xf = x.reshape(P * R, F)
    nbytes = 2 * x.numel() * 4 + tp.numel() * 4 + ip.numel() * 4
    b, by = bound_ms(nbytes, 0)
    out["rsp_shuffle"] = {
        "ms": time_cuda(lambda i: rsp_shuffle_cuda(x, tp, ip, tile_rows=delta), reps=5),
        "plain_ms": time_cuda(lambda i: rsp_shuffle_plain(x, tp, ip, tile_rows=delta), reps=5),
        "library_ms": time_cuda(lambda i: xf.index_select(0, flat), reps=5),
        "device_ms": device_ms(lambda i: rsp_shuffle_cuda(x, tp, ip, tile_rows=delta), 5),
        "bound_ms": b, "bound_by": by, "shape": f"[{P}, {R}, {F}] f32, tile {delta}, one launch",
    }
    del x, xf, flat, tp, ip

    blk = make_block(n, args.seed + 2, device)
    # the timed loops cycle through 8 blocks (102 MB, twice the L2), so a
    # block is not in L2 when a call reads it
    blks = [blk] + [make_block(n, args.seed + 3 + i, device) for i in range(7)]
    glo, ghi = grid_of(blk)
    lo, invw = grid_tensors(glo, ghi, BINS, device)
    nbytes = blk.numel() * 4 + 2 * F * 4 + 5 * F * 4 + F * BINS * 8
    b, by = bound_ms(nbytes, 10 * blk.numel())
    out["block_sketch"] = {
        "ms": time_cuda(lambda i: block_sketch_cuda(blks[i % 8], lo, invw, bins=BINS),
                        reps=REPS),
        "plain_ms": time_cuda(lambda i: block_sketch_plain(blks[i % 8], lo, invw, bins=BINS),
                              reps=REPS),
        "device_ms": device_ms(
            lambda i: block_sketch_cuda(blks[i % 8], lo, invw, bins=BINS), REPS),
        "library_ms": None, "bound_ms": b, "bound_by": by,
        "shape": f"[{n}, {F}] f32, bins {BINS}",
    }

    def plan_times(plan, shape):
        """Times and bound of one plan on the rotating blocks, bins 0 (the
        main path's queries ask for means only).  The bound reads the
        sectors of the columns the plan touches and writes its outputs."""
        arrays = PlanArrays.build(plan, F, device)
        fp, g = arrays.cols.numel(), arrays.groups
        touched = {p.column for p in plan.predicates} | set(arrays.cols.tolist())
        if arrays.gcol >= 0:
            touched.add(arrays.gcol)
        read = sector_bytes(n, F, sorted(touched))
        nbytes = read + arrays.pcol.numel() * 12 + fp * 4 + 5 * g * fp * 4 + 4
        b, by = bound_ms(nbytes, (len(plan.predicates) + 5 * fp) * n)
        return {
            "ms": time_cuda(lambda i: plan_sketch_cuda(blks[i % 8], arrays, None, None, bins=0),
                            reps=REPS),
            "plain_ms": time_cuda(
                lambda i: plan_sketch_plain(blks[i % 8], plan, None, None, bins=0), reps=REPS),
            "device_ms": device_ms(
                lambda i: plan_sketch_cuda(blks[i % 8], arrays, None, None, bins=0), REPS),
            "library_ms": None, "bound_ms": b, "bound_by": by, "bound_read_bytes": read,
            "shape": shape,
        }

    # query (c)'s plan carries 300 of the main path's 333 plan launches: the
    # per-class mean, G = 2 over all 29 columns
    out["plan_sketch"] = plan_times(QueryPlan(group_by=28, num_classes=2),
                                    f"[{n}, {F}] f32, group_by c28, G 2, all columns, bins 0")
    # query (b)'s plan: predicate c0 > 0.5, columns (0, 28); two columns'
    # sectors are about a third of the block
    where = plan_times(QueryPlan(predicates="c0 > 0.5", columns=(0, 28)),
                       f"[{n}, {F}] f32, where c0 > 0.5, columns (0, 28), bins 0")
    print(f"plan_sketch, query (b)'s plan: {json.dumps(where)}", flush=True)
    out["plan_sketch_where"] = where
    return out


def nvidia_smi() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--records", type=int, default=11_000_000)
    ap.add_argument("--out", default=None, help="directory for the build log and JSON")
    args = ap.parse_args()
    if args.records % (BLOCKS * BLOCKS):
        print(f"chip_smoke: --records must be a multiple of {BLOCKS * BLOCKS}", file=sys.stderr)
        return 2

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the port is not beside this script ({SRC / 'repro_torch'})",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))

    from repro_torch.kernels import _cuda

    device = torch.device("cuda", 0)
    print(nvidia_smi(), flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    t0 = time.perf_counter()
    _cuda.library()
    phase("build", t0, f"sources hash {_cuda.source_hash()}")
    for line in _cuda.build_log().splitlines():
        if "registers" in line or "error" in line.lower():
            print(f"  ptxas: {line.strip()}")

    t0 = time.perf_counter()
    errs = parity(args, device)
    phase("parity", t0, json.dumps(errs))

    path = main_path(args, device)

    t0 = time.perf_counter()
    tm = times(args, device)
    phase("times", t0)

    replaces = {
        "rsp_shuffle": "src/repro/kernels/rsp_shuffle/kernel.py:44",
        "block_sketch": "src/repro/kernels/block_sketch/kernel.py:82",
        "plan_sketch": "src/repro/kernels/plan/kernel.py:129",
    }
    record = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces[name],
            "launches": path["counts"][name],
            "max_abs_err": errs[name],
            "ms": tm[name]["ms"],
            "plain_ms": tm[name]["plain_ms"],
            "bound_ms": tm[name]["bound_ms"],
            "bound_by": tm[name]["bound_by"],
            "library_ms": tm[name]["library_ms"],
            "device_ms": tm[name]["device_ms"],
            "shape": tm[name]["shape"],
        }
        for name in ("rsp_shuffle", "block_sketch", "plan_sketch")
    ]}
    print(f"end_to_end: {json.dumps(path['e2e'])}", flush=True)
    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "build.log").write_text(_cuda.build_log())
        (out / "chip_smoke.json").write_text(json.dumps(
            {"kernels": record["kernels"], "plan_sketch_where": tm["plan_sketch_where"],
             "end_to_end": path["e2e"], "gpu": nvidia_smi()},
            indent=1))
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
