"""The impl dispatcher for the fused block sketch.

Every impl returns the numpy :class:`~repro_torch.kernels.block_sketch.ref.
BlockSketch` the query layer folds (moments in float64, histogram counts
in int64):

* ``impl="ref"``   -- the copied numpy float64 oracle, on a host copy.
* ``impl="torch"`` -- the plain PyTorch version, on the block's device.
* ``impl="cuda"``  -- the hand-written CUDA kernel (CUDA tensors only; a
  CPU tensor raises).
* ``impl="auto"``  -- ``"cuda"`` for a CUDA tensor, ``"torch"`` otherwise;
  on the card the kernel launches at the autotuner's configuration for the
  block's shape bucket and ``bins`` (:func:`sketch_config`; the default
  with ``REPRO_AUTOTUNE=off``), where ``impl="cuda"`` keeps the default.

The outputs come back to the host in one device-to-host copy of the packed
buffer (``kernels/_sketch.py``).  The float32 grid tensors are cached on the
float64 grid's bytes, ``bins`` and device (:func:`grid_tensors`), so a query
that sends one grid for all of its blocks copies it to the card once.

The torch and cuda paths bin with the reference's float32 rule
``(x - lo) * inv_width``, ``inv_width`` made in float64 on the host and cast
to float32; the float64 ``ref`` path may put a value lying exactly on a bin
edge into the neighbouring bin (moments agree to 1e-5).
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.device import as_numpy
from repro_torch.kernels import _sketch, autotune
from repro_torch.kernels.autotune import Candidate
from repro_torch.kernels.block_sketch.kernel import (
    DEFAULT_CONFIG,
    SketchConfig,
    block_sketch_packed,
    block_sketch_plain,
)
from repro_torch.kernels.block_sketch.ref import BlockSketch, _grid, block_sketch_ref

IMPLS = ("auto", "ref", "torch", "cuda")
SKETCH_THREADS = (256, 512, 1024)    # thread budgets the tuner times
SKETCH_MIN_ROWS = (256, 1024, 4096)  # fewest rows a CTA the tuner times


def as_candidate(cfg: SketchConfig) -> Candidate:
    return Candidate.of("cuda", threads=cfg.threads, hist_in_smem=cfg.hist_in_smem,
                        min_rows=cfg.min_rows)


def as_config(c: Candidate) -> SketchConfig:
    return SketchConfig(threads=c.get("threads"), hist_in_smem=c.get("hist_in_smem"),
                        min_rows=c.get("min_rows"))


@functools.lru_cache(maxsize=2)
def _candidates(with_hist: bool) -> tuple[Candidate, ...]:
    places = (True, False) if with_hist else (False,)
    return tuple(as_candidate(SketchConfig(t, h, m))
                 for t in SKETCH_THREADS for h in places for m in SKETCH_MIN_ROWS)


def block_sketch_candidates(bins: int) -> tuple[Candidate, ...]:
    """The kernel configurations the tuner times: every thread budget,
    histogram place (shared memory only where there is a histogram) and
    fewest rows a CTA.  Kernel configurations only."""
    return _candidates(bins > 0)


_DEFAULT = as_candidate(DEFAULT_CONFIG)
# with no histogram its place means nothing: the default as the candidates name it
_DEFAULT_NO_HIST = as_candidate(dataclasses.replace(DEFAULT_CONFIG, hist_in_smem=False))


def sketch_key(n: int, f: int, bins: int) -> str:
    return autotune.shape_key(n, f) + f"|b{bins}"


def sketch_config(x: torch.Tensor, lo: torch.Tensor, inv_width: torch.Tensor, *,
                  bins: int) -> SketchConfig:
    """The tuned configuration of a launch over ``x [n, F]`` (the default
    with tuning off or on a CPU tensor)."""
    n, f = x.shape
    xs = autotune.Rotation(x)

    def measure(c: Candidate) -> float:
        cfg = as_config(c)
        return autotune.cuda_seconds(
            lambda i: block_sketch_packed(xs(i), lo, inv_width, bins=bins, config=cfg), x.device)

    return as_config(autotune.choose(
        "block_sketch", sketch_key(n, f, bins), block_sketch_candidates(bins), measure,
        default=_DEFAULT if bins > 0 else _DEFAULT_NO_HIST, device=x.device,
    ))


def _inv_width(lo: np.ndarray, hi: np.ndarray, bins: int) -> np.ndarray:
    width = (hi - lo) / max(bins, 1)
    return np.where(width > 0, 1.0 / np.where(width > 0, width, 1.0), 0.0)


def resolve_impl(impl: str, x: torch.Tensor) -> str:
    """``auto`` -> ``cuda`` on a CUDA tensor, ``torch`` otherwise."""
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r} (one of {IMPLS})")
    if impl == "auto":
        return "cuda" if x.is_cuda else "torch"
    return impl


def as_block_tensor(block) -> torch.Tensor:
    """A block (tensor or array, any ``[n, ...]`` shape) as a float32
    ``[n, F]`` tensor on its own device."""
    t = block if isinstance(block, torch.Tensor) else torch.from_numpy(np.asarray(block))
    t = t.reshape(t.shape[0], -1)
    if t.dtype != torch.float32:
        t = t.to(torch.float32)
    return t.contiguous()


GRID_CACHE_ENTRIES = 64   # grids kept, least recently used dropped first
_GRID_CACHE: OrderedDict[tuple, tuple] = OrderedDict()
_GRID_LOCK = threading.Lock()
_GRID_STATS = {"hits": 0, "misses": 0}


def grid_tensors(glo: np.ndarray, ghi: np.ndarray, bins: int, device) -> tuple:
    """Float32 ``lo`` / ``inv_width`` tensors of a float64 host grid, cached
    on the grid's bytes, ``bins`` and ``device``.  The tensors are shared:
    callers must not write to them."""
    glo = np.ascontiguousarray(glo, np.float64)
    ghi = np.ascontiguousarray(ghi, np.float64)
    key = (glo.tobytes(), ghi.tobytes(), int(bins), str(torch.device(device)))
    with _GRID_LOCK:
        hit = _GRID_CACHE.get(key)
        if hit is not None:
            _GRID_CACHE.move_to_end(key)
            _GRID_STATS["hits"] += 1
            return hit
    lo = torch.as_tensor(glo.astype(np.float32), device=device)
    invw = torch.as_tensor(_inv_width(glo, ghi, bins).astype(np.float32), device=device)
    with _GRID_LOCK:
        _GRID_STATS["misses"] += 1
        _GRID_CACHE[key] = (lo, invw)
        while len(_GRID_CACHE) > GRID_CACHE_ENTRIES:
            _GRID_CACHE.popitem(last=False)
    return lo, invw


def grid_cache_info() -> dict:
    """Grid-tensor cache counters: ``hits`` / ``misses`` / ``size``."""
    with _GRID_LOCK:
        return {**_GRID_STATS, "size": len(_GRID_CACHE)}


def grid_cache_clear() -> None:
    with _GRID_LOCK:
        _GRID_CACHE.clear()
        _GRID_STATS.update(hits=0, misses=0)


def block_sketch(
    block,
    *,
    bins: int = 0,
    lo=0.0,
    hi=1.0,
    impl: str = "auto",
) -> BlockSketch:
    """Fused sketch of one block (tensor or array; features flatten).

    ``bins=0`` skips the histogram (moments only; the kernel serves it
    too).  ``lo`` / ``hi`` are scalars or per-feature arrays."""
    if impl == "ref":
        return block_sketch_ref(as_numpy(block), bins=bins, lo=lo, hi=hi)
    x = as_block_tensor(block)
    tuned = impl == "auto"
    impl = resolve_impl(impl, x)
    f = x.shape[1]
    glo, ghi = _grid(lo, hi, f)
    lo_t, invw_t = grid_tensors(glo, ghi, bins, x.device)
    if impl == "cuda":
        cfg = sketch_config(x, lo_t, invw_t, bins=bins) if tuned else None
        packed = block_sketch_packed(x, lo_t, invw_t, bins=bins, config=cfg)
    else:
        stats, hist = block_sketch_plain(x, lo_t, invw_t, bins=bins)
        packed = _sketch.pack(stats, hist, torch.zeros(1, dtype=torch.int64, device=x.device))
    stats, hist, _ = _sketch.unpack(packed.cpu(), 1, f, bins)   # one copy back
    stats = stats.numpy().astype(np.float64)
    return BlockSketch(
        count=float(stats[0, 0]) if f else float(x.shape[0]),
        mean=stats[1],
        m2=stats[2],
        min=stats[3],
        max=stats[4],
        hist=None if bins == 0 else hist.numpy().astype(np.int64),
        lo=None if bins == 0 else glo,
        hi=None if bins == 0 else ghi,
    )
