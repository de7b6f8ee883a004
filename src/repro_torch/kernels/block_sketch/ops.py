"""The impl dispatcher for the fused block sketch.

Every impl returns the numpy :class:`~repro_torch.kernels.block_sketch.ref.
BlockSketch` the query layer folds (moments in float64, histogram counts
in int64):

* ``impl="ref"``   -- the copied numpy float64 oracle, on a host copy.
* ``impl="torch"`` -- the plain PyTorch version, on the block's device.
* ``impl="cuda"``  -- the hand-written CUDA kernel (CUDA tensors only; a
  CPU tensor raises).
* ``impl="auto"``  -- ``"cuda"`` for a CUDA tensor, ``"torch"`` otherwise.

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

import threading
from collections import OrderedDict

import numpy as np
import torch

from repro_torch.device import as_numpy
from repro_torch.kernels import _sketch
from repro_torch.kernels.block_sketch.kernel import (
    block_sketch_packed,
    block_sketch_plain,
)
from repro_torch.kernels.block_sketch.ref import BlockSketch, _grid, block_sketch_ref

IMPLS = ("auto", "ref", "torch", "cuda")


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
    impl = resolve_impl(impl, x)
    f = x.shape[1]
    glo, ghi = _grid(lo, hi, f)
    lo_t, invw_t = grid_tensors(glo, ghi, bins, x.device)
    if impl == "cuda":
        packed = block_sketch_packed(x, lo_t, invw_t, bins=bins)
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
