"""What the block_sketch and plan_sketch kernels share on the host: the
launch geometry, the per-stream scratch and the packed output.

* **Geometry.**  A launch has ``ctas`` CTAs in clusters of ``CLUSTER``; CTA
  ``c`` takes the rows ``[c * rows_per_cta, min(n, (c + 1) *
  rows_per_cta))``.  ``rows_per_cta`` is a multiple of 4, so every range
  of a 16-byte aligned block starts 16 bytes aligned, and the grid is sized
  to the clusters the card holds at once (``max_ctas``, from the CUDA
  occupancy calculator), never fewer than ``MIN_ROWS_PER_CTA`` rows a CTA;
  the last CTAs of the last cluster may have no rows.  Both are fixed
  functions of ``n``, the card and the launch's configuration (its threads,
  its histogram's place, its fewest rows a CTA: the autotuner's choice,
  fixed for a key once made), so the kernels' fixed fold order is too.
* **Scratch.**  The clusters' partials, the int32 histogram accumulator and
  the fold's ticket (``csrc/sketch_common.cuh``) live in one buffer a
  (device, CUDA stream, shape class), zeroed once when it is made; every
  launch leaves it clean for the next one on its stream.  Two streams never
  share one.
* **Packed output.**  A launch writes one uint8 buffer: ``stats [G*5, Fp]``
  float32, then (8-byte aligned) ``hist [G*Fp, bins]`` int64, then ``nsel``
  int64.  :func:`unpack` gives views of it; the query layer copies it to the
  host in one transfer.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import torch

from repro_torch.kernels import _cuda

ROW_QUANTUM = 4          # a CTA's rows start at a multiple of this
MIN_ROWS_PER_CTA = 256
CLUSTER = 8              # kCluster of csrc/sketch_common.cuh
MAX_CLUSTERS = 32        # kMaxEntries: the clusters the last fold takes
SCRATCH_ENTRIES = 64     # scratch buffers kept, least recently used dropped first


def max_ctas(clusters: int) -> int:
    """The most CTAs a launch may have when the card holds ``clusters``
    clusters of the kernel at once."""
    return CLUSTER * max(1, min(MAX_CLUSTERS, clusters))


def launch_geometry(n: int, most: int, min_rows: int = MIN_ROWS_PER_CTA) -> tuple[int, int]:
    """``(ctas, rows_per_cta)`` of a launch over ``n`` rows with at most
    ``most`` CTAs (a multiple of ``CLUSTER``) of at least ``min_rows`` rows
    (a multiple of ``ROW_QUANTUM``)."""
    quads = -(-n // ROW_QUANTUM)
    per = max(min_rows // ROW_QUANTUM, -(-quads // most))
    rows = ROW_QUANTUM * per
    ctas = max(1, -(-n // rows))
    return -(-ctas // CLUSTER) * CLUSTER, rows


def row_ranges(n: int, ctas: int, rows_per_cta: int) -> list[tuple[int, int]]:
    """The row range ``[start, stop)`` of each CTA, as the kernels compute it
    (empty past ``n``)."""
    return [(min(n, c * rows_per_cta), min(n, (c + 1) * rows_per_cta)) for c in range(ctas)]


def pow2_floor(v: int) -> int:
    """The largest power of two <= max(v, 1)."""
    return 1 << (max(1, v).bit_length() - 1)


def clusters(fn, *args) -> int:
    """A launch's cluster capacity from the library's ``*_max_clusters``
    function, raising when the card cannot hold one cluster of it."""
    got = fn(*args)
    if got < 1:
        raise RuntimeError(f"the card holds no cluster of {CLUSTER} CTAs of this launch"
                           f" ({args}; code {got})")
    return got


_SCRATCH: OrderedDict[tuple, torch.Tensor] = OrderedDict()
_SCRATCH_LOCK = threading.Lock()


def scratch(device: torch.device, stream: int, cols: int, bins: int, ld: int) -> torch.Tensor:
    """The zero-initialised scratch of launches over ``cols`` columns and
    ``bins`` bins with up to ``ld`` clusters on ``stream`` of ``device``.  A
    dropped buffer is freed in stream order, so a launch still reading it
    finishes first."""
    key = (device.index, stream, cols, bins, ld)
    with _SCRATCH_LOCK:
        buf = _SCRATCH.get(key)
        if buf is not None:
            _SCRATCH.move_to_end(key)
            return buf
    nbytes = _cuda.library().sketch_scratch_bytes(cols, ld, bins)
    buf = torch.zeros(nbytes, dtype=torch.uint8, device=device)
    with _SCRATCH_LOCK:
        buf = _SCRATCH.setdefault(key, buf)
        while len(_SCRATCH) > SCRATCH_ENTRIES:
            _SCRATCH.popitem(last=False)
    return buf


def packed_layout(cols: int, bins: int) -> tuple[int, int, int]:
    """Byte offsets of ``hist`` and ``nsel`` in a packed output over
    ``cols`` columns, and its size."""
    hist_off = -(-20 * cols // 8) * 8
    nsel_off = hist_off + 8 * cols * bins
    return hist_off, nsel_off, nsel_off + 8


def new_packed(cols: int, bins: int, device: torch.device) -> tuple[torch.Tensor, int, int, int]:
    """An uninitialised packed output and the addresses of its three parts."""
    hist_off, nsel_off, total = packed_layout(cols, bins)
    packed = torch.empty(total, dtype=torch.uint8, device=device)
    base = packed.data_ptr()
    return packed, base, base + hist_off, base + nsel_off


def unpack(packed: torch.Tensor, groups: int, fp: int, bins: int):
    """``(stats [groups*5, fp] float32, hist [groups*fp, bins] int64 or
    None, nsel [1] int64)``: views of a packed output."""
    cols = groups * fp
    hist_off, nsel_off, total = packed_layout(cols, bins)
    stats = packed[: 20 * cols].view(torch.float32).view(groups * 5, fp)
    hist = packed[hist_off:nsel_off].view(torch.int64).view(cols, bins) if bins > 0 else None
    return stats, hist, packed[nsel_off:total].view(torch.int64)


def pack(stats: torch.Tensor, hist: torch.Tensor | None, nsel: torch.Tensor) -> torch.Tensor:
    """The packed output of separately computed parts (the plain versions'),
    on their device."""
    cols = stats.numel() // 5
    hist_off, _, _ = packed_layout(cols, 0)
    parts = [stats.to(torch.float32).reshape(-1).view(torch.uint8)]
    pad = hist_off - 20 * cols
    if pad:
        parts.append(torch.zeros(pad, dtype=torch.uint8, device=stats.device))
    if hist is not None:
        parts.append(hist.to(torch.int64).reshape(-1).view(torch.uint8))
    parts.append(nsel.to(torch.int64).reshape(1).view(torch.uint8))
    return torch.cat(parts)
