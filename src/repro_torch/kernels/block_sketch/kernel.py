"""The fused block sketch on tensors: the CUDA kernel and its plain version.

``block_sketch_tensor(x, lo, inv_width, bins=...)`` sketches one ``[n, F]``
float32 block in one pass and returns ``(stats [5, F] float32,
hist [F, bins] int64 or None)``: rows of ``stats`` are (count, mean, M2,
min, max); the bin of a value is ``clip(floor((x - lo) * inv_width), 0,
bins - 1)`` in float32, so out-of-range mass lands in the edge bins and
``inv_width = 0`` sends everything to bin 0.  ``bins=0`` sketches moments
only.

* :func:`block_sketch_cuda` launches ``csrc/block_sketch.cu`` (the port of
  the Pallas ``block_sketch_pallas``) and counts the launch in
  :data:`LAUNCHES`.  It takes CUDA tensors only.
* :func:`block_sketch_plain` is the same function in plain PyTorch, on any
  device: the CPU tests run it, and ``chip_smoke.py`` holds the kernel
  against it on the card.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda

LAUNCHES = _cuda.LaunchCounter("block_sketch")

_THREADS = 256
_SMEM_LIMIT = 200 * 1024


def _check_args(x: torch.Tensor, lo: torch.Tensor, inv_width: torch.Tensor, bins: int) -> None:
    if x.ndim != 2:
        raise ValueError(f"block must be [n, F], got shape {tuple(x.shape)}")
    if bins < 0:
        raise ValueError("bins must be >= 0")
    f = x.shape[1]
    if bins > 0 and (lo.shape != (f,) or inv_width.shape != (f,)):
        raise ValueError(f"lo / inv_width must be [{f}]")


def _empty_stats(f: int, device) -> torch.Tensor:
    stats = torch.zeros((5, f), dtype=torch.float32, device=device)
    stats[3] = float("inf")
    stats[4] = float("-inf")
    return stats


def bin_index(x: torch.Tensor, lo: torch.Tensor, inv_width: torch.Tensor, bins: int) -> torch.Tensor:
    """Per-value bin of ``x`` on the grid (float32 arithmetic; NaN -> 0)."""
    t = torch.floor((x - lo) * inv_width)
    t = torch.where(t > 0, t, torch.zeros_like(t))
    return torch.clamp(t, max=float(bins - 1)).to(torch.int64)


def block_sketch_plain(
    x: torch.Tensor, lo: torch.Tensor, inv_width: torch.Tensor, *, bins: int
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Plain PyTorch version of the fused sketch (any device)."""
    _check_args(x, lo, inv_width, bins)
    x = x.to(torch.float32)
    n, f = x.shape
    if n == 0:
        stats = _empty_stats(f, x.device)
    else:
        mean = x.mean(dim=0)
        m2 = ((x - mean) ** 2).sum(dim=0)
        count = torch.full((f,), float(n), dtype=torch.float32, device=x.device)
        stats = torch.stack([count, mean, m2, x.amin(dim=0), x.amax(dim=0)])
    if bins == 0:
        return stats, None
    idx = bin_index(x, lo.to(torch.float32), inv_width.to(torch.float32), bins)
    flat = idx + torch.arange(f, device=x.device, dtype=torch.int64) * bins
    hist = torch.bincount(flat.reshape(-1), minlength=f * bins).reshape(f, bins)
    return stats, hist


def block_sketch_cuda(
    x: torch.Tensor, lo: torch.Tensor, inv_width: torch.Tensor, *, bins: int
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch the CUDA kernel on CUDA tensors (float32, contiguous)."""
    _check_args(x, lo, inv_width, bins)
    if bins > 0:
        _cuda.require_same_device(x.device, lo=lo, inv_width=inv_width)
    _cuda.require_cuda(x, "x", torch.float32)
    n, f = x.shape
    if f < 1 or f > _THREADS * 4:
        raise ValueError(f"the kernel takes 1 <= F <= {_THREADS * 4} features, got {f}")
    if n >= 2**31:
        raise ValueError("the kernel takes fewer than 2**31 rows per block")
    if bins > 0:
        _cuda.require_cuda(lo, "lo", torch.float32)
        _cuda.require_cuda(inv_width, "inv_width", torch.float32)
    lib = _cuda.library()
    lanes = max(1, _THREADS // f)                    # J: threads per feature
    threads = -(-(f * lanes) // 32) * 32
    in_smem = int(bins > 0 and lib.block_sketch_smem_bytes(threads, f, bins, 1) <= _SMEM_LIMIT)
    ctas = lib.block_sketch_num_ctas(n)
    dev = x.device
    pmom = torch.empty((ctas, 3, f), dtype=torch.float64, device=dev)
    pext = torch.empty((ctas, 2, f), dtype=torch.float32, device=dev)
    stats = torch.empty((5, f), dtype=torch.float32, device=dev)
    hist = torch.zeros((f, max(bins, 1)), dtype=torch.int32, device=dev)
    code = lib.block_sketch_launch(
        x.data_ptr(), n, f, lanes, threads,
        lo.data_ptr() if bins > 0 else None,
        inv_width.data_ptr() if bins > 0 else None,
        bins, in_smem, pmom.data_ptr(), pext.data_ptr(), stats.data_ptr(),
        hist.data_ptr(), _cuda.stream_handle(dev),
    )
    _cuda.check(code, "block_sketch kernel")
    LAUNCHES.add()
    return stats, (hist.to(torch.int64) if bins > 0 else None)

