"""The fused block sketch on tensors: the CUDA kernel and its plain version.

``block_sketch_tensor(x, lo, inv_width, bins=...)`` sketches one ``[n, F]``
float32 block in one pass and returns ``(stats [5, F] float32,
hist [F, bins] int64 or None)``: rows of ``stats`` are (count, mean, M2,
min, max); the bin of a value is ``clip(floor((x - lo) * inv_width), 0,
bins - 1)`` in float32, so out-of-range mass lands in the edge bins and
``inv_width = 0`` sends everything to bin 0.  ``bins=0`` sketches moments
only.

* :func:`block_sketch_cuda` launches ``csrc/block_sketch.cu`` (the port of
  the Pallas ``block_sketch_pallas``) once and counts the launch in
  :data:`LAUNCHES`, whose ``last`` record names the load path it took
  (``"vec4"`` for a 16-byte aligned block, ``"scalar"`` otherwise: the
  same bits) and the launch's geometry.  It takes CUDA tensors only; its outputs are views of one
  packed buffer (:func:`block_sketch_packed`, ``kernels/_sketch.py``).
* :func:`block_sketch_plain` is the same function in plain PyTorch, on any
  device: the CPU tests run it, and ``chip_smoke.py`` holds the kernel
  against it on the card.

A launch's configuration (:class:`SketchConfig`: the thread budget, whether
the histogram may live in shared memory, the fewest rows a CTA) is the
default unless the caller passes one (the autotuner's candidates,
``ops.block_sketch_candidates``).  It changes the fold order, so the
low bits of mean and M2 (within 1e-5 of the plain version); histogram
counts stay exact.  For one configuration the geometry, and so the bits,
are a fixed function of n and the card.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import _cuda, _sketch

LAUNCHES = _cuda.LaunchCounter("block_sketch")
KERNELS = ("block_sketch_fused",)   # the device kernels one call launches

MAX_FEATURES = 1024
_THREADS = 512         # a CTA's threads: F * J, J the largest power of two that fits
_SMEM_LIMIT = 200 * 1024


@dataclasses.dataclass(frozen=True)
class SketchConfig:
    """A sketch launch's tunable configuration.  ``threads``: the budget a
    CTA's F * J threads fit in (J the largest power of two that fits);
    ``hist_in_smem``: the CTA's histogram in shared memory where it fits
    (False: in the global scratch); ``min_rows``: the fewest rows a CTA
    (a multiple of 4; fewer CTAs than the card holds once it binds)."""

    threads: int = _THREADS
    hist_in_smem: bool = True
    min_rows: int = _sketch.MIN_ROWS_PER_CTA

    def __post_init__(self):
        if self.threads < 1 or self.threads > 1024:
            raise ValueError(f"a thread budget in [1, 1024], got {self.threads}")
        if self.min_rows < _sketch.ROW_QUANTUM or self.min_rows % _sketch.ROW_QUANTUM:
            raise ValueError(f"min_rows must be a positive multiple of {_sketch.ROW_QUANTUM}")


DEFAULT_CONFIG = SketchConfig()


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


_LAUNCH: dict[tuple, tuple] = {}   # launch parameters by (device, stream, n, F, bins, config)


def _launch_params(dev: torch.device, stream: int, n: int, f: int, bins: int,
                   cfg: SketchConfig) -> tuple:
    """``(J, hist_in_smem, ctas, rows_per_cta, ld, scratch, records)`` of a
    launch, computed once a shape, stream and configuration;
    ``records[aligned]`` is the launch record :data:`LAUNCHES` keeps."""
    key = (dev.index, stream, n, f, bins, cfg)
    params = _LAUNCH.get(key)
    if params is None:
        lib = _cuda.library()
        lanes = _sketch.pow2_floor(cfg.threads // f)    # J: threads a feature
        threads = f * lanes
        in_smem = int(bins > 0 and cfg.hist_in_smem
                      and lib.block_sketch_smem_bytes(threads, f, bins, 1) <= _SMEM_LIMIT)
        ld = min(_sketch.MAX_CLUSTERS, _sketch.clusters(
            lib.block_sketch_max_clusters, threads, f, bins, in_smem))
        ctas, rows = _sketch.launch_geometry(n, _sketch.max_ctas(ld), cfg.min_rows)
        scratch = _sketch.scratch(dev, stream, f, bins, ld)
        geometry = {"ctas": ctas, "rows_per_cta": rows, "threads": threads, "clusters_held": ld,
                    "hist_in_smem": in_smem}
        records = {True: {"path": "vec4", **geometry}, False: {"path": "scalar", **geometry}}
        params = (lanes, in_smem, ctas, rows, ld, scratch, records)
        if len(_LAUNCH) >= _sketch.SCRATCH_ENTRIES:
            _LAUNCH.clear()
        _LAUNCH[key] = params
    return params


def block_sketch_packed(
    x: torch.Tensor, lo: torch.Tensor, inv_width: torch.Tensor, *, bins: int,
    config: SketchConfig | None = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on CUDA tensors (float32, contiguous) at
    ``config`` (:data:`DEFAULT_CONFIG` when None); returns its packed
    output (``_sketch.unpack(packed, 1, F, bins)``)."""
    _check_args(x, lo, inv_width, bins)
    if bins > 0:
        _cuda.require_same_device(x.device, lo=lo, inv_width=inv_width)
    _cuda.require_cuda(x, "x", torch.float32)
    n, f = x.shape
    if f < 1 or f > MAX_FEATURES:
        raise ValueError(f"the kernel takes 1 <= F <= {MAX_FEATURES} features, got {f}")
    if n >= 2**31:
        raise ValueError("the kernel takes fewer than 2**31 rows per block")
    if f * bins >= 2**31:
        raise ValueError("the kernel takes fewer than 2**31 histogram bins in all")
    if bins > 0:
        _cuda.require_cuda(lo, "lo", torch.float32)
        _cuda.require_cuda(inv_width, "inv_width", torch.float32)
    lib = _cuda.library()
    dev = x.device
    stream = _cuda.stream_handle(dev)
    lanes, in_smem, ctas, rows, ld, scratch, records = _launch_params(
        dev, stream, n, f, bins, DEFAULT_CONFIG if config is None else config)
    vec = x.data_ptr() % 16 == 0   # 16-byte loads, or scalar loads of the same values
    packed, stats, hist, nsel = _sketch.new_packed(f, bins, dev)
    code = lib.block_sketch_launch(
        x.data_ptr(), n, f, lanes, rows, ctas,
        lo.data_ptr() if bins > 0 else None,
        inv_width.data_ptr() if bins > 0 else None,
        bins, in_smem, int(vec), scratch.data_ptr(), ld, stats, hist, nsel, stream,
    )
    _cuda.check(code, "block_sketch kernel")
    LAUNCHES.add(records[vec])
    return packed


def block_sketch_cuda(
    x: torch.Tensor, lo: torch.Tensor, inv_width: torch.Tensor, *, bins: int,
    config: SketchConfig | None = None,
) -> tuple[torch.Tensor, torch.Tensor | None]:
    """Launch the CUDA kernel on CUDA tensors (float32, contiguous): one
    launch, ``(stats, hist)`` views of its packed output."""
    packed = block_sketch_packed(x, lo, inv_width, bins=bins, config=config)
    f = x.shape[1]
    stats = packed[: 20 * f].view(torch.float32).view(5, f)
    if bins == 0:
        return stats, None
    hist_off, nsel_off, _ = _sketch.packed_layout(f, bins)
    return stats, packed[hist_off:nsel_off].view(torch.int64).view(f, bins)
