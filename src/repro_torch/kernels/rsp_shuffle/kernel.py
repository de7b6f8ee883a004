"""The hierarchical row shuffle on tensors: the CUDA kernel and its plain
version.

For every batch ``b`` (one original block), output tile ``i`` and row ``r``::

    out[b, i*T + r] = x[b, tile_perm[b, i]*T + intra_perm[b, i, r]]

``x`` is ``[R, D]`` or batched ``[B, R, D]`` (any dtype; rows are copied
bit for bit; the kernel takes rows of an even number of bytes), ``tile_perm`` ``[R/T]`` / ``[B, R/T]`` and ``intra_perm``
``[R/T, T]`` / ``[B, R/T, T]`` int32 permutations.

* :func:`rsp_shuffle_cuda` launches ``csrc/rsp_shuffle.cu`` (the port of
  the Pallas ``rsp_shuffle_pallas``; all batches in one launch) and counts
  the launch in :data:`LAUNCHES`.  CUDA tensors only.  :func:`shuffle_path`
  picks its kernel: ``staged`` (the source tile staged in shared memory by
  bulk copies, the output written 16 bytes a store) where a tile's bytes
  are a multiple of 16, the base pointers 16-byte aligned and the tile fits
  in shared memory; ``rows`` (one warp per output row) elsewhere.  A
  launch may name its path and the threads a CTA (``path=``,
  ``threads=``, the autotuner's configurations); both leave the output
  bit for bit as it is.
* :func:`rsp_shuffle_plain` is the same gather in plain PyTorch, on any
  device.

Handed fake tensors, the launcher records the gather's bytes
(:func:`shuffle_bytes`) and launches nothing (``_cuda``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda

LAUNCHES = _cuda.LaunchCounter("rsp_shuffle")

# shared memory a block may opt into on the H100 (227 KB)
SMEM_OPTIN_H100 = 232_448
PATHS = ("staged", "rows")
THREADS = {"staged": (512, 1024), "rows": (256, 512, 1024)}   # a CTA's
DEFAULT_THREADS = {"staged": 1024, "rows": 256}


def staged_smem_bytes(tile_rows: int, row_bytes: int) -> int:
    """Shared memory of the staged kernel: the tile, its intra-tile
    permutation padded to 16 bytes, and one 8-byte barrier."""
    return tile_rows * row_bytes + -(-tile_rows * 4 // 16) * 16 + 8


def shuffle_path(tile_rows: int, row_bytes: int, *, x_ptr: int = 0, out_ptr: int = 0,
                 smem_limit: int = SMEM_OPTIN_H100) -> str:
    """Which kernel a launch takes: ``"staged"`` when the tile's bytes are a
    multiple of 16 (so every tile of every batch starts 16-byte aligned),
    both base addresses are 16-byte aligned and the tile fits in
    ``smem_limit`` bytes of shared memory; ``"rows"`` otherwise."""
    if ((tile_rows * row_bytes) % 16 or x_ptr % 16 or out_ptr % 16
            or staged_smem_bytes(tile_rows, row_bytes) > smem_limit):
        return "rows"
    return "staged"


def shuffle_bytes(x, tile_perm, intra_perm) -> int:
    """The bytes one shuffle moves: ``x`` read and the output written once,
    the int32 permutations read once."""
    return 2 * x.numel() * x.element_size() + 4 * (tile_perm.numel() + intra_perm.numel())


def _batched(x, tile_perm, intra_perm, tile_rows: int):
    """Validate shapes; return [B, R, D] / [B, nt] / [B, nt, T] views and
    whether the input carried a batch dimension."""
    batched = x.ndim == 3
    if x.ndim == 2:
        x, tile_perm, intra_perm = x[None], tile_perm[None], intra_perm[None]
    if x.ndim != 3:
        raise ValueError(f"x must be [R, D] or [B, R, D], got shape {tuple(x.shape)}")
    b, r, _ = x.shape
    if tile_rows <= 0 or r % tile_rows:
        raise ValueError(f"rows {r} must be divisible by tile_rows {tile_rows}")
    nt = r // tile_rows
    if tuple(tile_perm.shape) != (b, nt):
        raise ValueError(f"tile_perm must be [{b}, {nt}], got {tuple(tile_perm.shape)}")
    if tuple(intra_perm.shape) != (b, nt, tile_rows):
        raise ValueError(
            f"intra_perm must be [{b}, {nt}, {tile_rows}], got {tuple(intra_perm.shape)}"
        )
    return x, tile_perm, intra_perm, batched


def flat_gather_index(tile_perm: torch.Tensor, intra_perm: torch.Tensor, tile_rows: int) -> torch.Tensor:
    """Flat row index into ``x.reshape(B*R, D)`` for batched permutations
    ``[B, nt]`` / ``[B, nt, T]``."""
    b, nt = tile_perm.shape
    idx = tile_perm.to(torch.int64)[..., None] * tile_rows + intra_perm.to(torch.int64)
    offs = torch.arange(b, device=idx.device, dtype=torch.int64) * (nt * tile_rows)
    return (idx.reshape(b, -1) + offs[:, None]).reshape(-1)


def rsp_shuffle_plain(x, tile_perm, intra_perm, *, tile_rows: int) -> torch.Tensor:
    """Plain PyTorch version: the flat row gather (any device)."""
    xb, tp, ip, batched = _batched(x, tile_perm, intra_perm, tile_rows)
    b, r, d = xb.shape
    idx = flat_gather_index(tp, ip, tile_rows)
    out = xb.reshape(b * r, d).index_select(0, idx).reshape(b, r, d)
    return out if batched else out[0]


def rsp_shuffle_cuda(x, tile_perm, intra_perm, *, tile_rows: int, path: str | None = None,
                     threads: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel (all batches in one launch).  ``path`` and
    ``threads`` default to :func:`shuffle_path`'s pick and that path's
    :data:`DEFAULT_THREADS`; a ``"staged"`` path the launch cannot take
    raises."""
    xb, tp, ip, batched = _batched(x, tile_perm, intra_perm, tile_rows)
    b, r, d = xb.shape
    if (d * xb.element_size()) % 2:
        raise ValueError("the kernel copies 2- or 4-byte words: a row must be an even"
                         f" number of bytes, got {d * xb.element_size()}")
    _cuda.require_same_device(xb.device, tile_perm=tp, intra_perm=ip)
    _cuda.require_cuda(xb, "x")
    _cuda.require_cuda(tp, "tile_perm", torch.int32)
    _cuda.require_cuda(ip, "intra_perm", torch.int32)
    if b > 65535:
        raise ValueError("the kernel takes at most 65535 batches per launch")
    out = torch.empty_like(xb)
    if _cuda.is_fake(xb):
        _cuda.record_shape_only("rsp_shuffle", 0, shuffle_bytes(xb, tp, ip), "f32")
        return out if batched else out[0]
    row_bytes = d * xb.element_size()
    lib = _cuda.library()
    fits = shuffle_path(tile_rows, row_bytes, x_ptr=xb.data_ptr(), out_ptr=out.data_ptr(),
                        smem_limit=lib.repro_smem_optin())
    path = fits if path is None else path
    if path not in PATHS:
        raise ValueError(f"unknown shuffle path {path!r} (one of {PATHS})")
    if path == "staged" and fits != "staged":
        raise ValueError("this launch cannot take the staged path (tile bytes, alignment"
                         " or shared memory)")
    threads = DEFAULT_THREADS[path] if threads is None else int(threads)
    if threads not in THREADS[path]:
        raise ValueError(f"the {path} kernel takes {THREADS[path]} threads a CTA, got {threads}")
    code = lib.rsp_shuffle_launch(
        xb.data_ptr(), tp.data_ptr(), ip.data_ptr(), out.data_ptr(),
        b, r, tile_rows, row_bytes, int(path == "staged"), threads,
        _cuda.stream_handle(xb.device),
    )
    _cuda.check(code, "rsp_shuffle kernel")
    LAUNCHES.add()
    return out if batched else out[0]


def rsp_shuffle(x, tile_perm, intra_perm, *, tile_rows: int, path: str | None = None,
                threads: int | None = None) -> torch.Tensor:
    """The kernel for a CUDA tensor (at the given configuration), the plain
    version for a CPU tensor."""
    if x.is_cuda:
        return rsp_shuffle_cuda(x, tile_perm, intra_perm, tile_rows=tile_rows, path=path,
                                threads=threads)
    return rsp_shuffle_plain(x, tile_perm, intra_perm, tile_rows=tile_rows)
