"""The hierarchical row shuffle on tensors: the CUDA kernel and its plain
version.

For every batch ``b`` (one original block), output tile ``i`` and row ``r``::

    out[b, i*T + r] = x[b, tile_perm[b, i]*T + intra_perm[b, i, r]]

``x`` is ``[R, D]`` or batched ``[B, R, D]`` (any dtype; rows are copied
bit for bit; the kernel takes rows of an even number of bytes), ``tile_perm`` ``[R/T]`` / ``[B, R/T]`` and ``intra_perm``
``[R/T, T]`` / ``[B, R/T, T]`` int32 permutations.

* :func:`rsp_shuffle_cuda` launches ``csrc/rsp_shuffle.cu`` (the port of
  the Pallas ``rsp_shuffle_pallas``; all batches in one launch) and counts
  the launch in :data:`LAUNCHES`.  CUDA tensors only.
* :func:`rsp_shuffle_plain` is the same gather in plain PyTorch, on any
  device.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _cuda

LAUNCHES = _cuda.LaunchCounter("rsp_shuffle")


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


def rsp_shuffle_cuda(x, tile_perm, intra_perm, *, tile_rows: int) -> torch.Tensor:
    """Launch the CUDA kernel (all batches in one launch)."""
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
    lib = _cuda.library()
    code = lib.rsp_shuffle_launch(
        xb.data_ptr(), tp.data_ptr(), ip.data_ptr(), out.data_ptr(),
        b, r, tile_rows, d * xb.element_size(), _cuda.stream_handle(xb.device),
    )
    _cuda.check(code, "rsp_shuffle kernel")
    LAUNCHES.add()
    return out if batched else out[0]


def rsp_shuffle(x, tile_perm, intra_perm, *, tile_rows: int) -> torch.Tensor:
    """The kernel for a CUDA tensor, the plain version for a CPU tensor."""
    if x.is_cuda:
        return rsp_shuffle_cuda(x, tile_perm, intra_perm, tile_rows=tile_rows)
    return rsp_shuffle_plain(x, tile_perm, intra_perm, tile_rows=tile_rows)
