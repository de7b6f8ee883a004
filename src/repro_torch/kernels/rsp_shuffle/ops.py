"""Host-drawn permutations for the hierarchical shuffle, and Algorithm 1's
randomize step on tensors.

The reference draws its permutations on the device with JAX's threefry,
which torch cannot reproduce.  The port draws them on the host with numpy,
from documented ``SeedSequence`` streams, for original block ``i`` of a
partition seeded with ``seed``:

* tile permutation: ``_np_rng(seed, 2, i).permutation(n_tiles)``;
* intra-tile permutations: ``_np_rng(seed, 3, i).permuted(rows, axis=1)``
  with ``rows = [arange(T)] * n_tiles`` -- one independent permutation of
  ``T`` rows per tile.

(``_np_rng(seed, *stream)`` is ``default_rng(SeedSequence([seed,
*stream]))``; streams 0 and 1 are the ``np`` backend's.)  So the port's plain
version on the CPU and its kernel on the card produce the same bits, while
neither matches the reference's ``pallas`` backend bit for bit: those are
held to Definition 2 and Lemma 1 instead.

On a CUDA tensor the kernel's configuration (its path and the threads a
CTA) comes from the autotuner (``kernels/autotune.py``):
:func:`shuffle_config` times :func:`shuffle_candidates` once a shape
bucket and keeps the winner.  The configuration never changes the output.
:func:`rsp_randomize_block` is the counterpart of the reference's
``rsp_randomize_block(x, key, tile_rows=None)``: with no tile it asks the
tuner for the fastest of :data:`SHUFFLE_TILES` that divides the block (the
tile is part of the permutation's definition, so the tile changes which
rows land where), and with tuning off or on the CPU takes
:data:`DEFAULT_SHUFFLE_TILE`, as the reference does.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.partition import _np_rng
from repro_torch.kernels import autotune
from repro_torch.kernels.autotune import Candidate
from repro_torch.kernels.rsp_shuffle.kernel import (
    DEFAULT_THREADS,
    SMEM_OPTIN_H100,
    THREADS,
    rsp_shuffle,
    rsp_shuffle_cuda,
    shuffle_path,
)

SHUFFLE_TILES = (64, 128, 256, 512, 1024)
DEFAULT_SHUFFLE_TILE = 256


def make_permutations(seed: int, block_index: int, n_tiles: int, tile_rows: int):
    """``(tile_perm [n_tiles], intra_perm [n_tiles, tile_rows])`` int32 for
    original block ``block_index`` (see the module docstring)."""
    tile_perm = _np_rng(seed, 2, block_index).permutation(n_tiles).astype(np.int32)
    rows = np.broadcast_to(np.arange(tile_rows, dtype=np.int32), (n_tiles, tile_rows))
    intra = _np_rng(seed, 3, block_index).permuted(rows, axis=1)
    return tile_perm, np.ascontiguousarray(intra, dtype=np.int32)


def partition_permutations(seed: int, num_blocks: int, n_tiles: int, tile_rows: int):
    """Stacked permutations of ``num_blocks`` original blocks:
    ``([P, n_tiles], [P, n_tiles, tile_rows])`` int32."""
    pairs = [make_permutations(seed, i, n_tiles, tile_rows) for i in range(num_blocks)]
    tile_perm = np.ascontiguousarray(np.stack([p[0] for p in pairs]))
    intra = np.ascontiguousarray(np.stack([p[1] for p in pairs]))
    return tile_perm, intra


def shuffle_candidates(tile_rows: int, row_bytes: int, *,
                       smem_limit: int = SMEM_OPTIN_H100) -> list[Candidate]:
    """The kernel configurations a launch may take: the row kernel at each
    of its CTA sizes, and the staged kernel at each of its own where a tile
    can be staged (aligned bases assumed).  Kernel configurations only."""
    paths = ["rows"]
    if shuffle_path(tile_rows, row_bytes, smem_limit=smem_limit) == "staged":
        paths.insert(0, "staged")
    return [Candidate.of("cuda", path=p, threads=t) for p in paths for t in THREADS[p]]


def default_config(tile_rows: int, row_bytes: int, *,
                   smem_limit: int = SMEM_OPTIN_H100) -> Candidate:
    """The configuration of an untuned launch on aligned tensors."""
    path = shuffle_path(tile_rows, row_bytes, smem_limit=smem_limit)
    return Candidate.of("cuda", path=path, threads=DEFAULT_THREADS[path])


def shuffle_key(x: torch.Tensor, tile_rows: int) -> str:
    """The tuner's key of a launch over ``x [B, R, D]`` at ``tile_rows``."""
    b, r, d = x.shape
    bb = 1 << max(0, int(b) - 1).bit_length()
    return autotune.shape_key(r, d, str(x.dtype).removeprefix("torch.")) + f"|B{bb}|T{tile_rows}"


def shuffle_config(x: torch.Tensor, tp: torch.Tensor, ip: torch.Tensor,
                   tile_rows: int) -> Candidate:
    """The tuned configuration of a launch over ``x [B, R, D]`` (the
    default with tuning off or on a CPU tensor)."""
    row_bytes = x.shape[2] * x.element_size()
    limit = SMEM_OPTIN_H100
    if x.is_cuda:
        from repro_torch.kernels import _cuda

        limit = _cuda.library().repro_smem_optin()
    default = default_config(tile_rows, row_bytes, smem_limit=limit)
    xs = autotune.Rotation(x)

    def measure(c: Candidate) -> float:
        return autotune.cuda_seconds(
            lambda i: rsp_shuffle_cuda(xs(i), tp, ip, tile_rows=tile_rows,
                                       path=c.get("path"), threads=c.get("threads")), x.device)

    return autotune.choose(
        "rsp_shuffle", shuffle_key(x, tile_rows),
        shuffle_candidates(tile_rows, row_bytes, smem_limit=limit), measure,
        default=default, device=x.device,
    )


def _shuffle_tuned(x: torch.Tensor, tp: torch.Tensor, ip: torch.Tensor,
                   tile_rows: int) -> torch.Tensor:
    if not x.is_cuda:
        return rsp_shuffle(x, tp, ip, tile_rows=tile_rows)
    cfg = shuffle_config(x, tp, ip, tile_rows)
    path, threads = cfg.get("path"), cfg.get("threads")
    if path == "staged" and shuffle_path(tile_rows, x.shape[2] * x.element_size(),
                                         x_ptr=x.data_ptr()) != "staged":
        # the bucket's staged winner, on a tensor this launch cannot stage
        # (an unaligned view): the row kernel at its default size, the same output
        path, threads = "rows", DEFAULT_THREADS["rows"]
    return rsp_shuffle(x, tp, ip, tile_rows=tile_rows, path=path, threads=threads)


def rsp_randomize_blocks(x: torch.Tensor, seed: int, *, tile_rows: int) -> torch.Tensor:
    """Randomize original blocks ``x [P, R, D]`` on their device (the kernel
    at its tuned configuration on the card, the plain gather on the CPU)
    with the permutations of :func:`partition_permutations`."""
    p, r, _ = x.shape
    if r % tile_rows:
        raise ValueError(f"R={r} must be divisible by tile_rows={tile_rows}")
    tile_perm, intra = partition_permutations(seed, p, r // tile_rows, tile_rows)
    tp = torch.from_numpy(tile_perm).to(x.device)
    ip = torch.from_numpy(intra).to(x.device)
    return _shuffle_tuned(x, tp, ip, tile_rows)


def randomize_tile(x: torch.Tensor, seed: int, *, block_index: int = 0) -> int:
    """The tile of :func:`rsp_randomize_block` on ``x [R, D]``: the tuner's
    fastest divisor of R among :data:`SHUFFLE_TILES` (each timed at its
    default configuration), or :data:`DEFAULT_SHUFFLE_TILE` (the largest
    divisor when 256 does not divide R) with tuning off or on the CPU."""
    r = int(x.shape[0])
    valid = [t for t in SHUFFLE_TILES if r % t == 0]
    if not valid:
        raise ValueError(
            f"no tile in {SHUFFLE_TILES} divides R={r}; pass tile_rows explicitly"
        )
    default_tile = DEFAULT_SHUFFLE_TILE if r % DEFAULT_SHUFFLE_TILE == 0 else valid[-1]
    xb = x.reshape(1, r, -1)
    xs = autotune.Rotation(xb)

    def measure(c: Candidate) -> float:
        t = c.tile_rows
        tp, ip = (torch.from_numpy(a[None]).to(x.device)
                  for a in make_permutations(seed, block_index, r // t, t))
        return autotune.cuda_seconds(
            lambda i: rsp_shuffle_cuda(xs(i), tp, ip, tile_rows=t), x.device)

    cfg = autotune.choose(
        "rsp_shuffle_tile", autotune.shape_key(r, xb.shape[2], str(x.dtype).removeprefix("torch.")),
        [Candidate("cuda", t) for t in valid], measure,
        default=Candidate("cuda", default_tile), device=x.device,
    )
    return cfg.tile_rows if cfg.tile_rows in valid else default_tile


def rsp_randomize_block(x: torch.Tensor, seed: int, *, tile_rows: int | None = None,
                        block_index: int = 0) -> torch.Tensor:
    """Randomize one original block ``x [R, D]`` on its device with the
    permutations of original block ``block_index`` (``make_permutations``).

    ``tile_rows=None`` takes :func:`randomize_tile`; an explicit tile is
    honoured verbatim, and is part of the shuffle's definition: two tiles
    give two permutations."""
    if tile_rows is None:
        tile_rows = randomize_tile(x, seed, block_index=block_index)
    r = x.shape[0]
    if r % tile_rows:
        raise ValueError(f"R={r} must be divisible by tile_rows={tile_rows}")
    tile_perm, intra = make_permutations(seed, block_index, r // tile_rows, tile_rows)
    tp = torch.from_numpy(tile_perm[None]).to(x.device)
    ip = torch.from_numpy(intra[None]).to(x.device)
    return _shuffle_tuned(x.reshape(1, r, -1), tp, ip, tile_rows).reshape(x.shape)
