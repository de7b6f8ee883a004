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
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.partition import _np_rng
from repro_torch.kernels.rsp_shuffle.kernel import rsp_shuffle


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


def rsp_randomize_blocks(x: torch.Tensor, seed: int, *, tile_rows: int) -> torch.Tensor:
    """Randomize original blocks ``x [P, R, D]`` on their device (the kernel
    on the card, the plain gather on the CPU) with the permutations of
    :func:`partition_permutations`."""
    p, r, _ = x.shape
    if r % tile_rows:
        raise ValueError(f"R={r} must be divisible by tile_rows={tile_rows}")
    tile_perm, intra = partition_permutations(seed, p, r // tile_rows, tile_rows)
    tp = torch.from_numpy(tile_perm).to(x.device)
    ip = torch.from_numpy(intra).to(x.device)
    return rsp_shuffle(x, tp, ip, tile_rows=tile_rows)
