"""Oracle: the hierarchical permutation as a flat row gather (numpy)."""

from __future__ import annotations

import numpy as np


def flat_indices(tile_perm: np.ndarray, intra_perm: np.ndarray, tile_rows: int) -> np.ndarray:
    """Expand (tile_perm, intra_perm) to the equivalent flat row gather."""
    n_tiles = tile_perm.shape[0]
    out = np.empty(n_tiles * tile_rows, dtype=np.int64)
    for i in range(n_tiles):
        src = tile_perm[i] * tile_rows
        out[i * tile_rows : (i + 1) * tile_rows] = src + intra_perm[i]
    return out


def rsp_shuffle_ref(x, tile_perm, intra_perm, *, tile_rows: int) -> np.ndarray:
    idx = flat_indices(np.asarray(tile_perm), np.asarray(intra_perm), tile_rows)
    return np.asarray(x)[idx]
