"""Two-stage RSP partitioning (Algorithm 1 of the paper) and the
Definition-2/3 checks.

``two_stage_partition_np`` is the paper-faithful numpy implementation,
bit-identical to the reference package's: the same ``SeedSequence``
streams draw the same permutations.  The on-card form of Algorithm 1 is
the ``cuda`` partition backend (``repro_torch.rsp.backends``), which
draws its permutations here on the host (:func:`_np_rng`) and moves rows
with the ``rsp_shuffle`` kernel.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from repro_torch.core.types import RSPSpec
from repro_torch.device import as_numpy


def _np_rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, *stream]))


def two_stage_partition_np(
    data: np.ndarray,
    spec: RSPSpec,
    *,
    permute_assignment: bool = True,
) -> np.ndarray:
    """Algorithm 1: returns an array of K RSP blocks, shape [K, n, ...].

    Stage 1 (chunking): ``data`` is viewed as P original blocks in storage
    order.  Stage 2 (randomization): each original block is permuted locally
    (stream ``(seed, 0, i)``), sliced into K sub-blocks of ``delta``
    records, and RSP block ``k`` is the concatenation of one sub-block drawn
    *without replacement* from each original block (``permute_assignment``
    draws that assignment from stream ``(seed, 1, i)``).
    """
    if data.shape[0] != spec.num_records:
        raise ValueError(f"data has {data.shape[0]} records, spec says {spec.num_records}")
    P, K = spec.num_original_blocks, spec.num_blocks
    if spec.num_records % (P * K) != 0:
        raise ValueError(
            f"spec unsatisfiable: N={spec.num_records} must be divisible by"
            f" P*K={P * K} (P={P} original blocks x K={K} RSP blocks need"
            " uniform sub-blocks of delta = N/(P*K) records)"
        )
    delta = spec.slice_size
    tail = data.shape[1:]

    out = np.empty((K, spec.block_size, *tail), dtype=data.dtype)
    original = data.reshape(P, spec.original_block_size, *tail)
    for i in range(P):
        rng = _np_rng(spec.seed, 0, i)
        block = original[i][rng.permutation(spec.original_block_size)]
        sub = block.reshape(K, delta, *tail)
        if permute_assignment:
            assign = _np_rng(spec.seed, 1, i).permutation(K)
        else:
            assign = np.arange(K)
        # sub-block assign[k] of original block i -> slice i of RSP block k
        out[:, i * delta : (i + 1) * delta] = sub[assign]
    return out


# ---------------------------------------------------------------------------
# Validation helpers (Definition 2 / Definition 3 empirical checks)
# ---------------------------------------------------------------------------

def _lex_sorted_rows(x: np.ndarray) -> np.ndarray:
    """Rows of ``x`` as a byte matrix, sorted lexicographically as *whole
    rows* -- row (record) identity is preserved, unlike a column-wise sort."""
    x = np.asarray(x)
    n = x.shape[0] if x.ndim else 0
    feat = int(np.prod(x.shape[1:], dtype=np.int64))
    rows = np.ascontiguousarray(x.reshape(n, feat))
    b = rows.view(np.uint8).reshape(n, -1) if rows.size else rows.view(np.uint8)
    if b.shape[0] <= 1 or b.shape[1] == 0:
        return b
    return b[np.lexsort(b.T[::-1])]


def is_partition(blocks, data) -> bool:
    """Definition 2: blocks form a partition of ``data`` (as multisets of
    whole records).  Accepts numpy arrays or tensors on any device."""
    blocks = as_numpy(blocks)
    data = as_numpy(data)
    flat = blocks.reshape(-1, *blocks.shape[2:])
    if flat.shape != data.shape:
        return False
    return bool(np.array_equal(_lex_sorted_rows(flat), _lex_sorted_rows(data)))


def empirical_cdf(x, thresholds: Sequence[float]) -> np.ndarray:
    """F(t) for each threshold -- used by Lemma-1 style unbiasedness tests."""
    x = as_numpy(x).reshape(-1)
    t = np.asarray(thresholds).reshape(-1, 1)
    return (x[None, :] <= t).mean(axis=1)
