"""Two-stage RSP partitioning (Algorithm 1 of the paper) and the
Definition-2/3 checks.

``two_stage_partition_np`` is the paper-faithful numpy implementation,
bit-identical to the reference package's: the same ``SeedSequence``
streams draw the same permutations.  The on-card form of Algorithm 1 is
the ``cuda`` partition backend (``repro_torch.rsp.backends``), which
draws its permutations here on the host (:func:`_np_rng`) and moves rows
with the ``rsp_shuffle`` kernel.  :func:`two_stage_partition_torch` is
Algorithm 1 in plain PyTorch (the ``torch`` backend, the counterpart of the
reference's jit path): any dtype, any trailing shape, permutations from a
``torch.Generator``.  :func:`distributed_rsp_partition` is Algorithm 1 as
one collective over a ``torch.distributed`` group, each rank holding one
original block.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.types import RSPSpec
from repro_torch.device import as_numpy, dry_run


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


def two_stage_partition_torch(
    data: torch.Tensor,
    generator: torch.Generator,
    *,
    num_blocks: int,
    num_original_blocks: int,
    permute_assignment: bool = True,
) -> torch.Tensor:
    """Algorithm 1 in plain PyTorch.  Returns ``[K, n, ...]`` on ``data``'s
    device.

    One ``torch.randperm`` a original block permutes it; with
    ``permute_assignment``, one permutation of the K sub-blocks a original
    block deals them (all P row permutations are drawn first, then the P
    assignments).  The permutations are drawn on ``generator``'s device --
    a CPU generator gives the same blocks on every device -- and the
    slice-and-recombine is the reference's transpose/reshape, applied to
    the row indices so that the rows move in one gather on ``data``'s
    device.
    """
    N = data.shape[0]
    P, K = int(num_original_blocks), int(num_blocks)
    tail = data.shape[1:]
    if N % (P * K) != 0:
        raise ValueError(f"N={N} must be divisible by P*K={P * K}")
    delta, R = N // (P * K), N // P
    gen_dev = generator.device
    perms = torch.stack([
        torch.randperm(R, generator=generator, device=gen_dev) for _ in range(P)
    ])
    # global row ids of each original block's sub-blocks: [P, K, delta]
    sub = (perms + torch.arange(P, device=gen_dev)[:, None] * R).reshape(P, K, delta)
    if permute_assignment:
        assign = torch.stack([
            torch.randperm(K, generator=generator, device=gen_dev) for _ in range(P)
        ])
        sub = sub[torch.arange(P, device=gen_dev)[:, None], assign]
    # recombine: RSP block k = concat over i of sub[i, k] -> [K, P*delta]
    idx = sub.transpose(0, 1).reshape(-1).to(data.device)
    return data.index_select(0, idx).reshape(K, P * delta, *tail)


def randomize_dataset(data: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Global randomization (for non-randomized sources; paper Sec. 2): one
    ``torch.randperm`` over the rows, drawn on ``generator``'s device."""
    perm = torch.randperm(data.shape[0], generator=generator, device=generator.device)
    return data.index_select(0, perm.to(data.device))


def distributed_rsp_partition(shard: torch.Tensor, seed: int, group=None) -> torch.Tensor:
    """Algorithm 1 as one collective over a ``torch.distributed`` group of
    D ranks (P = K = D).

    Rank ``i`` of ``group`` (the default group when ``None``) holds original
    block ``i`` as ``shard [N/D, F]`` on its device.  It randomizes the block
    with the ``rsp_shuffle`` kernel (its plain version on the CPU) at
    ``tile_rows = N/D^2``, with the permutations of
    ``make_permutations(seed, i, D, N/D^2)``, so output tile ``k`` is the
    sub-block destined for RSP block ``k``; then one ``all_to_all_single``
    transposes (rank, sub-block), and rank ``k`` returns RSP block ``k``
    ``[N/D, F]`` on the shard's device.  For these streams rank ``k``'s block
    equals block ``k`` of the ``cuda`` backend's partition of the
    concatenated shards (``rsp.partition(data, blocks=D, original_blocks=D,
    backend="cuda")``) bit for bit.  Threefry cannot be drawn in torch, so
    against the reference's ``shard_map`` partition it is held to
    Definition 2 and Lemma 1 only, as the ``cuda`` backend is.

    The group must be a gloo group: the exchange runs on host tensors, so a
    shard on the card costs one copy off the card, the exchange, and one
    copy back.  Any other backend is refused, but the ``"fake"`` backend of
    a dry run on a fake shard (``device.dry_run``, ``launch/dryrun.py``),
    which traces the program on shapes.
    """
    import torch.distributed as dist

    from repro_torch.kernels.rsp_shuffle import make_permutations, rsp_shuffle

    reason = exchange_refusal(group, shard)
    if reason is not None:
        raise ValueError(reason)
    d, i = dist.get_world_size(group), dist.get_rank(group)
    if shard.ndim != 2:
        raise ValueError(f"a shard is one original block [N/D, F], got {tuple(shard.shape)}")
    rows, _ = shard.shape
    if rows % d:
        raise ValueError(
            f"N={rows * d} must be divisible by D^2={d * d} (P=K=D, delta=N/D^2)"
        )
    tile_perm, intra = make_permutations(seed, i, d, rows // d)
    sub = rsp_shuffle(shard.contiguous(), torch.from_numpy(tile_perm).to(shard.device),
                      torch.from_numpy(intra).to(shard.device), tile_rows=rows // d)
    with obs.get_tracer().span("partition.exchange") if obs.enabled() else _NO_SPAN:
        send = sub.cpu()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        return recv.to(shard.device)


_NO_SPAN = contextlib.nullcontext()


def exchange_refusal(group=None, shard: torch.Tensor | None = None) -> str | None:
    """Why :func:`distributed_rsp_partition` cannot exchange ``shard`` over
    ``group`` (a group that is not gloo, or the ``"fake"`` backend, which
    moves no data, outside a dry run on a fake shard), or ``None``."""
    import torch.distributed as dist

    backend = dist.get_backend(group)
    if backend == "fake" and shard is not None and dry_run(shard):
        return None
    if backend != "gloo":
        return f"the exchange runs on host tensors over gloo; the group's backend is {backend!r}"
    return None


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
