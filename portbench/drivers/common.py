"""What the drivers share: the weights drawn from the seed, the corpus and
its RSP partition, the loader, the data layer's checks and the numbers
compared with their limits.

Weights are drawn on the device from a ``torch.Generator`` seeded from the
seed, in one ``randn`` over every parameter, then scaled and shifted leaf
by leaf to each leaf's (mean, std) from the reference's ``leaf_specs``.
The same call again gives the same weights, so the reference rebuilds them
after the window instead of the benchmark holding a copy.
"""

from __future__ import annotations

import dataclasses
import importlib
import math

import numpy as np
import torch

from portbench.reference.common import set_path
from portbench.traffic.tokens import make_corpus, row_hashes

WEIGHTS_STREAM = 0x3E16
PARTITION_STREAM = 0x9A27
LOADER_STREAM = 0x10AD


def stream_seed(seed: int, stream: int) -> int:
    """A seed for one of the run's generators, from the run's seed."""
    return (seed * 0x9E3779B97F4A7C15 + stream) % (1 << 63)


def reference_module(config: dict):
    """The configuration's plain reference (``portbench.reference.<name>``)."""
    return importlib.import_module(f"portbench.reference.{config['reference']}")


def make_weights(specs, seed: int, device) -> dict:
    """A float32 parameter tree drawn from the seed: one flat ``randn``,
    each leaf a view of it at its (mean, std), or mapped by the function a
    spec carries fifth."""
    total = sum(math.prod(spec[1]) for spec in specs)
    g = torch.Generator(device=device).manual_seed(stream_seed(seed, WEIGHTS_STREAM))
    flat = torch.randn(total, generator=g, device=device)
    tree, at = {}, 0
    for path, shape, mean, std, *draw in specs:
        n = math.prod(shape)
        leaf = flat[at:at + n].view(shape)
        if draw:                    # a leaf the reference draws its own way from normals
            leaf.copy_(draw[0](leaf))
        else:
            leaf.mul_(std)
            if mean:
                leaf.add_(mean)
        set_path(tree, path, leaf)
        at += n
    return tree


@dataclasses.dataclass
class Data:
    """The corpus, its RSP blocks and their hashes."""
    corpus: np.ndarray          # [N, length] int32
    blocks: np.ndarray          # [K, N / K, length]
    hashes: dict                # row hash -> corpus row


def make_data(traffic: dict, vocab: int, seed: int, device) -> Data:
    """The corpus made from the seed, partitioned into K RSP blocks by the
    program's Algorithm 1 (``two_stage_partition_np``)."""
    from repro_torch.core import RSPSpec, two_stage_partition_np

    corpus = make_corpus(traffic, vocab, seed, device)
    K = traffic["blocks"]
    spec = RSPSpec(num_records=corpus.shape[0], num_blocks=K, num_original_blocks=K,
                   seed=stream_seed(seed, PARTITION_STREAM))
    blocks = two_stage_partition_np(corpus, spec)
    hashes = {int(h): i for i, h in enumerate(row_hashes(corpus))}
    return Data(corpus, blocks, hashes)


def make_loader(data: Data, batch: int, seed: int, device):
    """The program's RSP loader over blocks held on the card."""
    from repro_torch.data import BlockSource, RSPLoader

    return RSPLoader(BlockSource(blocks=data.blocks, device=device), batch_size=batch,
                     seed=stream_seed(seed, LOADER_STREAM) % (1 << 32))


def partition_defects(data: Data) -> int:
    """Rows by which the blocks fail to be a partition of the corpus
    (Definition 2: every row in exactly one block): the multisets of row
    hashes compared."""
    mine = np.sort(row_hashes(data.blocks.reshape(-1, data.blocks.shape[-1])))
    want = np.sort(row_hashes(data.corpus))
    if mine.shape != want.shape:
        return abs(mine.shape[0] - want.shape[0]) + min(mine.shape[0], want.shape[0])
    return int(np.count_nonzero(mine != want))


def corpus_rows(data: Data, rows: np.ndarray) -> tuple[list[int], int]:
    """The corpus index of each row (-1 where none matches) and how many
    rows match none."""
    idx = [data.hashes.get(int(h), -1) for h in row_hashes(rows)]
    idx = [i if i >= 0 and np.array_equal(data.corpus[i], r) else -1 for i, r in zip(idx, rows)]
    return idx, sum(i < 0 for i in idx)


def leaf_gap(prog: list[float], ref: list[float], keep: list[bool] | None = None) -> float:
    """The worst leaf's gap between two per-leaf norms: ``|a - b|`` over the
    larger of the reference's norm of that leaf and of the median leaf."""
    med = float(np.median(ref))
    gaps = [abs(a - b) / max(b, med, 1e-30)
            for i, (a, b) in enumerate(zip(prog, ref)) if keep is None or keep[i]]
    return max(gaps) if gaps else float("nan")


def free_device() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
