"""The token corpus of a cell, made from ``--seed``.

A corpus is ``sequences`` rows of ``length`` token ids.  Ids follow a Zipf
law over the vocabulary, ``p(rank) ~ 1 / (rank + offset) ** exponent``, as
word frequencies in text do, with the ranks laid on the ids by a seeded
permutation, so frequent ids are spread over the vocabulary and over the
unembedding's rows.  The draws are made on the card from a
``torch.Generator`` seeded with the seed, in one call, and copied to the
host as int32.

The traffic file gives ``sequences``, ``length``, ``zipf_exponent`` and
``zipf_offset``; every seed gets the same sizes.
"""

from __future__ import annotations

import numpy as np
import torch

CORPUS_STREAM = 0x70C5     # the corpus generator's stream, apart from the weights'


def make_corpus(traffic: dict, vocab: int, seed: int, device) -> np.ndarray:
    """``[sequences, length]`` int32 token ids."""
    n, length = traffic["sequences"], traffic["length"]
    g = torch.Generator(device=device).manual_seed((seed * 0x9E3779B1 + CORPUS_STREAM) % (1 << 63))
    ranks = torch.arange(vocab, dtype=torch.float64, device=device)
    p = (ranks + traffic.get("zipf_offset", 2.7)) ** -traffic.get("zipf_exponent", 1.1)
    cdf = torch.cumsum(p / p.sum(), 0)
    cdf[-1] = 1.0
    ids = torch.randperm(vocab, generator=g, device=device)
    u = torch.rand(n * length, generator=g, device=device, dtype=torch.float64)
    rank = torch.clamp(torch.searchsorted(cdf, u), max=vocab - 1)
    return ids[rank].to(torch.int32).reshape(n, length).cpu().numpy()


def row_hashes(rows: np.ndarray) -> np.ndarray:
    """One 64-bit hash a row (ids times fixed odd multipliers, summed with
    wrap-around): equal rows hash alike, and two of a corpus's random rows
    collide with odds of about 2^-64."""
    rows = np.ascontiguousarray(rows).astype(np.uint64)
    mult = np.random.default_rng(0x5EED).integers(1, 1 << 63, size=rows.shape[1],
                                                  dtype=np.uint64) * np.uint64(2) + np.uint64(1)
    with np.errstate(over="ignore"):
        return (rows * mult).sum(axis=1, dtype=np.uint64)
