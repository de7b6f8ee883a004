"""Synthetic data generators (copied from the reference package: the same
bits at the same seed).

``make_higgs_like`` reproduces the statistical shape of the paper's HIGGS
experiments (two-class, 28 continuous features, moderately separable)
without the 11M-record download; ``make_nonrandom_higgs_like`` is its
class-sorted variant, the worst storage order for partitioning;
``make_token_corpus`` is the LM training corpus (Zipf tokens, optionally
drifting across the corpus).
"""

from __future__ import annotations

import numpy as np


def make_higgs_like(
    num_records: int,
    *,
    num_features: int = 28,
    num_informative: int = 8,
    class_sep: float = 1.0,
    seed: int = 0,
    shuffle: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """Two-class Gaussian-mixture tabular data, HIGGS-shaped.

    Informative features get class-dependent means drawn once per dataset;
    the rest are pure noise (like HIGGS's low-level kinematic features).
    Returns (X [N, F] float32, y [N] int32).
    """
    rng = np.random.default_rng(seed)
    num_informative = min(num_informative, num_features)
    n1 = num_records // 2
    n0 = num_records - n1
    means = np.zeros((2, num_features), dtype=np.float32)
    direction = rng.normal(size=num_informative).astype(np.float32)
    direction /= np.linalg.norm(direction)
    means[1, :num_informative] = class_sep * direction
    cov_scale = rng.uniform(0.8, 1.4, size=num_features).astype(np.float32)

    x0 = rng.normal(size=(n0, num_features)).astype(np.float32) * cov_scale + means[0]
    x1 = rng.normal(size=(n1, num_features)).astype(np.float32) * cov_scale + means[1]
    x = np.concatenate([x0, x1], axis=0)
    y = np.concatenate([np.zeros(n0, np.int32), np.ones(n1, np.int32)])
    if shuffle:
        perm = rng.permutation(num_records)
        x, y = x[perm], y[perm]
    return x, y


def make_nonrandom_higgs_like(num_records: int, **kw) -> tuple[np.ndarray, np.ndarray]:
    """Class-sorted (non-randomized) variant: the pathological storage order
    the paper warns about -- sequential chunking of this data yields blocks
    that are NOT random samples."""
    x, y = make_higgs_like(num_records, shuffle=False, **kw)
    order = np.argsort(y, kind="stable")
    return x[order], y[order]


def make_token_corpus(
    num_sequences: int,
    seq_len: int,
    *,
    vocab_size: int = 32000,
    seed: int = 0,
    zipf_a: float = 1.2,
    drift: bool = False,
) -> np.ndarray:
    """Zipf token corpus of shape [num_sequences, seq_len] int32.

    ``drift=True`` makes the token distribution drift across the corpus
    (document-ordered storage) -- the non-randomized case where sequential
    chunking breaks the random-sample property for LM data.
    """
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = ranks**-zipf_a
    probs /= probs.sum()
    out = np.empty((num_sequences, seq_len), dtype=np.int32)
    if not drift:
        flat = rng.choice(vocab_size, size=num_sequences * seq_len, p=probs)
        out[:] = flat.reshape(num_sequences, seq_len).astype(np.int32)
    else:
        # Topic drift: rotate the zipf ranking gradually across the corpus.
        for i in range(num_sequences):
            shift = int(vocab_size * i / max(num_sequences, 1) * 0.5)
            p = np.roll(probs, shift)
            out[i] = rng.choice(vocab_size, size=seq_len, p=p).astype(np.int32)
    return out
