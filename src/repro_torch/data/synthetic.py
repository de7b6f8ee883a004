"""Synthetic data generators (copied from the reference package: the same
bits at the same seed).

``make_higgs_like`` reproduces the statistical shape of the paper's HIGGS
experiments (two-class, 28 continuous features, moderately separable)
without the 11M-record download; ``make_nonrandom_higgs_like`` is its
class-sorted variant, the worst storage order for partitioning.
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
