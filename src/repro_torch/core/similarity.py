"""Distribution-similarity measures between RSP blocks and the full data.

The paper's Sec. 7 toolkit on tensors of any device: MMD (Gretton et al.
kernel two-sample test), Hotelling's T-square test for mean differences, a
1-D two-sample KS statistic, and categorical label-distribution comparison
(Fig. 2a).  Numpy arrays are accepted too and are computed on the host.

Numerics follow the reference package: MMD^2 and its median-heuristic
bandwidth use ``xx + yy - 2 x @ y.T`` in float32, Hotelling's statistics
are float64, and KS and the label frequencies are exact (integer counts
divided in float64).  Subsamples are drawn with
``np.random.default_rng(seed).choice`` on the host and gathered on the
tensor's device, so both packages pick the same rows.
"""

from __future__ import annotations

import numpy as np
import scipy.special
import torch


def _tensor(x) -> torch.Tensor:
    """A tensor where it lies; numpy and array-likes become host tensors."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _rows(x: torch.Tensor, n: int, rng: np.random.Generator) -> torch.Tensor:
    """``n`` rows of ``x`` drawn without replacement by ``rng`` (on the host)."""
    idx = rng.choice(x.shape[0], min(n, x.shape[0]), replace=False)
    return x[torch.from_numpy(idx).to(x.device)]


# ---------------------------------------------------------------------------
# MMD^2 (unbiased, RBF kernel)
# ---------------------------------------------------------------------------

def _sq_dists(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    xx = (x * x).sum(-1)[:, None]
    yy = (y * y).sum(-1)[None, :]
    return xx + yy - 2.0 * x @ y.T


def mmd2_rbf(x, y, gamma) -> torch.Tensor:
    """Unbiased MMD^2 with k(a,b) = exp(-gamma * ||a-b||^2), in float32 on
    ``x``'s device (a 0-d tensor)."""
    x = _tensor(x).to(torch.float32)
    y = _tensor(y).to(device=x.device, dtype=torch.float32)
    gamma = torch.as_tensor(gamma, dtype=torch.float32, device=x.device)
    m, n = x.shape[0], y.shape[0]
    kxx = torch.exp(-gamma * _sq_dists(x, x))
    kyy = torch.exp(-gamma * _sq_dists(y, y))
    kxy = torch.exp(-gamma * _sq_dists(x, y))
    sum_xx = (kxx.sum() - torch.trace(kxx)) / (m * (m - 1))
    sum_yy = (kyy.sum() - torch.trace(kyy)) / (n * (n - 1))
    return sum_xx + sum_yy - 2.0 * kxy.mean()


def median_heuristic_gamma(x, max_points: int = 512) -> float:
    """gamma = 1 / (2 * median(||a-b||^2)) on the first ``max_points`` rows.
    The distances are float32 and the median is numpy's (the mean of the two
    middle values for an even count), as in the reference package."""
    x = _tensor(x)[:max_points].to(torch.float32)
    d = _sq_dists(x, x)
    iu = torch.triu_indices(d.shape[0], d.shape[1], offset=1, device=d.device)
    vals = torch.sort(d[iu[0], iu[1]]).values
    k = vals.numel()
    mid = vals[k // 2] if k % 2 else (vals[k // 2 - 1] + vals[k // 2]) / 2
    return 1.0 / max(2.0 * float(mid), 1e-12)


def mmd_block_vs_data(block, data, *, max_points: int = 1024, seed: int = 0) -> float:
    """MMD^2 between a block and a subsample of the full data set."""
    rng = np.random.default_rng(seed)
    b, d = _tensor(block), _tensor(data)
    b = _rows(b.reshape(b.shape[0], -1), max_points, rng)
    d = _rows(d.reshape(d.shape[0], -1), max_points, rng)
    gamma = median_heuristic_gamma(d)
    return float(mmd2_rbf(b, d, gamma))


# ---------------------------------------------------------------------------
# Hotelling's T-square two-sample test
# ---------------------------------------------------------------------------

def _cov(a: torch.Tensor) -> torch.Tensor:
    """Sample covariance [p, p] of the rows of ``a`` (ddof 1, like ``np.cov``)."""
    return torch.cov(a.T).reshape(a.shape[1], a.shape[1])


def hotelling_t2(x, y) -> tuple[float, float, float]:
    """Returns (t2, f_stat, p_value) for H0: mean(x) == mean(y).  The
    statistics are float64 on ``x``'s device; the p-value is the F survival
    function through ``scipy.special.betainc`` on the host."""
    x = _tensor(x).to(torch.float64)
    x = x.reshape(x.shape[0], -1)
    y = _tensor(y).to(device=x.device, dtype=torch.float64)
    y = y.reshape(y.shape[0], -1)
    n1, n2 = x.shape[0], y.shape[0]
    p = x.shape[1]
    if n1 + n2 - 2 <= p:
        raise ValueError("need n1 + n2 - 2 > num_features for pooled covariance")
    d = x.mean(0) - y.mean(0)
    s_pooled = ((n1 - 1) * _cov(x) + (n2 - 1) * _cov(y)) / (n1 + n2 - 2)
    s_pooled = s_pooled + 1e-9 * torch.eye(p, dtype=torch.float64, device=x.device)
    t2 = float((n1 * n2) / (n1 + n2) * d @ torch.linalg.solve(s_pooled, d))
    f_stat = t2 * (n1 + n2 - p - 1) / (p * (n1 + n2 - 2))
    dfn, dfd = p, n1 + n2 - p - 1
    # p-value from the regularized incomplete beta (F survival function).
    xbeta = dfd / (dfd + dfn * max(f_stat, 0.0))
    p_value = float(scipy.special.betainc(dfd / 2.0, dfn / 2.0, xbeta))
    return t2, f_stat, p_value


# ---------------------------------------------------------------------------
# 1-D two-sample Kolmogorov-Smirnov statistic
# ---------------------------------------------------------------------------

def _fractions(counts: torch.Tensor, total: int) -> torch.Tensor:
    """``counts / total`` in float64, correctly rounded on every device: the
    divisor is a tensor, since CUDA divides by a Python number as a product
    with its reciprocal, which can differ from numpy's quotient in the last
    bit."""
    c = counts.to(torch.float64)
    return c / torch.full_like(c, float(total))


def ks_statistic(x, y) -> float:
    """sup |F_x - F_y| over the pooled sample, on ``x``'s device; the CDFs
    are integer counts divided in float64, so the value is exact."""
    x, y = _tensor(x), _tensor(y)
    dtype = torch.promote_types(x.dtype, y.dtype)   # np.concatenate's promotion
    x = torch.sort(x.reshape(-1).to(dtype)).values
    y = torch.sort(y.reshape(-1).to(device=x.device, dtype=dtype)).values
    grid = torch.cat([x, y])
    fx = _fractions(torch.searchsorted(x, grid, right=True), x.numel())
    fy = _fractions(torch.searchsorted(y, grid, right=True), y.numel())
    return float((fx - fy).abs().max())


# ---------------------------------------------------------------------------
# Categorical / label distribution (Fig. 2a)
# ---------------------------------------------------------------------------

def label_distribution(labels, num_classes: int) -> torch.Tensor:
    """Normalized class frequencies of one block / data set (float64, on the
    labels' device)."""
    counts = torch.bincount(_tensor(labels).to(torch.int64).reshape(-1), minlength=num_classes)
    return _fractions(counts, max(int(counts.sum()), 1))


def max_label_divergence(block_labels, data_labels, num_classes: int) -> float:
    """L-inf distance between block and full-data label distributions."""
    a = label_distribution(block_labels, num_classes)
    b = label_distribution(data_labels, num_classes).to(a.device)
    return float((a - b).abs().max())
