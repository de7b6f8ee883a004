"""The port's block-level estimation (Sec. 8) against the reference package's.

``block_moments`` runs the ``block_sketch`` kernel's plain version on a CPU
tensor (the kernel itself on a CUDA tensor, ``tests/test_torch_cuda.py``);
the reference runs its float32 jit ``_block_moments``.  Both are float32,
so every moment is held within 1e-5 relative (the ROADMAP's tolerance for
moments), the estimators' histories too, and the plateau stop falls on the
same block.  ``ds.estimator`` and ``ds.estimate`` read the same blocks in
both packages (same seed, same sampler) and agree within 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import rsp as ref_rsp
from repro.core import estimators as ref_est
from repro_torch import rsp
from repro_torch.core.estimators import (
    BlockLevelEstimator,
    batched_block_moments,
    block_moments,
    combine_moments,
    streaming_estimate,
)
from repro_torch.rsp.engine import BlockExecutor, MemoryFetcher

RTOL = 1e-5
K = 12


def _close(got, want, atol=1e-6):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=RTOL, atol=atol)


def _block(n, f, seed, *, far=False, shape=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(1.5, 2.0, size=(n, f)).astype(np.float32)
    if far:  # a column whose mean is far from 0: a one-pass M2 loses it
        x[:, 0] = (1.0e4 + rng.normal(0.0, 1.0, size=n)).astype(np.float32)
    return x if shape is None else x.reshape(n, *shape)


def _same_moments(got, want):
    assert got.count == want.count
    for field in ("mean", "m2", "min", "max"):
        g, w = getattr(got, field), getattr(want, field)
        assert np.asarray(g).shape == np.asarray(w).shape
        _close(g, w, atol=1e-6 * max(1.0, float(np.max(np.abs(w)))))


@pytest.mark.parametrize("n,f,far,shape", [
    (1000, 5, False, None), (777, 29, True, None), (512, 6, False, (2, 3)), (3, 2, True, None),
], ids=["plain", "far-mean", "records-2x3", "three-rows"])
def test_block_moments_match_the_reference(n, f, far, shape):
    x = _block(n, f, seed=n, far=far, shape=shape)
    got = block_moments(torch.from_numpy(x))
    want = ref_est.block_moments(jnp.asarray(x))
    _same_moments(got, want)
    assert got.mean.dtype == np.float32
    if far:   # m2 of the shifted column is the variance of its noise, not 0
        _close(got.m2[0], float(np.var(x[:, 0].astype(np.float64)) * n), atol=0)


def test_combined_moments_are_exact_against_the_reference():
    a, b = _block(500, 4, 1), _block(300, 4, 2, far=True)
    got = combine_moments(block_moments(torch.from_numpy(a)), block_moments(torch.from_numpy(b)))
    want = ref_est.combine_moments(ref_est.block_moments(jnp.asarray(a)),
                                   ref_est.block_moments(jnp.asarray(b)))
    _same_moments(got, want)
    full = np.concatenate([a, b]).astype(np.float64)
    _close(got.mean, full.mean(0))
    _close(got.std, full.std(0, ddof=1), atol=1e-5)


def test_batched_block_moments_match_the_reference():
    blocks = np.stack([_block(400, 3, s) for s in range(5)]).reshape(5, 400, 3)
    mean, std = batched_block_moments(torch.from_numpy(blocks))
    ref_mean, ref_std = ref_est.batched_block_moments(jnp.asarray(blocks))
    assert mean.shape == (5, 3) and std.shape == (5, 3)
    _close(mean.numpy(), np.asarray(ref_mean))
    _close(std.numpy(), np.asarray(ref_std))


@pytest.mark.parametrize("rel_tol", [None, 3e-3, 1e-9], ids=["all", "plateau", "never"])
def test_estimator_history_and_plateau_match_the_reference(rel_tol):
    rng = np.random.default_rng(4)
    blocks = rng.normal(3.0, 1.0, size=(K, 600, 4)).astype(np.float32)
    got = BlockLevelEstimator().consume((torch.from_numpy(b) for b in blocks), rel_tol=rel_tol)
    want = ref_est.BlockLevelEstimator().consume((jnp.asarray(b) for b in blocks),
                                                 rel_tol=rel_tol)
    assert got.blocks_seen == want.blocks_seen
    if rel_tol == 3e-3:
        assert 3 < got.blocks_seen < K, "the plateau should stop the scan early"
    assert len(got.history_mean) == len(want.history_mean) == got.blocks_seen
    for gm, wm, gs, ws in zip(got.history_mean, want.history_mean, got.history_std,
                              want.history_std):
        _close(gm, wm)
        _close(gs, ws)
    _same_moments(got.stats, want.stats)
    assert got.converged(3e-3) == want.converged(3e-3)
    with pytest.raises(ValueError, match="no blocks"):
        BlockLevelEstimator().stats


def test_streaming_estimate_folds_an_executor_stream():
    rng = np.random.default_rng(5)
    blocks = rng.normal(size=(K, 200, 3)).astype(np.float32)
    with BlockExecutor(MemoryFetcher(blocks, device="cpu"), prefetch=2) as ex:
        est = streaming_estimate(ex, [3, 1, 4, 1, 5], impl="torch")
        seen = ex.stats().accesses
    assert est.blocks_seen == 5 and seen == 5
    want = ref_est.streaming_estimate(
        _RefExecutor(blocks), [3, 1, 4, 1, 5])
    _same_moments(est.stats, want.stats)


class _RefExecutor:
    def __init__(self, blocks):
        self.blocks = blocks

    def map_blocks(self, fn, ids):
        return (jnp.asarray(self.blocks[i]) for i in ids)


@pytest.fixture(scope="module")
def datasets():
    rng = np.random.default_rng(7)
    data = rng.normal(2.0, 1.5, size=(K * 480, 5)).astype(np.float32)
    # far from 0 for a one-pass M2 (float32 x^2 sums lose it at mean / std
    # ~ 330), but not so far that the float32 rounding of each block's mean
    # (half an ulp) dominates the Chan merge's between-block term: at 5e3
    # that alone moves the merged M2 by ~3e-5 relative, in either package
    data[:, 1] += 5.0e2
    data[:, -1] = rng.integers(0, 3, size=data.shape[0])
    port = rsp.partition(data, blocks=K, seed=3, num_classes=3, backend="np", device="cpu")
    ref = ref_rsp.partition(data, blocks=K, seed=3, num_classes=3, backend="np")
    yield port, ref
    port.close()
    ref.close()


@pytest.mark.parametrize("kw", [dict(), dict(g=5, seed=2), dict(ids=[0, 7, 3]),
                                dict(rel_tol=1e-3)], ids=["all", "g5", "ids", "rel_tol"])
def test_dataset_estimator_matches_the_reference(datasets, kw):
    port, ref = datasets
    got = port.estimator(**kw)
    want = ref.estimator(**kw)
    assert got.blocks_seen == want.blocks_seen
    _same_moments(got.stats, want.stats)
    for gm, wm in zip(got.history_mean, want.history_mean):
        _close(gm, wm)


@pytest.mark.parametrize("policy,g", [("uniform", None), ("uniform", 4), ("weighted", 6),
                                      ("stratified", 6)])
def test_dataset_estimate_matches_the_reference(datasets, policy, g):
    port, ref = datasets
    got = port.estimate(lambda b: b.double().mean(0), g, seed=9, policy=policy)
    want = ref.estimate(lambda b: np.asarray(b, np.float64).mean(0), g, seed=9, policy=policy)
    assert got.shape == (5,)
    _close(got, want)
    # every block's statistic is a torch tensor on the dataset's device
    seen = []
    port.estimate(lambda b: seen.append(b.device) or b.sum(), 2)
    assert seen == [torch.device("cpu")] * 2


def test_non_uniform_estimate_needs_g(datasets):
    port, _ = datasets
    with pytest.raises(ValueError, match="need g"):
        port.estimate(lambda b: b.mean(), policy="weighted")
