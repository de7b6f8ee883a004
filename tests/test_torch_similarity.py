"""The port's Sec.-7 similarity toolkit against the reference package's.

Each reference test of ``tests/test_similarity.py`` (and the similarity
tests of ``tests/test_engine.py``) has its counterpart here on host tensors,
and the two packages are held side by side on the same numpy inputs:
MMD^2, the median-heuristic bandwidth and ``mmd_block_vs_data`` within
1e-5 (both float32; MMD^2 as ``|a - b| <= 1e-5 (1 + |b|)``), Hotelling's
statistics within 1e-5 relative and its p-value within 1e-5 of the float64
F survival function (the reference evaluates ``betainc`` in float32, whose
error reaches 1.3e-5, so its own p-value is held within 5e-5), KS and the
label functions exactly, and ``ds.similarity`` on in-memory and
store-backed datasets as the metrics.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch

from repro import rsp as ref_rsp
from repro.core import similarity as ref_sim
from repro_torch import rsp
from repro_torch.core import RSPSpec, RSPStore, two_stage_partition_np
from repro_torch.core.similarity import (
    hotelling_t2,
    ks_statistic,
    label_distribution,
    max_label_divergence,
    median_heuristic_gamma,
    mmd2_rbf,
    mmd_block_vs_data,
)
from repro_torch.data import make_higgs_like, make_nonrandom_higgs_like

TOL = 1e-5
PVALUE_F32_TOL = 5e-5   # the reference evaluates betainc in float32


def _mmd_close(got, want):
    assert abs(got - want) <= TOL * (1.0 + abs(want)), (got, want)


def _blocks_and_data(shuffle: bool):
    maker = make_higgs_like if shuffle else make_nonrandom_higgs_like
    x, y = maker(8000, seed=3, class_sep=2.0)
    return np.concatenate([x, y[:, None].astype(np.float32)], axis=1)


# ---------------------------------------------------------------------------
# The reference's tests, on host tensors
# ---------------------------------------------------------------------------

def test_mmd_rsp_block_small_sequential_block_large():
    data = _blocks_and_data(shuffle=False)  # class-sorted
    seq_block = torch.from_numpy(data[:800])  # first sequential chunk: all class 0
    spec = RSPSpec(num_records=8000, num_blocks=10, num_original_blocks=10, seed=1)
    rsp_block = torch.from_numpy(two_stage_partition_np(data, spec)[0])
    full = torch.from_numpy(data)
    mmd_seq = mmd_block_vs_data(seq_block, full, seed=0)
    mmd_rsp = mmd_block_vs_data(rsp_block, full, seed=0)
    assert mmd_rsp < mmd_seq / 5
    assert abs(mmd_rsp) < 5e-3


def test_mmd_identical_distributions_near_zero():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(400, 8)).astype(np.float32))
    y = torch.from_numpy(rng.normal(size=(400, 8)).astype(np.float32))
    gamma = median_heuristic_gamma(x)
    assert abs(float(mmd2_rbf(x, y, gamma))) < 0.01


def test_mmd_shifted_distributions_large():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(400, 8)).astype(np.float32))
    y = torch.from_numpy((rng.normal(size=(400, 8)) + 2.0).astype(np.float32))
    gamma = median_heuristic_gamma(x)
    assert float(mmd2_rbf(x, y, gamma)) > 0.1


def test_hotelling_t2_detects_mean_shift():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(300, 5)))
    y_same = torch.from_numpy(rng.normal(size=(300, 5)))
    y_shift = torch.from_numpy(rng.normal(size=(300, 5)) + 0.5)
    _, _, p_same = hotelling_t2(x, y_same)
    _, _, p_shift = hotelling_t2(x, y_shift)
    assert p_same > 0.01       # fail to reject H0
    assert p_shift < 1e-6      # reject decisively


def test_hotelling_t2_rsp_block_vs_data():
    data = _blocks_and_data(shuffle=True)
    spec = RSPSpec(num_records=8000, num_blocks=10, num_original_blocks=10, seed=4)
    block = torch.from_numpy(two_stage_partition_np(data, spec)[3])
    _, _, p = hotelling_t2(block[:, :-1], torch.from_numpy(data[:500, :-1]))
    assert p > 0.001  # block mean indistinguishable from data mean


def test_ks_statistic_basics():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.normal(size=5000))
    b = torch.from_numpy(rng.normal(size=5000))
    c = torch.from_numpy(rng.normal(loc=1.0, size=5000))
    assert ks_statistic(a, b) < 0.05
    assert ks_statistic(a, c) > 0.3


def test_label_distribution_fig2a():
    """Fig 2a: label frequencies in RSP blocks track the whole data set."""
    x, y = make_nonrandom_higgs_like(6000, seed=5)
    data = np.concatenate([x, y[:, None].astype(np.float32)], axis=1)
    spec = RSPSpec(num_records=6000, num_blocks=10, num_original_blocks=10, seed=2)
    blocks = torch.from_numpy(two_stage_partition_np(data, spec))
    yt = torch.from_numpy(y)
    full = label_distribution(yt, 2)
    for k in range(10):
        div = max_label_divergence(blocks[k][:, -1], yt, 2)
        assert div < 0.06, f"block {k} diverges {div}"
    # sequential chunking of the sorted data fails the same check
    seq = torch.from_numpy(data[:600])
    assert max_label_divergence(seq[:, -1], yt, 2) > 0.4
    assert np.isclose(float(full.sum()), 1.0)


def test_corpus_reference_excludes_probe(tmp_path):
    # constant-valued blocks make self-inclusion visible in the reference
    k, n = 4, 64
    blocks = np.stack([np.full((n, 1), float(i), np.float32) for i in range(k)])
    spec = RSPSpec(num_records=k * n, num_blocks=k, num_original_blocks=1, record_shape=(1,))
    store = RSPStore(str(tmp_path / "c"))
    store.write_partition(blocks, spec)
    ds = rsp.RSPDataset(spec, store=store, device="cpu")
    for probe in range(k):
        ref = ds._corpus_reference(4096, seed=0, exclude=probe)
        assert ref.device.type == "cpu"
        assert float(probe) not in set(torch.unique(ref).tolist())
        assert ref.shape[0] >= n  # still a usable reference


def _labelled(n=2048, f=3, seed=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    y = (rng.random(n) < 0.5).astype(np.float32)
    return np.concatenate([x, y[:, None]], axis=1)


def test_similarity_detects_outlier_block(tmp_path):
    data = _labelled()
    rsp.partition(data, blocks=8, seed=2, backend="np", num_classes=2,
                  device="cpu").save(str(tmp_path / "c"))
    got = rsp.open(str(tmp_path / "c"), device="cpu")
    # corrupt one stored block far away from the corpus
    bad = got.block(5).numpy() + 50.0
    np.save(str(tmp_path / "c" / "block_00005.npy"), bad)
    got2 = rsp.open(str(tmp_path / "c"), device="cpu")
    sane = got2.similarity(1, metric="mmd", seed=0)
    outlier = got2.similarity(5, metric="mmd", seed=0)
    assert outlier > sane + 0.1


# ---------------------------------------------------------------------------
# Side by side with the reference on the same numpy inputs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,f,shift", [(400, 400, 8, 0.0), (300, 500, 29, 0.7), (64, 32, 3, 2.0)],
                         ids=["same", "shifted-29", "small"])
def test_mmd2_and_gamma_match_the_reference(m, n, f, shift):
    rng = np.random.default_rng(m + n)
    x = rng.normal(size=(m, f)).astype(np.float32)
    y = (rng.normal(size=(n, f)) + shift).astype(np.float32)
    gamma = median_heuristic_gamma(torch.from_numpy(x))
    want_gamma = ref_sim.median_heuristic_gamma(x)
    assert abs(gamma - want_gamma) <= TOL * abs(want_gamma)
    got = float(mmd2_rbf(torch.from_numpy(x), torch.from_numpy(y), want_gamma))
    want = float(ref_sim.mmd2_rbf(jnp.asarray(x), jnp.asarray(y), jnp.asarray(want_gamma)))
    _mmd_close(got, want)


def test_median_gamma_casts_float64_like_the_reference():
    x = np.random.default_rng(9).normal(size=(700, 5))          # float64, > 512 rows
    gamma = median_heuristic_gamma(torch.from_numpy(x))
    want = ref_sim.median_heuristic_gamma(x)
    assert abs(gamma - want) <= TOL * abs(want)
    assert median_heuristic_gamma(x) == gamma                   # numpy input, same path


@pytest.mark.parametrize("shuffle,seed", [(True, 0), (False, 3)], ids=["rsp", "sorted"])
def test_mmd_block_vs_data_matches_the_reference(shuffle, seed):
    data = _blocks_and_data(shuffle=shuffle)
    block = data[:1500]
    got = mmd_block_vs_data(torch.from_numpy(block), torch.from_numpy(data), seed=seed)
    want = ref_sim.mmd_block_vs_data(block, data, seed=seed)
    _mmd_close(got, want)


@pytest.mark.parametrize("shift", [0.0, 0.1, 0.5])
def test_hotelling_matches_the_reference(shift):
    rng = np.random.default_rng(int(shift * 10) + 4)
    x = rng.normal(size=(300, 6))
    y = rng.normal(size=(250, 6)) + shift
    got = hotelling_t2(torch.from_numpy(x), torch.from_numpy(y))
    want = ref_sim.hotelling_t2(x, y)
    for g, w in zip(got[:2], want[:2]):
        assert abs(g - w) <= TOL * abs(w)
    # the p-value: within 1e-5 of the F survival function of the reference's
    # statistic in float64, and within the reference's float32 betainc
    # error (1.3e-5 at p = 0.503) of its own value
    dfn, dfd = x.shape[1], x.shape[0] + y.shape[0] - x.shape[1] - 1
    assert abs(got[2] - scipy.special.fdtrc(dfn, dfd, want[1])) <= TOL
    assert abs(got[2] - want[2]) <= PVALUE_F32_TOL
    with pytest.raises(ValueError, match="pooled covariance"):
        hotelling_t2(torch.zeros(3, 5), torch.zeros(2, 5))


def test_ks_and_labels_equal_the_reference_exactly():
    rng = np.random.default_rng(11)
    a = rng.normal(size=3001).astype(np.float32)
    b = np.round(rng.normal(0.2, 1.3, size=2000), 2).astype(np.float32)   # ties
    assert ks_statistic(torch.from_numpy(a), torch.from_numpy(b)) == ref_sim.ks_statistic(a, b)
    c = rng.normal(size=500)                                              # mixed dtypes
    assert ks_statistic(torch.from_numpy(a), torch.from_numpy(c)) == ref_sim.ks_statistic(a, c)
    labels = rng.integers(0, 4, size=999).astype(np.float32)
    data_labels = rng.integers(0, 4, size=5000).astype(np.float32)
    np.testing.assert_array_equal(label_distribution(torch.from_numpy(labels), 4).numpy(),
                                  ref_sim.label_distribution(labels, 4))
    assert (max_label_divergence(torch.from_numpy(labels), torch.from_numpy(data_labels), 4)
            == ref_sim.max_label_divergence(labels, data_labels, 4))


def _same_similarity(ds, ref_ds, k, feature=1):
    for metric in ("mmd", "ks", "labels"):
        got = ds.similarity(k, metric=metric, feature=feature, seed=k)
        want = ref_ds.similarity(k, metric=metric, feature=feature, seed=k)
        if metric == "mmd":
            _mmd_close(got, want)
        else:
            assert got == want, (metric, got, want)


def test_dataset_similarity_matches_the_reference(tmp_path):
    data = _labelled(n=4096, f=5, seed=7)
    ds = rsp.partition(data, blocks=8, seed=3, backend="np", num_classes=2, device="cpu")
    ref_ds = ref_rsp.partition(data, blocks=8, seed=3, backend="np", num_classes=2)
    for k in (0, 5):                                   # in memory: the whole partition
        _same_similarity(ds, ref_ds, k)
    ref_ds.save(str(tmp_path / "c"))                   # store-backed: a bounded sample
    ds = rsp.open(str(tmp_path / "c"), device="cpu")
    ref_ds = ref_rsp.open(str(tmp_path / "c"))
    for k in (0, 3, 7):
        _same_similarity(ds, ref_ds, k)
        np.testing.assert_array_equal(
            ds._corpus_reference(4096, seed=k, exclude=k).numpy(),
            np.asarray(ref_ds._corpus_reference(4096, seed=k, exclude=k)))
    with pytest.raises(ValueError, match="unknown metric"):
        ds.similarity(0, metric="cosine")
