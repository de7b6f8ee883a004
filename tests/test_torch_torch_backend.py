"""The port's ``torch`` partition backend (``two_stage_partition_torch``,
``randomize_dataset``) against the reference's ``jax`` backend
(``two_stage_partition_jax``, ``randomize_dataset``).

JAX's threefry cannot be drawn in torch, so the two never give the same
bits.  Both are held to the same contract: Definition 2 (``is_partition``),
the same shapes and dtypes, the divisibility error, and Lemma 1's
statistics at far-tail bounds.  Inputs are made from a seed with numpy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import rsp as ref_rsp
from repro.core.partition import randomize_dataset as ref_randomize
from repro.core.partition import two_stage_partition_jax as ref_two_stage_jax
from repro_torch import rsp
from repro_torch.core.partition import (
    empirical_cdf,
    is_partition,
    randomize_dataset,
    two_stage_partition_torch,
)
from repro_torch.core.types import RSPSpec
from repro_torch.data import make_nonrandom_higgs_like
from repro_torch.rsp.backends import PartitionRequest, backend_eligibility


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _corpus(n=6000, seed=0):
    x, y = make_nonrandom_higgs_like(n, seed=seed)
    return np.concatenate([x, y[:, None].astype(np.float32)], axis=1)


def _data(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "float":
        return rng.normal(size=(n, 5)).astype(np.float32)
    if kind == "int":
        return rng.integers(0, 7, size=(n,)).astype(np.int32)
    if kind == "tail":  # [N, 3, 2] records (float32: JAX without x64 has no float64)
        return rng.normal(size=(n, 3, 2)).astype(np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["float", "int", "tail"])
@pytest.mark.parametrize("K,P,permute", [(4, 4, True), (6, 3, True), (5, 2, False)])
def test_two_stage_partition_is_a_partition_like_the_reference(kind, K, P, permute):
    data = _data(kind, 60 * K * P)
    want = np.asarray(ref_two_stage_jax(
        jnp.asarray(data), jax.random.PRNGKey(3), num_blocks=K, num_original_blocks=P,
        permute_assignment=permute))
    got = two_stage_partition_torch(
        torch.from_numpy(data), _gen(3), num_blocks=K, num_original_blocks=P,
        permute_assignment=permute)
    assert tuple(got.shape) == want.shape == (K, data.shape[0] // K, *data.shape[1:])
    assert got.numpy().dtype == want.dtype == data.dtype
    assert is_partition(got, data) and is_partition(want, data)  # Definition 2


@pytest.mark.parametrize("permute", [True, False])
def test_block_k_takes_one_sub_block_of_every_original_block(permute):
    """Slice i of every RSP block comes from original block i, in both
    packages; without ``permute_assignment`` block k takes sub-block k."""
    K, P, delta = 4, 3, 25
    data = np.arange(K * P * delta, dtype=np.int64)  # row id = value
    R = K * delta
    ref = np.asarray(ref_two_stage_jax(jnp.asarray(data), jax.random.PRNGKey(1), num_blocks=K,
                                       num_original_blocks=P, permute_assignment=permute))
    got = two_stage_partition_torch(torch.from_numpy(data), _gen(1), num_blocks=K,
                                    num_original_blocks=P, permute_assignment=permute).numpy()
    for blocks in (ref, got):
        slices = blocks.reshape(K, P, delta)
        for i in range(P):
            assert ((slices[:, i] // R) == i).all()
        if not permute:
            # original block i was permuted, then cut in K runs of delta in order
            subs = [np.sort(slices[k, :, :], axis=1) for k in range(K)]
            assert all(np.array_equal(np.sort(np.concatenate([s[i] for s in subs])),
                                      np.arange(i * R, (i + 1) * R)) for i in range(P))


def test_divisibility_error_matches_the_reference():
    data = _data("float", 100)
    with pytest.raises(ValueError, match="divisible by P\\*K=12"):
        ref_two_stage_jax(jnp.asarray(data), jax.random.PRNGKey(0), num_blocks=4,
                          num_original_blocks=3)
    with pytest.raises(ValueError, match="divisible by P\\*K=12"):
        two_stage_partition_torch(torch.from_numpy(data), _gen(0), num_blocks=4,
                                  num_original_blocks=3)


@pytest.mark.parametrize("kind", ["float", "int", "tail"])
def test_randomize_dataset_permutes_rows_like_the_reference(kind):
    data = _data(kind, 500, seed=2)
    want = np.asarray(ref_randomize(jnp.asarray(data), jax.random.PRNGKey(4)))
    got = randomize_dataset(torch.from_numpy(data), _gen(4)).numpy()
    assert got.shape == want.shape == data.shape and got.dtype == want.dtype
    # one block holding every row: Definition 2 for a single block
    assert is_partition(got[None], data) and is_partition(want[None], data)
    assert not np.array_equal(got, data)
    assert np.array_equal(randomize_dataset(torch.from_numpy(data), _gen(4)).numpy(), got)


@pytest.mark.parametrize("kind", ["float", "int", "tail"])
def test_facade_torch_backend_matches_reference_jax_backend(kind):
    data = _data(kind, 2400, seed=5)
    ref = ref_rsp.partition(data, blocks=6, original_blocks=4, seed=7, backend="jax",
                            summaries=False)
    ds = rsp.partition(data, blocks=6, original_blocks=4, seed=7, backend="torch",
                       device="cpu", summaries=False)
    assert ds.backend == "torch" and ref.backend == "jax"
    want, got = np.asarray(ref.stacked()), ds.stacked()
    assert got.device.type == "cpu"
    assert tuple(got.shape) == want.shape and got.numpy().dtype == want.dtype
    assert is_partition(got, data) and is_partition(want, data)
    assert ds.spec.to_json() == ref.spec.to_json()
    again = rsp.partition(data, blocks=6, original_blocks=4, seed=7, backend="torch",
                          device="cpu", summaries=False)
    assert torch.equal(again.stacked(), got)
    other = rsp.partition(data, blocks=6, original_blocks=4, seed=8, backend="torch",
                          device="cpu", summaries=False)
    assert not torch.equal(other.stacked(), got)


def test_facade_permute_assignment_false():
    data = _data("float", 1200, seed=6)
    ref = ref_rsp.partition(data, blocks=4, seed=2, backend="jax", summaries=False,
                            permute_assignment=False)
    ds = rsp.partition(data, blocks=4, seed=2, backend="torch", device="cpu", summaries=False,
                       permute_assignment=False)
    assert is_partition(ds.stacked(), data) and is_partition(ref.stacked(), data)
    assert tuple(ds.stacked().shape) == np.asarray(ref.stacked()).shape


def test_lemma1_statistics_both_packages():
    """Class-sorted storage: every RSP block's label share, feature means
    and CDF sit near the corpus's, for both packages' jit/torch paths."""
    data = _corpus(n=20000, seed=1)
    ref = np.asarray(ref_rsp.partition(data, blocks=10, seed=5, backend="jax",
                                       summaries=False).stacked())
    got = rsp.partition(data, blocks=10, seed=5, backend="torch", device="cpu",
                        summaries=False).stacked().numpy()
    share, mean = data[:, 28].mean(), data[:, :8].mean(0)
    cdf = empirical_cdf(data[:, 0], [-1.0, 0.0, 1.0])
    for blocks in (ref, got):
        assert blocks.shape == (10, 2000, 29)
        for k in range(10):
            b = blocks[k]
            assert abs(b[:, 28].mean() - share) < 0.02
            np.testing.assert_allclose(b[:, :8].mean(0), mean, atol=0.12)
            np.testing.assert_allclose(empirical_cdf(b[:, 0], [-1.0, 0.0, 1.0]), cdf, atol=0.04)
    assert abs(data[:2000, 28].mean() - share) > 0.4  # sequential chunks fail Lemma 1


def test_lemma1_block_cdf_unbiased_over_draws():
    """E[F_k] = F: block 0's CDF averaged over 40 seeds matches the corpus's
    (the reference's ``test_lemma1_block_cdf_unbiased``, on ``torch``)."""
    data = np.random.default_rng(0).normal(size=(2000, 1)).astype(np.float32)
    thresholds = np.quantile(data, [0.1, 0.25, 0.5, 0.75, 0.9])
    accum = np.zeros(len(thresholds))
    for s in range(40):
        blocks = two_stage_partition_torch(torch.from_numpy(data), _gen(s), num_blocks=10,
                                           num_original_blocks=10)
        accum += empirical_cdf(blocks[0], thresholds)
    np.testing.assert_allclose(accum / 40, empirical_cdf(data, thresholds), atol=0.02)


def test_auto_chooses_as_before():
    data = _corpus(n=400)
    spec = RSPSpec(num_records=400, num_blocks=4, num_original_blocks=4, record_shape=(29,))
    cpu = torch.device("cpu")
    elig = backend_eligibility(PartitionRequest(data=data, spec=spec, device=cpu))
    assert elig["torch"] is None
    ints = np.arange(400 * 2).reshape(400, 2)
    spec2 = RSPSpec(num_records=400, num_blocks=4, num_original_blocks=4, record_shape=(2,))
    assert backend_eligibility(PartitionRequest(data=ints, spec=spec2, device=cpu))["torch"] is None
    assert rsp.partition(data, blocks=4, device="cpu", summaries=False).backend == "np"
    assert rsp.partition(ints, blocks=4, device="cpu", summaries=False).backend == "np"
    assert rsp.partition(torch.from_numpy(data), blocks=4, device="cpu",
                         summaries=False).backend == "np"


def test_torch_backend_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CPU-only behaviour does not apply")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rsp.partition(_data("float", 400), blocks=4, backend="torch")


def test_randomize_dataset_draws_on_the_generators_device_and_gathers_on_the_datas():
    data = torch.from_numpy(_data("int", 300))
    got = randomize_dataset(data, _gen(9))
    assert torch.equal(got, data[torch.randperm(300, generator=_gen(9))])
