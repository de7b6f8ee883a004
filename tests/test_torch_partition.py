"""Algorithm 1 in the port: the ``np`` backend bit for bit against the
reference, the ``cuda`` backend (its plain version on the CPU) against
Definition 2 and Lemma 1, and the synthetic corpus generator."""

import numpy as np
import pytest
import torch

from repro import rsp as ref_rsp
from repro.core.partition import two_stage_partition_np as ref_two_stage
from repro.core.types import RSPSpec as RefSpec
from repro.data.synthetic import make_higgs_like as ref_higgs
from repro.data.synthetic import make_nonrandom_higgs_like as ref_nonrandom
from repro_torch import rsp
from repro_torch.core.partition import empirical_cdf, is_partition, two_stage_partition_np
from repro_torch.core.types import RSPSpec
from repro_torch.data import make_higgs_like, make_nonrandom_higgs_like
from repro_torch.rsp.backends import PartitionRequest, backend_eligibility


def _corpus(n=6000, seed=0):
    x, y = make_nonrandom_higgs_like(n, seed=seed)
    return np.concatenate([x, y[:, None].astype(np.float32)], axis=1)


@pytest.mark.parametrize("K,P,permute", [(5, 5, True), (4, 6, True), (6, 3, False)])
def test_np_partition_is_bit_identical_to_reference(K, P, permute):
    data = _corpus(n=3600)
    kw = dict(num_records=3600, num_blocks=K, num_original_blocks=P, record_shape=(29,), seed=11)
    want = ref_two_stage(data, RefSpec(**kw), permute_assignment=permute)
    got = two_stage_partition_np(data, RSPSpec(**kw), permute_assignment=permute)
    np.testing.assert_array_equal(got, want)
    ds = rsp.partition(data, blocks=K, original_blocks=P, seed=11, backend="np",
                       permute_assignment=permute, device="cpu")
    np.testing.assert_array_equal(ds.stacked().numpy(), want)
    assert ds.spec.to_json() == RefSpec(**kw).to_json()


def test_np_partition_facade_matches_reference_facade():
    data = _corpus(n=2500)
    ref = ref_rsp.partition(data, blocks=5, seed=2, num_classes=2, backend="np")
    ds = rsp.partition(data, blocks=5, seed=2, num_classes=2, backend="np", device="cpu")
    np.testing.assert_array_equal(ds.stacked().numpy(), np.asarray(ref.stacked()))
    assert [s.to_dict() for s in ds.summaries] == [s.to_dict() for s in ref.summaries]
    assert ds.label_divergence() == ref.label_divergence()


def test_cuda_backend_plain_version_is_a_random_sample_partition():
    data = _corpus(n=20000, seed=1)
    ds = rsp.partition(data, blocks=10, seed=5, num_classes=2, backend="cuda", device="cpu")
    assert ds.backend == "cuda"
    blocks = ds.stacked()
    assert blocks.shape == (10, 2000, 29)
    assert is_partition(blocks, data)                       # Definition 2
    # Lemma 1: every block's label share and feature means sit near the corpus's
    corpus_share = data[:, 28].mean()
    corpus_mean = data[:, :8].mean(0)
    for k in range(10):
        b = blocks[k].numpy()
        assert abs(b[:, 28].mean() - corpus_share) < 0.02
        np.testing.assert_allclose(b[:, :8].mean(0), corpus_mean, atol=0.12)
        np.testing.assert_allclose(empirical_cdf(b[:, 0], [-1.0, 0.0, 1.0]),
                                   empirical_cdf(data[:, 0], [-1.0, 0.0, 1.0]), atol=0.04)
    assert ds.label_divergence() < 0.02
    # class-sorted storage chunked sequentially is the failure Lemma 1 avoids
    assert abs(data[:2000, 28].mean() - corpus_share) > 0.4


def test_cuda_backend_is_seeded_and_differs_from_np():
    data = _corpus(n=4000)
    a = rsp.partition(data, blocks=4, seed=9, backend="cuda", device="cpu", summaries=False)
    b = rsp.partition(data, blocks=4, seed=9, backend="cuda", device="cpu", summaries=False)
    c = rsp.partition(data, blocks=4, seed=9, backend="np", device="cpu", summaries=False)
    assert torch.equal(a.stacked(), b.stacked())
    assert not torch.equal(a.stacked(), c.stacked())
    assert is_partition(c.stacked(), data)


def test_backend_predicates_and_auto_selection():
    data = _corpus(n=400)
    spec = RSPSpec(num_records=400, num_blocks=4, num_original_blocks=4, record_shape=(29,))
    cpu = torch.device("cpu")
    elig = backend_eligibility(PartitionRequest(data=data, spec=spec, device=cpu))
    assert elig == {"np": None, "cuda": None}
    ints = np.arange(400 * 2).reshape(400, 2)
    spec2 = RSPSpec(num_records=400, num_blocks=4, num_original_blocks=4, record_shape=(2,))
    reason = backend_eligibility(PartitionRequest(data=ints, spec=spec2, device=cpu))["cuda"]
    assert "float" in reason
    reason = backend_eligibility(
        PartitionRequest(data=data, spec=spec, device=cpu, permute_assignment=False))["cuda"]
    assert reason is not None
    # on the CPU, auto keeps the bit-exact numpy path; an int corpus too
    assert rsp.partition(data, blocks=4, device="cpu", summaries=False).backend == "np"
    assert rsp.partition(ints, blocks=4, device="cpu", summaries=False).backend == "np"
    with pytest.raises(ValueError, match="float"):
        rsp.partition(ints, blocks=4, backend="cuda", device="cpu")


def test_partition_accepts_a_tensor():
    data = _corpus(n=900)
    a = rsp.partition(torch.from_numpy(data), blocks=3, seed=1, device="cpu", summaries=False)
    b = rsp.partition(data, blocks=3, seed=1, device="cpu", summaries=False)
    assert torch.equal(a.stacked(), b.stacked()) and a.spec == b.spec


@pytest.mark.parametrize("n,kw", [(1000, {}), (777, dict(num_features=5, class_sep=2.0, seed=3))])
def test_synthetic_corpus_matches_reference(n, kw):
    for got, want in zip(make_higgs_like(n, **kw), ref_higgs(n, **kw)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(make_nonrandom_higgs_like(n, **kw), ref_nonrandom(n, **kw)):
        np.testing.assert_array_equal(got, want)
