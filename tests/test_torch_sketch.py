"""Partition-time sketches: the port's copy of ``rsp.sketch`` /
``rsp.summaries`` against the reference package, bit for bit (``to_dict``
equality, KLL's per-(seed, block, compaction) randomness included)."""

import numpy as np
import pytest
import torch

from repro.rsp import sketch as ref_sketch
from repro.rsp import summaries as ref_summaries
from repro_torch.rsp import sketch, summaries


def _block(n, f, seed, classes=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0.3, 1.7, size=(n, f)).astype(np.float32)
    if classes:
        x[:, -1] = rng.integers(0, classes, size=n)
    return x


@pytest.mark.parametrize(
    "n,f,classes,kw",
    [
        (500, 4, 0, {}),
        (3000, 6, 2, {}),                       # KLL compacts: RNG path exercised
        (2500, 5, 3, dict(kll_k=40, kmv_k=32, seed=9)),
        (800, 3, 2, dict(kinds=("moments",))),
    ],
)
def test_summarize_block_to_dict_is_bit_identical(n, f, classes, kw):
    x = _block(n, f, seed=n + f, classes=classes)
    label = dict(label_column=f - 1, num_classes=classes) if classes else {}
    for block_id in (0, 5):
        want = ref_summaries.summarize_block(x, block_id, **label, **kw).to_dict()
        got = summaries.summarize_block(x, block_id, **label, **kw).to_dict()
        assert got == want
        # a block given as a tensor sketches to the same dict
        got_t = summaries.summarize_block(torch.from_numpy(x), block_id, **label, **kw)
        assert got_t.to_dict() == want


def test_merged_suites_and_combines_match():
    blocks = [_block(1200, 5, seed=s, classes=2) for s in range(4)]
    kw = dict(label_column=4, num_classes=2)
    want = ref_summaries.summarize_blocks(blocks, **kw)
    got = summaries.summarize_blocks([torch.from_numpy(b) for b in blocks], **kw)
    assert sketch.merge_suites(got).to_dict() == ref_sketch.merge_suites(want).to_dict()
    a, b = summaries.combine_summaries(got), ref_summaries.combine_summaries(want)
    for field in ("count", "mean", "m2", "min", "max"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    w = [0.5, 1.0, 2.0, 0.25]
    a = summaries.combine_summaries(got, weights=w, total_count=4800)
    b = ref_summaries.combine_summaries(want, weights=w, total_count=4800)
    np.testing.assert_array_equal(a.mean, b.mean)
    np.testing.assert_array_equal(a.m2, b.m2)
    assert summaries.max_divergence_from_summaries(got) == (
        ref_summaries.max_divergence_from_summaries(want)
    )
    assert sketch.sketch_schema_descriptor(got) == ref_sketch.sketch_schema_descriptor(want)


def test_sketch_answers_match():
    x = _block(4000, 3, seed=21)
    got = summaries.summarize_block(x, 2)
    want = ref_summaries.summarize_block(x, 2)
    np.testing.assert_array_equal(
        got.get("kll").quantile([0.05, 0.5, 0.95]), want.get("kll").quantile([0.05, 0.5, 0.95])
    )
    np.testing.assert_array_equal(got.get("distinct").estimate(), want.get("distinct").estimate())
    assert got.get("kll").rank_error_bound() == want.get("kll").rank_error_bound()


def test_v1_summaries_upgrade_the_same_way():
    x = _block(600, 4, seed=3, classes=2)
    v1 = ref_summaries.BlockSummary(
        block_id=1, count=600,
        mean=x.astype(np.float64).mean(0), m2=x.astype(np.float64).var(0) * 600,
        min=x.min(0).astype(np.float64), max=x.max(0).astype(np.float64),
        label_hist=np.bincount(x[:, 3].astype(np.int64), minlength=2),
    ).to_dict()
    got = sketch.load_summaries([v1])[0]
    want = ref_sketch.load_summaries([v1])[0]
    assert got.to_dict() == want.to_dict()
    assert sorted(got.sketches) == sorted(want.sketches)


@pytest.mark.parametrize(
    "na,nb,values,k",
    [(0, 0, 10, 8), (0, 500, 10**9, 256), (40, 900, 30, 16), (256, 3000, 10**6, 256), (5, 3, 4, 64)],
)
def test_kmv_union_equals_union1d(na, nb, values, k):
    rng = np.random.default_rng(na + nb)
    a = np.unique(rng.integers(0, values, size=na, dtype=np.uint64))
    b = rng.integers(0, values, size=nb, dtype=np.uint64)   # duplicates when values is small
    got = sketch._union_smallest(a, b, k)
    want = np.union1d(a, b)[:k]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
