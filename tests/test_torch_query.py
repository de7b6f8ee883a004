"""The slice as a whole: partition -> save -> open -> query in both
packages at the same seed.

With ``sketch_impl="ref"`` the port runs the reference's numpy oracles on
host copies of the same blocks, so every estimate, CI and ``blocks_read`` is
exactly the reference's.  With ``sketch_impl="torch"`` (the kernels' plain
versions) the answers agree with the reference's float32 jit path within
1e-5 and read the same blocks.
"""

import json
import math

import numpy as np
import pytest
import torch

from repro import rsp as ref_rsp
from repro_torch import rsp
from repro_torch.data import make_nonrandom_higgs_like

K = 10


def _corpus(n=12000, seed=0):
    x, y = make_nonrandom_higgs_like(n, seed=seed)
    return np.concatenate([x, y[:, None].astype(np.float32)], axis=1)


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    data = _corpus()
    ref_dir = str(tmp_path_factory.mktemp("ref"))
    port_dir = str(tmp_path_factory.mktemp("port"))
    ref = ref_rsp.partition(data, blocks=K, seed=7, num_classes=2, backend="np").save(ref_dir)
    rsp.partition(data, blocks=K, seed=7, num_classes=2, backend="np", device="cpu").save(port_dir)
    return {"data": data, "ref": ref, "ref_dir": ref_dir, "port_dir": port_dir}


def _queries(mod):
    return {
        "mean_p95": (["mean", "p95"], dict(target_rel_err=0.05, use_sketches=False)),
        "where_columns": (["mean", "var"], dict(where="c0 > 0.5", columns=(0, 3, 28),
                                               use_sketches=False)),
        "where_grouped": (["mean", mod.Aggregate("count", by_label=True)],
                          dict(where=["c1 < 1.0", "c2 >= -1.5"], use_sketches=False,
                               target_rel_err=0.2)),
        "by_label": (mod.Aggregate("mean", by_label=True), dict(use_sketches=False)),
        "quantiles": (["p50", "histogram", mod.Aggregate("quantile", q=0.9, feature=2)],
                      dict(use_sketches=False, max_blocks=6)),
        "weighted": (["mean", "sum"], dict(policy="weighted", max_blocks=5, use_sketches=False)),
        "query_aware": ("mean", dict(policy="query_aware", where="c0 > 1.0",
                                     target_rel_err=0.1, use_sketches=False)),
        "distinct": (["distinct", "mean"], dict(where="c3 < 0.0", use_sketches=False,
                                                max_blocks=3)),
        "sketch_only": (["mean", "var", "count", "p90", "distinct"], dict()),
        "sketch_count_by_label": (mod.Aggregate("count", by_label=True), dict()),
    }


def _assert_same(got, want, *, rtol=0.0, atol=0.0):
    assert got.blocks_read == want.blocks_read
    assert got.total_blocks == want.total_blocks
    assert got.from_sketches == want.from_sketches
    assert got.converged == want.converged
    if want.selectivity is None:
        assert got.selectivity is None
    else:
        assert got.selectivity == pytest.approx(want.selectivity, rel=rtol or 1e-15)
    assert [a.name for a in got.aggregates] == [a.name for a in want.aggregates]
    for a, b in zip(got.aggregates, want.aggregates):
        for field in ("estimate", "ci_lo", "ci_hi"):
            x, y = getattr(a, field), getattr(b, field)
            if y is None:
                assert x is None
                continue
            if rtol == 0.0:
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y), err_msg=a.name)
            else:
                np.testing.assert_allclose(np.asarray(x, np.float64), np.asarray(y, np.float64),
                                           rtol=rtol, atol=atol, err_msg=a.name)
        if rtol == 0.0:
            assert a.rel_err == b.rel_err or (math.isnan(a.rel_err) and math.isnan(b.rel_err))


@pytest.mark.parametrize("name", sorted(_queries(rsp)))
def test_ref_impl_answers_exactly_like_reference(stores, name):
    ref = ref_rsp.open(stores["ref_dir"])
    port = rsp.open(stores["port_dir"], device="cpu")
    aggs_r, kw = _queries(ref_rsp)[name]
    aggs_p, _ = _queries(rsp)[name]
    want = ref.query(aggs_r, sketch_impl="ref", **kw)
    got = port.query(aggs_p, sketch_impl="ref", **kw)
    _assert_same(got, want)


@pytest.mark.parametrize("name", ["mean_p95", "where_columns", "where_grouped", "by_label",
                                  "quantiles", "query_aware"])
def test_torch_impl_agrees_with_reference_float32_path(stores, name):
    ref = ref_rsp.open(stores["ref_dir"])
    port = rsp.open(stores["port_dir"], device="cpu")
    aggs_r, kw = _queries(ref_rsp)[name]
    aggs_p, _ = _queries(rsp)[name]
    want = ref.query(aggs_r, sketch_impl="jax", **kw)
    got = port.query(aggs_p, sketch_impl="torch", **kw)
    _assert_same(got, want, rtol=1e-5, atol=1e-6)
    assert got.blocks_read >= 1


def test_query_stream_matches_reference(stores):
    ref = ref_rsp.open(stores["ref_dir"])
    port = rsp.open(stores["port_dir"], device="cpu")
    kw = dict(target_rel_err=0.02, use_sketches=False, sketch_impl="ref", confidence=0.99)
    want = list(ref.query_stream(["mean", "p25"], **kw))
    got = list(port.query_stream(["mean", "p25"], **kw))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _assert_same(g, w)
    assert [s.block_id for s in got[-1].trace.steps] == [s.block_id for s in want[-1].trace.steps]


def test_from_arrays_carries_a_reference_dataset_across(stores):
    ref = stores["ref"]
    port = rsp.from_arrays(
        json.loads(ref.spec.to_json()),
        np.asarray(ref.stacked()),
        [s.to_dict() for s in ref.summaries],
        num_classes=ref.num_classes,
        label_column=ref.label_column,
        device="cpu",
    )
    assert port.spec.to_json() == ref.spec.to_json()
    assert isinstance(port.block(0), torch.Tensor)
    for name in ("mean_p95", "where_columns", "by_label", "sketch_only"):
        aggs_r, kw = _queries(ref_rsp)[name]
        aggs_p, _ = _queries(rsp)[name]
        _assert_same(port.query(aggs_p, sketch_impl="ref", **kw),
                     ref.query(aggs_r, sketch_impl="ref", **kw))
    m, r = port.moments(g=4, seed=1), ref.moments(g=4, seed=1)
    np.testing.assert_array_equal(m.mean, r.mean)
    assert port.sample(3, seed=2, policy="stratified") == ref.sample(3, seed=2, policy="stratified")


def test_grouped_class_sketches_match_between_impls(stores):
    # the unplanned grouped path: ref splits a host copy per class; torch
    # runs the plan pass with group_by = label column -- same fields
    from repro_torch.rsp.query import Query, QueryExecutor

    port = rsp.open(stores["port_dir"], device="cpu")
    block = port.block(3).clone()
    block[:200, 28] = 5.0                        # labels outside [0, G)
    block[200:, 28] = 1.0                        # class 0 empty
    lo = block.amin(0).double().numpy() - 1e-3
    hi = block.amax(0).double().numpy() + 1e-3
    ex = QueryExecutor(port, Query(aggregates=(rsp.parse_aggregate("mean"),)))
    for needs_hist in (False, True):
        bins = 16 if needs_hist else 0
        kw = dict(bins=bins) if not needs_hist else dict(bins=bins, lo=lo, hi=hi)
        ref_cls = ex._class_sketches(block, "ref", bins, kw)
        got_cls = ex._class_sketches(block, "torch", bins, kw)
        assert [s.count for s in got_cls] == [s.count for s in ref_cls] == [0.0, 1000.0]
        empty_r, empty_g = ref_cls[0], got_cls[0]
        assert empty_g.lo is None and empty_r.lo is None
        np.testing.assert_array_equal(empty_g.min, empty_r.min)
        if needs_hist:
            np.testing.assert_array_equal(empty_g.hist, empty_r.hist)
        else:
            assert empty_g.hist is None and empty_r.hist is None
        np.testing.assert_allclose(got_cls[1].mean, ref_cls[1].mean, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got_cls[1].m2, ref_cls[1].m2, rtol=1e-5)
        if needs_hist:
            assert got_cls[1].hist.sum() == ref_cls[1].hist.sum()
            np.testing.assert_array_equal(got_cls[1].lo, ref_cls[1].lo)
