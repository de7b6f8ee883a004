"""The port's kernels (plain PyTorch versions on the CPU) against the
reference package's Pallas kernels in interpret mode and its numpy/jit
paths, on the same numpy inputs.

Tolerances are the reference's own: shuffles and histograms exact (both
sides bin in float32 with the same ``(x - lo) * inv_width`` rule), moments
within 1e-5.  The CUDA kernels themselves run only on a card: their tests
are in ``test_torch_cuda.py``, and ``chip_smoke.py`` holds each kernel
against these plain versions at the main path's shapes.
"""

import numpy as np
import pytest
import torch

from repro.kernels.block_sketch import block_sketch as ref_block_sketch
from repro.kernels.plan import QueryPlan as RefQueryPlan
from repro.kernels.plan import plan_sketch as ref_plan_sketch
from repro.kernels.rsp_shuffle.kernel import rsp_shuffle_pallas
from repro_torch.kernels.block_sketch import block_sketch
from repro_torch.kernels.block_sketch.kernel import block_sketch_plain
from repro_torch.kernels.plan import QueryPlan, plan_sketch
from repro_torch.kernels.rsp_shuffle import (
    make_permutations,
    partition_permutations,
    rsp_shuffle_plain,
    rsp_shuffle_ref,
)


def _perms(seed, n_tiles, tile_rows):
    rng = np.random.default_rng(seed)
    tile_perm = rng.permutation(n_tiles).astype(np.int32)
    intra = np.stack([rng.permutation(tile_rows) for _ in range(n_tiles)]).astype(np.int32)
    return tile_perm, intra


# ---------------------------------------------------------------------------
# rsp_shuffle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,D,T", [(512, 8, 64), (330, 29, 110), (96, 3, 32)])
def test_rsp_shuffle_plain_matches_pallas(R, D, T):
    import jax.numpy as jnp

    x = np.random.default_rng(1).normal(size=(R, D)).astype(np.float32)
    tile_perm, intra = _perms(2, R // T, T)
    want = np.asarray(
        rsp_shuffle_pallas(
            jnp.asarray(x), jnp.asarray(tile_perm), jnp.asarray(intra),
            tile_rows=T, interpret=True,
        )
    )
    got = rsp_shuffle_plain(
        torch.from_numpy(x), torch.from_numpy(tile_perm), torch.from_numpy(intra), tile_rows=T
    ).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, rsp_shuffle_ref(x, tile_perm, intra, tile_rows=T))


def test_rsp_shuffle_plain_batched_equals_per_block():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 120, 5)).astype(np.float32)
    perms = [make_permutations(7, i, 6, 20) for i in range(4)]
    tp = torch.from_numpy(np.stack([p[0] for p in perms]))
    ip = torch.from_numpy(np.stack([p[1] for p in perms]))
    got = rsp_shuffle_plain(torch.from_numpy(x), tp, ip, tile_rows=20)
    for b in range(4):
        want = rsp_shuffle_plain(torch.from_numpy(x[b]), tp[b], ip[b], tile_rows=20)
        assert torch.equal(got[b], want)


def test_rsp_shuffle_plain_copies_bits_of_any_dtype():
    x = torch.arange(60 * 3, dtype=torch.float64).reshape(60, 3).to(torch.float16)
    tile_perm, intra = _perms(4, 3, 20)
    got = rsp_shuffle_plain(x, torch.from_numpy(tile_perm), torch.from_numpy(intra), tile_rows=20)
    want = rsp_shuffle_ref(x.numpy(), tile_perm, intra, tile_rows=20)
    np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))


def test_make_permutations_are_permutations_and_seeded():
    tp, ip = make_permutations(5, 3, 10, 7)
    assert sorted(tp.tolist()) == list(range(10))
    assert all(sorted(row.tolist()) == list(range(7)) for row in ip)
    tp2, ip2 = make_permutations(5, 3, 10, 7)
    np.testing.assert_array_equal(tp, tp2)
    np.testing.assert_array_equal(ip, ip2)
    assert not np.array_equal(make_permutations(5, 4, 10, 7)[1], ip)
    # the kernel takes C-contiguous index arrays
    stacked = partition_permutations(5, 3, 10, 7)
    assert all(a.flags.c_contiguous and a.dtype == np.int32 for a in (tp, ip, *stacked))
    np.testing.assert_array_equal(stacked[1][1], make_permutations(5, 1, 10, 7)[1])


# ---------------------------------------------------------------------------
# block_sketch
# ---------------------------------------------------------------------------

def _assert_sketch(got, want, *, hist=True):
    assert got.count == want.count
    np.testing.assert_allclose(got.mean, want.mean, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.m2, want.m2, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.min, want.min, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.max, want.max, rtol=1e-6, atol=1e-6)
    if hist:
        np.testing.assert_array_equal(got.hist, want.hist)


@pytest.mark.parametrize("ref_impl", ["pallas", "jax"])
@pytest.mark.parametrize("n,f,bins,tile", [(512, 8, 32, 128), (1000, 5, 64, 256), (130, 29, 16, 64)])
def test_block_sketch_plain_matches_reference(ref_impl, n, f, bins, tile):
    x = np.random.default_rng(12).normal(1.5, 2.0, size=(n, f)).astype(np.float32)
    lo, hi = x.min(0) - 0.1, x.max(0) + 0.1
    kw = dict(bins=bins, lo=lo, hi=hi)
    tile_kw = dict(tile_rows=tile) if ref_impl == "pallas" else {}
    want = ref_block_sketch(x, impl=ref_impl, **kw, **tile_kw)
    got = block_sketch(torch.from_numpy(x), impl="torch", **kw)
    _assert_sketch(got, want)
    np.testing.assert_array_equal(got.lo, want.lo)


def test_block_sketch_plain_inv_width_zero_and_clipping():
    rng = np.random.default_rng(14)
    x = np.concatenate(
        [np.full((256, 1), 3.0, np.float32), rng.normal(0.0, 5.0, size=(256, 1)).astype(np.float32)],
        axis=1,
    )
    lo, hi = np.array([3.0, -1.0]), np.array([3.0, 1.0])  # feature 0 constant: inv_width 0
    want = ref_block_sketch(x, bins=8, lo=lo, hi=hi, impl="pallas", tile_rows=64)
    got = block_sketch(x, bins=8, lo=lo, hi=hi, impl="torch")
    _assert_sketch(got, want)
    assert got.hist[0].tolist() == [256] + [0] * 7
    np.testing.assert_array_equal(got.hist.sum(axis=1), [256, 256])


def test_block_sketch_plain_moments_only():
    x = np.random.default_rng(15).normal(size=(777, 6)).astype(np.float32)
    want = ref_block_sketch(x, impl="jax")
    got = block_sketch(x, impl="torch")
    assert got.hist is None and got.lo is None
    _assert_sketch(got, want, hist=False)


def test_block_sketch_ref_impl_is_the_reference_oracle():
    x = np.random.default_rng(16).normal(size=(300, 4)).astype(np.float32)
    want = ref_block_sketch(x, bins=8, lo=-3.0, hi=3.0, impl="ref")
    got = block_sketch(torch.from_numpy(x), bins=8, lo=-3.0, hi=3.0, impl="ref")
    assert got.to_dict() == want.to_dict()


def test_block_sketch_plain_tensor_outputs():
    x = torch.from_numpy(np.random.default_rng(17).normal(size=(90, 3)).astype(np.float32))
    lo = torch.full((3,), -3.0)
    invw = torch.full((3,), 8 / 6.0)
    stats, hist = block_sketch_plain(x, lo, invw, bins=8)
    assert stats.shape == (5, 3) and stats.dtype == torch.float32
    assert hist.shape == (3, 8) and int(hist.sum()) == 270
    empty, none = block_sketch_plain(x[:0], lo, invw, bins=0)
    assert none is None and torch.all(empty[0] == 0) and torch.all(torch.isinf(empty[3:]))


# ---------------------------------------------------------------------------
# plan_sketch
# ---------------------------------------------------------------------------

def _data(n=4000, f=6, classes=0, seed=0, out_of_range=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(1.5, 2.0, size=(n, f)).astype(np.float32)
    if classes:
        lo, hi = (-1, classes + 1) if out_of_range else (0, classes)
        x[:, f - 1] = rng.integers(lo, hi, size=n)  # integer labels: both label rules agree
    return x


PLANS = {
    "filter": (dict(predicates="c0 > 1.0"), 0, False),
    "conjunction": (dict(predicates=["c0 > 1.0", "c2 < 2.5"]), 0, False),
    "empty_selection": (dict(predicates="c0 > 1e9"), 0, False),
    "all_pass": (dict(predicates="c0 > -1e9"), 0, False),
    "projection": (dict(columns=(0, 2, 4)), 0, False),
    "filter_project": (dict(predicates="c1 < 2.0", columns=(3, 1)), 0, False),
    "grouped_filter": (
        dict(predicates="c0 > 1.0", columns=(0, 1, 2), group_by=5, num_classes=3), 3, False,
    ),
    "grouped_out_of_range": (dict(group_by=5, num_classes=3), 3, True),
}


def _assert_plan(res, ref, *, hist_exact):
    assert res.rows_total == ref.rows_total
    assert res.rows_selected == ref.rows_selected
    assert len(res.sketches) == len(ref.sketches)
    for got, want in zip(res.sketches, ref.sketches):
        assert got.count == want.count
        if want.count == 0:
            assert np.all(np.isinf(got.min)) and np.all(np.isinf(got.max))
            continue
        np.testing.assert_allclose(got.mean, want.mean, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.min, want.min, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.max, want.max, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.m2, want.m2, rtol=1e-4, atol=1e-3)
        if want.hist is not None:
            np.testing.assert_array_equal(got.hist.sum(-1), want.hist.sum(-1))
            if hist_exact:
                np.testing.assert_array_equal(got.hist, want.hist)


@pytest.mark.parametrize("ref_impl", ["pallas", "np"])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_plain_matches_reference(ref_impl, name):
    spec, classes, oor = PLANS[name]
    x = _data(classes=classes, out_of_range=oor)
    kw = dict(bins=16, lo=-8.0, hi=12.0)
    tile = dict(tile_rows=512)
    want = ref_plan_sketch(x, RefQueryPlan(**spec), impl=ref_impl, **kw, **tile)
    got = plan_sketch(torch.from_numpy(x), QueryPlan(**spec), impl="torch", **kw)
    # the fused paths share one float32 binning rule: histograms exact
    _assert_plan(got, want, hist_exact=True)


def test_plan_plain_ragged_tail_and_no_hist():
    x = _data(n=3001)
    plan = dict(predicates="c1 > 1.5")
    want = ref_plan_sketch(x, RefQueryPlan(**plan), impl="pallas", tile_rows=128,
                           bins=8, lo=-8.0, hi=12.0)
    got = plan_sketch(x, QueryPlan(**plan), impl="torch", bins=8, lo=-8.0, hi=12.0)
    _assert_plan(got, want, hist_exact=True)
    want0 = ref_plan_sketch(x, RefQueryPlan(**plan), impl="np")
    got0 = plan_sketch(x, QueryPlan(**plan), impl="torch")
    assert got0.sketches[0].hist is None
    _assert_plan(got0, want0, hist_exact=False)


def test_plan_labels_truncate_like_numpy_path():
    # fractional labels: the port follows the reference's numpy/jit rule
    # (truncate toward zero), not its Pallas kernel's label == float(g)
    x = _data(n=700, classes=0)
    x[:, 5] = np.resize(np.array([-1.5, -0.5, 0.0, 0.7, 1.0, 1.9, 2.0, 3.5], np.float32), 700)
    spec = dict(group_by=5, num_classes=2)
    want = ref_plan_sketch(x, RefQueryPlan(**spec), impl="np", bins=4, lo=-4.0, hi=8.0)
    got = plan_sketch(x, QueryPlan(**spec), impl="torch", bins=4, lo=-4.0, hi=8.0)
    _assert_plan(got, want, hist_exact=True)
    assert got.rows_selected == 700  # nsel counts rows whatever their label


def test_plan_ref_impl_is_the_reference_oracle():
    x = _data(n=500, classes=2)
    spec = dict(predicates="c0 > 1.0", group_by=5, num_classes=2)
    want = ref_plan_sketch(x, RefQueryPlan(**spec), impl="ref", bins=8, lo=-8.0, hi=12.0)
    got = plan_sketch(x, QueryPlan(**spec), impl="ref", bins=8, lo=-8.0, hi=12.0)
    assert [s.to_dict() for s in got.sketches] == [s.to_dict() for s in want.sketches]


def test_plan_key_matches_reference():
    spec = dict(predicates=["c0 > 1", (2, "<=", 3.5)], columns=(1, -1), group_by=3,
                num_classes=2)
    assert QueryPlan(**spec).key() == RefQueryPlan(**spec).key()
