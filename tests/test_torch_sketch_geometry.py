"""The host side of the port's sketch kernels, on the CPU: the launch
geometry, the plan kernel's read-path choice, the grid-tensor cache and the
packed output.

The kernels themselves run on the card only (``tests/test_torch_cuda.py``);
what surrounds them -- which rows a CTA takes, which columns a plan reads,
which tensors a call reuses, how its one output buffer is laid out -- is
plain Python and is held here to the rules the kernels rely on.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _sketch
from repro_torch.kernels.block_sketch import block_sketch, block_sketch_plain
from repro_torch.kernels.block_sketch import ops as block_ops
from repro_torch.kernels.plan import PlanArrays, QueryPlan, plan_sketch_plain
from repro_torch.kernels.plan.kernel import read_path, read_share, touched_columns

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (its sector_bytes is the bound's arithmetic)

QUERY_B = QueryPlan(predicates="c0 > 0.5", columns=(0, 28))
QUERY_C = QueryPlan(group_by=28, num_classes=2)


# ---------------------------------------------------------------------------
# launch geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("clusters", [16, 32, 5, 1])
@pytest.mark.parametrize("n", [0, 1, 3, 5, 255, 257, 110_000, 2**31 - 1])
def test_cta_row_ranges_start_on_four_rows_and_cover_the_block_once(n, clusters):
    most = _sketch.max_ctas(clusters)
    ctas, rows = _sketch.launch_geometry(n, most)
    assert rows % 4 == 0 and rows >= _sketch.MIN_ROWS_PER_CTA
    assert ctas % _sketch.CLUSTER == 0 and _sketch.CLUSTER <= ctas <= most
    ranges = _sketch.row_ranges(n, ctas, rows)
    assert all(start % 4 == 0 or start == n for start, _ in ranges)
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    assert all(stop == nxt for (_, stop), (nxt, _) in zip(ranges, ranges[1:]))
    assert sum(stop - start for start, stop in ranges) == n
    # only the last cluster may hold CTAs with no rows
    empty = [c for c, (start, stop) in enumerate(ranges) if start == stop]
    assert n == 0 or all(c >= ctas - _sketch.CLUSTER for c in empty)


def test_cta_count_is_a_fixed_function_of_n_and_the_card():
    # the H100 holds 16 clusters of 8 of the main path's block_sketch launch
    # (one CTA an SM) and 32 of its plan_sketch launches (two an SM)
    assert _sketch.launch_geometry(110_000, _sketch.max_ctas(16)) == (128, 860)
    assert _sketch.launch_geometry(110_000, _sketch.max_ctas(32)) == (256, 432)
    for n in (1, 1000, 110_000, 2**31 - 1):
        assert _sketch.launch_geometry(n, 128) == _sketch.launch_geometry(n, 128)
    # small blocks keep at least MIN_ROWS_PER_CTA rows a CTA
    assert _sketch.launch_geometry(1000, 128) == (8, 256)
    # the last fold takes at most MAX_CLUSTERS clusters
    assert _sketch.max_ctas(1000) == _sketch.CLUSTER * _sketch.MAX_CLUSTERS
    assert _sketch.max_ctas(0) == _sketch.CLUSTER


def test_pow2_floor():
    assert [_sketch.pow2_floor(v) for v in (0, 1, 2, 3, 17, 256, 511)] == [1, 1, 2, 2, 16, 256, 256]


# ---------------------------------------------------------------------------
# plan_sketch's read path
# ---------------------------------------------------------------------------

def test_query_b_gathers_and_query_c_stages():
    assert touched_columns(QUERY_B, 29) == (0, 28)
    assert read_path(29, touched_columns(QUERY_B, 29)) == "gather"
    assert read_path(29, touched_columns(QUERY_C, 29)) == "stage"
    assert PlanArrays.build(QUERY_B, 29, "cpu").path == "gather"
    assert PlanArrays.build(QUERY_C, 29, "cpu").path == "stage"


@pytest.mark.parametrize("f,cols", [
    (29, (0, 28)), (29, (0,)), (29, tuple(range(29))), (29, (1, 2, 3)), (29, (5, 17)),
    (29, (0, 14, 28)), (6, (0, 5)), (64, (3, 40)), (1, (0,)),
])
def test_read_share_is_the_sector_bytes_of_the_bound(f, cols):
    for n in (8, 800, 110_000):
        want = chip_smoke.sector_bytes(n, f, cols) / (n * f * 4)
        assert read_share(f, cols) == pytest.approx(want, rel=1e-12)


def test_gathered_tile_columns_map_back_to_the_block():
    arrays = PlanArrays.build(QUERY_B, 29, "cpu")
    assert arrays.touched == (0, 28)
    assert arrays.pcol.tolist() == [0] and arrays.cols.tolist() == [0, 1]
    assert arrays.bcols.tolist() == [0, 28] and arrays.src.tolist() == [0, 28]
    assert arrays.gcol == -1
    grouped = QueryPlan(predicates="c2 > -0.5", columns=(1, 2, 3), group_by=28, num_classes=3)
    arrays = PlanArrays.build(grouped, 29, "cpu")
    assert arrays.path == "gather" and arrays.touched == (1, 2, 3, 28)
    assert arrays.pcol.tolist() == [1] and arrays.cols.tolist() == [0, 1, 2]
    assert arrays.gcol == 3 and arrays.src.tolist() == [1, 2, 3, 28]
    staged = PlanArrays.build(QUERY_C, 29, "cpu")
    assert staged.cols.tolist() == list(range(29)) and staged.gcol == 28


# ---------------------------------------------------------------------------
# grid tensors
# ---------------------------------------------------------------------------

def test_grid_tensor_cache_hits_misses_and_is_bounded():
    block_ops.grid_cache_clear()
    lo, hi = np.array([-1.0, 0.0, 2.0]), np.array([1.0, 4.0, 3.0])
    first = block_ops.grid_tensors(lo, hi, 8, "cpu")
    again = block_ops.grid_tensors(lo.copy(), hi.copy(), 8, "cpu")
    assert again[0] is first[0] and again[1] is first[1]
    assert block_ops.grid_cache_info() == {"hits": 1, "misses": 1, "size": 1}
    block_ops.grid_tensors(lo, hi + 1.0, 8, "cpu")      # another grid
    block_ops.grid_tensors(lo, hi, 16, "cpu")           # another bin count
    assert block_ops.grid_cache_info() == {"hits": 1, "misses": 3, "size": 3}
    np.testing.assert_array_equal(first[0].numpy(), lo.astype(np.float32))
    np.testing.assert_array_equal(first[1].numpy(), (8 / (hi - lo)).astype(np.float32))
    for k in range(block_ops.GRID_CACHE_ENTRIES + 10):
        block_ops.grid_tensors(lo + k, hi + k, 8, "cpu")
    assert block_ops.grid_cache_info()["size"] == block_ops.GRID_CACHE_ENTRIES
    block_ops.grid_cache_clear()


def test_a_query_sends_one_grid_for_all_its_blocks():
    block_ops.grid_cache_clear()
    rng = np.random.default_rng(3)
    for _ in range(5):
        x = rng.normal(size=(100, 4)).astype(np.float32)
        block_sketch(torch.from_numpy(x), bins=8, lo=-4.0, hi=4.0, impl="torch")
    assert block_ops.grid_cache_info()["misses"] == 1
    assert block_ops.grid_cache_info()["hits"] == 4
    block_ops.grid_cache_clear()


# ---------------------------------------------------------------------------
# the packed output
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups,fp,bins", [(1, 29, 128), (2, 29, 0), (3, 5, 7), (1, 1, 1)])
def test_packed_output_round_trips(groups, fp, bins):
    hist_off, nsel_off, total = _sketch.packed_layout(groups * fp, bins)
    assert hist_off % 8 == 0 and hist_off >= 20 * groups * fp
    assert total == nsel_off + 8 == hist_off + 8 * groups * fp * bins + 8
    stats = torch.randn(groups * 5, fp)
    hist = torch.randint(0, 1000, (groups * fp, bins)) if bins else None
    nsel = torch.tensor([12345])
    packed = _sketch.pack(stats, hist, nsel)
    assert packed.dtype == torch.uint8 and packed.numel() == total
    s, h, n = _sketch.unpack(packed, groups, fp, bins)
    assert torch.equal(s, stats) and torch.equal(n, nsel)
    assert (h is None and hist is None) or torch.equal(h, hist)


def test_plan_plain_returns_nsel_as_a_one_element_tensor():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(500, 6)).astype(np.float32))
    stats, hist, nsel = plan_sketch_plain(x, QueryPlan(predicates="c0 > 0.5"), None, None, bins=0)
    assert hist is None and isinstance(nsel, torch.Tensor)
    assert nsel.shape == (1,) and nsel.dtype == torch.int64
    assert int(nsel) == int((x[:, 0] > 0.5).sum()) == int(stats[0, 0])


def test_block_plain_parts_pack_to_what_the_ops_layer_unpacks():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(300, 3)).astype(np.float32))
    lo, invw = block_ops.grid_tensors(np.full(3, -3.0), np.full(3, 3.0), 8, "cpu")
    stats, hist = block_sketch_plain(x, lo, invw, bins=8)
    sk = block_sketch(x, bins=8, lo=-3.0, hi=3.0, impl="torch")
    np.testing.assert_array_equal(sk.mean, stats[1].numpy().astype(np.float64))
    np.testing.assert_array_equal(sk.hist, hist.numpy())
    assert sk.count == 300.0
