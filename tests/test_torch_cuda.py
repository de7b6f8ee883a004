"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and the CUDA toolkit: it carries the
``cuda`` marker and skips itself when no card is present.  The file imports
neither ``jax`` nor ``repro``, so it runs on a machine with the card alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The smoke configs (head dim 16, SSM head and state 16 at chunk 8, rwkv head
16) run on the card through ``impl="auto"``, which pads each kernel's width.

Tolerances: shuffles, histograms, counts and ``nsel`` exact; moments within
1e-5 relative (the kernels sum in another order than the plain versions);
the sketch kernels' repeated calls, and their scalar-load path against the
16-byte one, bit for bit (their fold order is fixed);
flash attention within 2e-5 in float32 and 2e-2 in bfloat16, and the SSD
scan and the WKV within 2e-4, the reference's own tolerances for its Pallas
kernels (``tests/test_kernels.py``).  The SSD and WKV backward kernels:
each gradient of one position (dxbar; dr, dk, dv) within 2e-4 (1 + |b|),
as the forwards; a gradient that sums over the sequence or the heads
(ddA, dB, dC; dlogw, du) within 1e-4 relative L2, since a sum of many
terms in another order moves its small entries by more than 2e-4 of
themselves; both give the same bits every call (no atomics).
The drift monitor, the loader and the similarity functions on the card
against the same calls on the CPU: monitor reports and MMD^2 within 1e-5
(1 + |b|), loader batches, KS and label frequencies exactly.  A four-host
``LocalTransport`` mesh on the card answers as the single host on the card
bit for bit, and a two-rank gloo collective partition (both ranks on
``cuda:0``) equals the ``cuda`` backend bit for bit.  Every configuration
the autotuner may choose for the three RSP kernels (``kernels/autotune.py``)
is held to the plain version as the default one is; the ``torch``
partition backend's blocks on the card equal its blocks on the CPU; the
granite-moe smoke config serves on the card through the flash kernel.
``chip_smoke.py`` repeats these checks at the main path's full shapes.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import SHAPES, smoke_config
from repro_torch.kernels.block_sketch import block_sketch
from repro_torch.kernels.block_sketch.kernel import LAUNCHES as BLOCK
from repro_torch.kernels.block_sketch.kernel import block_sketch_cuda, block_sketch_plain
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_bwd_cuda,
    flash_attention_bwd_plain,
    flash_attention_cuda,
    flash_attention_plain,
    flash_attention_stats,
    log_sum_exp,
)
from repro_torch.kernels.mamba2_ssd import ssd, ssd_bwd_cuda, ssd_bwd_plain, ssd_cuda, ssd_plain
from repro_torch.kernels.plan import PlanArrays, QueryPlan, plan_sketch
from repro_torch.kernels.plan.kernel import LAUNCHES as PLAN
from repro_torch.kernels.plan.kernel import plan_sketch_cuda, plan_sketch_plain
from repro_torch.kernels.rsp_shuffle import rsp_shuffle_cuda, rsp_shuffle_plain, shuffle_path
from repro_torch.kernels.rwkv6_wkv import (
    log_decay,
    wkv6,
    wkv6_bwd_cuda,
    wkv6_bwd_plain,
    wkv6_cuda,
    wkv6_plain,
    wkv6_scan,
)
from repro_torch.models import api
from repro_torch.models.common import iter_leaves
from repro_torch.models.transformer import build_lm, hybrid_layout
from repro_torch.optim import AdamWConfig
from repro_torch.serve import Server
from repro_torch.train import TrainConfig, init_state, make_train_step, param_grads

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card; chip_smoke.py runs these checks on the H100")
    return torch.device("cuda")


def _data(n, f, *, classes=0, seed=0, out_of_range=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(1.5, 2.0, size=(n, f)).astype(np.float32)
    if classes:
        lo, hi = (-1, classes + 1) if out_of_range else (0, classes)
        x[:, f - 1] = rng.integers(lo, hi, size=n)
    return x


def _perms(seed, batch, n_tiles, tile_rows):
    rng = np.random.default_rng(seed)
    tp = np.stack([rng.permutation(n_tiles) for _ in range(batch)]).astype(np.int32)
    ip = np.stack([
        np.stack([rng.permutation(tile_rows) for _ in range(n_tiles)]) for _ in range(batch)
    ]).astype(np.int32)
    return tp, ip


def _close(got, want):
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 29), (torch.float16, 7),
                                     (torch.bfloat16, 29)])
def test_rsp_shuffle_kernel_copies_the_plain_gather(dev, dtype, d):
    x = torch.from_numpy(np.abs(_data(4 * 330, d)).reshape(4, 330, d) * 10).to(dtype).to(dev)
    tp, ip = (torch.from_numpy(a).to(dev) for a in _perms(1, 4, 3, 110))
    got = rsp_shuffle_cuda(x, tp, ip, tile_rows=110)
    assert torch.equal(got, rsp_shuffle_plain(x, tp, ip, tile_rows=110))
    # an unbatched call is the first batch
    assert torch.equal(rsp_shuffle_cuda(x[0], tp[0], ip[0], tile_rows=110), got[0])


SHUFFLE_TILES = {
    # name: (dtype, row elements, tile rows, tiles, batches, path)
    "staged: HIGGS tile 1100 x 29 float32": (torch.float32, 29, 1100, 3, 4, "staged"),
    "rows: tile of 2100 x 116 B, over 227 KB": (torch.float32, 29, 2100, 2, 2, "rows"),
    "staged: bf16 rows of 58 B, tile 1104": (torch.bfloat16, 29, 1104, 3, 2, "staged"),
    "rows: bf16 rows of 58 B, tile 110": (torch.bfloat16, 29, 110, 3, 2, "rows"),
    "rows: the collective partition's long tile, 68,750 x 116 B":
        (torch.float32, 29, 68750, 4, 1, "rows"),
}


@pytest.mark.parametrize("name", sorted(SHUFFLE_TILES))
def test_rsp_shuffle_kernel_paths_copy_the_plain_gather(dev, name):
    dtype, d, tile, n_tiles, batch, path = SHUFFLE_TILES[name]
    x = torch.from_numpy(_data(batch * n_tiles * tile, d, seed=tile)).reshape(batch, -1, d)
    x = x.to(dtype).to(dev)
    assert shuffle_path(tile, d * x.element_size(), x_ptr=x.data_ptr()) == path
    tp, ip = (torch.from_numpy(a).to(dev) for a in _perms(tile, batch, n_tiles, tile))
    kernels.reset_launch_counts()
    got = rsp_shuffle_cuda(x, tp, ip, tile_rows=tile)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["rsp_shuffle"] == 1
    want = rsp_shuffle_plain(x, tp, ip, tile_rows=tile)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("n,f,bins", [(4096, 6, 16), (1037, 29, 128), (5000, 8, 0), (300, 64, 1024)])
def test_block_sketch_kernel_matches_plain(dev, n, f, bins):
    x = torch.from_numpy(_data(n, f, seed=n)).to(dev)
    lo = x.amin(0) - 0.1
    invw = bins / (x.amax(0) + 0.1 - lo) if bins else torch.zeros(f, device=dev)
    s1, h1 = block_sketch_cuda(x, lo, invw, bins=bins)
    s2, h2 = block_sketch_plain(x, lo, invw, bins=bins)
    _close(s1, s2)
    assert torch.equal(s1[0], s2[0])
    assert (h1 is None) == (bins == 0) and (h1 is None or torch.equal(h1, h2))


def test_block_sketch_kernel_inv_width_zero_fills_bin_zero(dev):
    x = torch.from_numpy(_data(999, 5)).to(dev)
    _, h = block_sketch_cuda(x, torch.zeros(5, device=dev), torch.zeros(5, device=dev), bins=8)
    assert bool((h[:, 0] == 999).all()) and int(h[:, 1:].sum()) == 0


PLANS = {
    "filter": (dict(predicates="c0 > 1.0"), False),
    "projection": (dict(columns=(0, 3, 5)), False),
    "grouped": (dict(predicates="c1 < 2.0", group_by=5, num_classes=2), False),
    "empty": (dict(predicates="c0 > 1e9"), False),
    "out_of_range_labels": (dict(group_by=5, num_classes=2), True),
    "many_predicates": (dict(predicates=["c2 >= 0.1", "c3 != 0.0", "c4 <= 6"], columns=(1, 2)),
                        False),
}


@pytest.mark.parametrize("bins", [16, 0])
@pytest.mark.parametrize("name", sorted(PLANS))
def test_plan_kernel_matches_plain(dev, name, bins):
    spec, odd = PLANS[name]
    plan = QueryPlan(**spec)
    x = torch.from_numpy(_data(4097, 6, classes=2, out_of_range=odd)).to(dev)
    fp = len(plan.resolve_columns(6))
    lo = invw = None
    if bins:
        lo = torch.full((fp,), -8.0, device=dev)
        invw = torch.full((fp,), bins / 20.0, device=dev)
    s1, h1, n1 = plan_sketch_cuda(x, PlanArrays.build(plan, 6, dev), lo, invw, bins=bins)
    s2, h2, n2 = plan_sketch_plain(x, plan, lo, invw, bins=bins)
    assert torch.equal(n1, n2)
    _close(s1, s2)
    assert (h1 is None and h2 is None) or torch.equal(h1, h2)


# -- the redesigned sketch kernels: one launch, a fixed fold order, a clean
# scratch, two read paths, 16-byte and scalar loads

def _block_args(x, bins):
    f = x.shape[1]
    if x.shape[0] == 0 or bins == 0:
        return torch.zeros(f, device=x.device), torch.full((f,), 0.5, device=x.device)
    lo = x.amin(0) - 0.1
    return lo, bins / (x.amax(0) + 0.1 - lo)


def _bits(outs):
    return [t.view(torch.int32) if t.dtype == torch.float32 else t
            for t in outs if t is not None]


def _same(a, b):
    return all(torch.equal(u, v) for u, v in zip(_bits(a), _bits(b)))


def _check_block(x, bins):
    lo, invw = _block_args(x, bins)
    s1, h1 = block_sketch_cuda(x, lo, invw, bins=bins)
    s2, h2 = block_sketch_plain(x, lo, invw, bins=bins)
    _close(s1, s2)
    assert torch.equal(s1[0], s2[0])
    assert (h1 is None) == (bins == 0) and (h1 is None or torch.equal(h1, h2))
    return s1, h1


def _check_plan(x, plan, bins, path=None):
    fp = len(plan.resolve_columns(x.shape[1]))
    lo = invw = None
    if bins:
        lo = torch.full((fp,), -8.0, device=x.device)
        invw = torch.full((fp,), bins / 20.0, device=x.device)
    arrays = PlanArrays.build(plan, x.shape[1], x.device)
    assert path is None or arrays.path == path
    got = plan_sketch_cuda(x, arrays, lo, invw, bins=bins)
    want = plan_sketch_plain(x, plan, lo, invw, bins=bins)
    _close(got[0], want[0])
    assert torch.equal(got[0][0::5], want[0][0::5]) and torch.equal(got[2], want[2])
    assert (got[1] is None and want[1] is None) or torch.equal(got[1], want[1])
    return got


QUERY_B = QueryPlan(predicates="c0 > 0.5", columns=(0, 28))
QUERY_C = QueryPlan(group_by=28, num_classes=2)


@pytest.mark.parametrize("kind", ["block", "plan gather", "plan stage"])
def test_sketch_kernels_give_the_same_bits_twenty_times(dev, kind):
    x = torch.from_numpy(_data(110_000, 29, classes=2, seed=7)).to(dev)
    if kind == "block":
        lo, invw = _block_args(x, 128)
        call = lambda: block_sketch_cuda(x, lo, invw, bins=128)  # noqa: E731
    else:
        plan = QUERY_B if kind == "plan gather" else QUERY_C
        arrays = PlanArrays.build(plan, 29, dev)
        assert arrays.path == kind.split()[1]
        fp = len(plan.resolve_columns(29))
        lo, invw = torch.full((fp,), -8.0, device=dev), torch.full((fp,), 3.2, device=dev)
        call = lambda: plan_sketch_cuda(x, arrays, lo, invw, bins=64)  # noqa: E731
    first = [t.clone() for t in call() if t is not None]
    for _ in range(19):
        assert _same(first, call())


ROWS = [0, 1, 3, 5, 255, 257, 110_000]   # 256: the fewest rows a CTA takes


@pytest.mark.parametrize("n", ROWS)
def test_sketch_kernels_at_row_counts_of_the_edges(dev, n):
    x = torch.from_numpy(_data(max(n, 1), 29, classes=2, seed=n)[:n]).to(dev)
    s, _ = _check_block(x, 32)
    if n == 0:
        assert torch.all(s[0] == 0) and torch.all(s[3] == float("inf"))
        assert torch.all(s[4] == float("-inf"))
    for plan, path in ((QUERY_B, "gather"), (QUERY_C, "stage")):
        _check_plan(x, plan, 16, path)


@pytest.mark.parametrize("f", [1, 3, 29, 64, 300, 1024])
def test_sketch_kernels_at_feature_counts_of_the_edges(dev, f):
    x = torch.from_numpy(_data(3001, f, seed=f)).to(dev)
    _check_block(x, 8)
    _check_block(x, 0)
    _check_plan(x, QueryPlan(predicates="c0 > 1.0"), 8)
    _check_plan(x, QueryPlan(columns=(0, f - 1)), 0)


def test_sketch_kernels_with_a_histogram_too_large_for_shared_memory(dev):
    x = torch.from_numpy(_data(5000, 29, classes=2, seed=11)).to(dev)
    _check_block(x, 4096)                 # 29 x 4097 x 4 bytes > the shared-memory limit
    _check_plan(x, QUERY_C, 1024)         # 58 x 1025 x 4 bytes


def test_sketch_kernels_on_a_block_that_is_not_16_byte_aligned(dev):
    x = torch.from_numpy(_data(20_000, 29, classes=2, seed=13)).to(dev)
    shifted = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16 != 0 and shifted.is_contiguous()
    lo, invw = _block_args(x, 128)
    aligned = block_sketch_cuda(x, lo, invw, bins=128)
    assert BLOCK.last["path"] == "vec4"
    assert _same(aligned, block_sketch_cuda(shifted, lo, invw, bins=128))
    assert BLOCK.last["path"] == "scalar"
    _check_block(shifted, 128)
    arrays = PlanArrays.build(QUERY_C, 29, dev)
    staged = plan_sketch_cuda(x, arrays, None, None, bins=0)
    assert PLAN.last["path"] == "stage vec4"
    assert _same(staged, plan_sketch_cuda(shifted, arrays, None, None, bins=0))
    assert PLAN.last["path"] == "stage scalar"
    _check_plan(shifted, QUERY_B, 16, "gather")


def test_sketch_kernels_on_two_streams_at_once(dev):
    xs = [torch.from_numpy(_data(110_000, 29, classes=2, seed=s)).to(dev) for s in (21, 22)]
    grids = [_block_args(x, 128) for x in xs]
    arrays = PlanArrays.build(QUERY_C, 29, dev)
    want = [(block_sketch_cuda(x, *g, bins=128), plan_sketch_cuda(x, arrays, None, None, bins=0))
            for x, g in zip(xs, grids)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    got = [[], []]
    for _ in range(10):
        for k in (0, 1):
            with torch.cuda.stream(streams[k]):
                got[k].append((block_sketch_cuda(xs[k], *grids[k], bins=128),
                               plan_sketch_cuda(xs[k], arrays, None, None, bins=0)))
    torch.cuda.synchronize()
    for k in (0, 1):
        for b, p in got[k]:
            assert _same(b, want[k][0]) and _same(p, want[k][1])


@pytest.mark.parametrize("name", ["gather", "stage"])
@pytest.mark.parametrize("bins", [0, 32])
def test_plan_kernel_read_paths_match_plain(dev, name, bins):
    x = torch.from_numpy(_data(50_000, 29, classes=3, seed=17, out_of_range=True)).to(dev)
    plans = {
        "gather": [QUERY_B, QueryPlan(predicates=["c2 > -0.5", "c1 <= 2"], columns=(1, 2, 3),
                                      group_by=28, num_classes=3)],
        "stage": [QUERY_C, QueryPlan(predicates="c3 != 0.0", group_by=28, num_classes=6)],
    }
    for plan in plans[name]:
        _check_plan(x, plan, bins, name)


def test_plan_kernel_refuses_plan_arrays_on_the_host(dev):
    x = torch.from_numpy(_data(500, 6)).to(dev)
    plan = QueryPlan(predicates="c0 > 1.0")
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="pcol is on cpu"):
        plan_sketch_cuda(x, PlanArrays.build(plan, 6, "cpu"), None, None, bins=0)
    assert kernels.launch_counts()["plan_sketch"] == 0


def test_auto_impl_launches_the_kernels_and_counts(dev):
    x = torch.from_numpy(_data(2000, 6, classes=2)).to(dev)
    kernels.reset_launch_counts()
    sk = block_sketch(x, bins=8, lo=-8.0, hi=12.0)
    res = plan_sketch(x, QueryPlan(predicates="c0 > 1.0"), bins=0)
    counts = kernels.launch_counts()
    assert counts["block_sketch"] == 1 and counts["plan_sketch"] == 1
    ref = block_sketch(x, bins=8, lo=-8.0, hi=12.0, impl="torch")
    np.testing.assert_array_equal(sk.hist, ref.hist)
    np.testing.assert_allclose(sk.mean, ref.mean, rtol=1e-5)
    assert res.rows_selected == int((x[:, 0] > 1.0).sum())


def test_partition_on_the_card_equals_the_cpu_plain_version(dev):
    from repro_torch import rsp

    data = _data(6000, 5, classes=2)
    kernels.reset_launch_counts()
    on_card = rsp.partition(data, blocks=10, seed=3, num_classes=2, summaries=False)
    assert on_card.backend == "cuda" and kernels.launch_counts()["rsp_shuffle"] == 1
    on_cpu = rsp.partition(data, blocks=10, seed=3, num_classes=2, summaries=False,
                           backend="cuda", device="cpu")
    assert torch.equal(on_card.stacked().cpu(), on_cpu.stacked())


def test_block_moments_run_the_kernel_and_match_the_plain_version(dev):
    from repro_torch.core.estimators import block_moments

    x = _data(5000, 8)
    x[:, 0] += 1.0e4   # a column whose mean is far from 0
    t = torch.from_numpy(x).to(dev)
    kernels.reset_launch_counts()
    got = block_moments(t)
    assert kernels.launch_counts()["block_sketch"] == 1
    want = block_moments(t, impl="torch")
    assert kernels.launch_counts()["block_sketch"] == 1
    assert got.count == want.count == 5000
    for field in ("mean", "m2", "min", "max"):
        np.testing.assert_allclose(getattr(got, field), getattr(want, field), rtol=1e-5)


def test_drift_monitor_launches_block_sketch_once_per_reference_block(dev):
    """The monitor folds its reference blocks through the kernel (one
    launch a block, none per score) and reports what a CPU monitor does."""
    from repro_torch.core.monitor import DriftMonitor

    blocks = np.stack([_data(3000, 7, seed=s) for s in range(8)])
    kernels.reset_launch_counts()
    mon = DriftMonitor(torch.from_numpy(blocks[:4]).to(dev), seed=0, device=dev)
    counts = kernels.launch_counts()
    assert counts["block_sketch"] == 4 and sum(counts.values()) == 4
    host = DriftMonitor(blocks[:4], seed=0, device="cpu")
    shifted = blocks[5] + 1.5
    for i, b in [(4, blocks[4]), (6, blocks[6]), (5, shifted)]:
        got = mon.score(torch.from_numpy(b).to(dev), block_id=i)
        want = host.score(b, block_id=i)
        assert got.drifted == want.drifted
        for f in ("mmd2", "max_mean_z", "worst_std_ratio"):
            assert abs(getattr(got, f) - getattr(want, f)) <= 1e-5 * max(abs(getattr(want, f)), 1)
    assert 5 in mon.drifted_blocks() and mon.drifted_blocks() == host.drifted_blocks()
    assert sum(kernels.launch_counts().values()) == 4


def test_loader_batches_on_the_card_equal_the_cpu_loader(dev, tmp_path):
    from repro_torch import rsp

    data = _data(8 * 1600, 5, classes=2)
    rsp.partition(data, blocks=8, seed=3, num_classes=2, backend="np", device="cpu") \
        .save(str(tmp_path))
    card = rsp.open(str(tmp_path), device=dev).loader(700, seed=4)
    host = rsp.open(str(tmp_path), device="cpu").loader(700, seed=4)
    for _ in range(25):                                  # past an epoch boundary
        got, want = card.next_batch(), host.next_batch()
        assert got.device.type == "cuda"
        assert torch.equal(got.cpu(), want)
    assert card.state_dict() == host.state_dict()
    card.close()
    host.close()


def test_ks_and_labels_on_the_card_equal_the_cpu_exactly(dev):
    from repro_torch.core.similarity import ks_statistic, label_distribution, max_label_divergence

    rng = np.random.default_rng(5)
    for n, m in [(110000, 110000), (3001, 777), (1, 5)]:
        a = torch.from_numpy(rng.normal(size=n).astype(np.float32))
        b = torch.from_numpy(rng.normal(0.01, 1.0, size=m).astype(np.float32))
        assert ks_statistic(a.to(dev), b.to(dev)) == ks_statistic(a, b)
    labels = torch.from_numpy(rng.integers(0, 3, size=110001).astype(np.float32))
    other = torch.from_numpy(rng.integers(0, 3, size=7777).astype(np.float32))
    assert torch.equal(label_distribution(labels.to(dev), 3).cpu(), label_distribution(labels, 3))
    assert (max_label_divergence(labels.to(dev), other.to(dev), 3)
            == max_label_divergence(labels, other, 3))


def test_mmd2_on_the_card_matches_the_cpu(dev):
    from repro_torch.core.similarity import median_heuristic_gamma, mmd2_rbf, mmd_block_vs_data

    x, y = _data(1024, 29, seed=1), _data(1024, 29, seed=2) + 0.05
    gamma = median_heuristic_gamma(x)
    assert abs(median_heuristic_gamma(torch.from_numpy(x).to(dev)) - gamma) <= 1e-5 * gamma
    got = float(mmd2_rbf(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev), gamma))
    want = float(mmd2_rbf(torch.from_numpy(x), torch.from_numpy(y), gamma))
    assert abs(got - want) <= 1e-5 * (1 + abs(want))
    got = mmd_block_vs_data(torch.from_numpy(x).to(dev), torch.from_numpy(y).to(dev), seed=3)
    want = mmd_block_vs_data(x, y, seed=3)
    assert abs(got - want) <= 1e-5 * (1 + abs(want))


def test_served_queries_on_the_card_equal_their_solo_runs(dev, tmp_path):
    """16 tenants from 4 threads over a stored RSP on the card: every
    answer equals the same seeded query run alone, bit for bit, and the
    sketch kernels ran once for every block a progressive query folded."""
    import dataclasses
    import threading

    from repro_torch import rsp
    from repro_torch.rsp.query import Aggregate, QueryExecutor, as_query, derive_seed

    data = _data(12 * 1200, 6, classes=2)
    rsp.partition(data, blocks=12, seed=2, num_classes=2, backend="np", device="cpu") \
        .save(str(tmp_path))
    ds = rsp.open(str(tmp_path), device=dev, cache_blocks=12)
    specs = [
        (["mean", "var", "count"], {}),
        ("p90", dict(max_blocks=5, use_sketches=False)),
        ("mean", dict(where="c0 > 1.5", columns=(0, 5), target_rel_err=0.02,
                      use_sketches=False)),
        (Aggregate("mean", by_label=True), dict(max_blocks=6, use_sketches=False)),
    ] * 4
    tickets = [None] * len(specs)
    kernels.reset_launch_counts()
    with ds.serve(capacity=8, workers=4, seed=11) as svc:

        def submit(lo):
            for i in range(lo, len(specs), 4):
                agg, kw = specs[i]
                tickets[i] = svc.submit(agg, **kw)

        threads = [threading.Thread(target=submit, args=(j,)) for j in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        served = [svc.result(t, timeout=120) for t in tickets]
    counts = kernels.launch_counts()
    unfiltered = sum(r.blocks_read for (a, _), r in zip(specs, served) if a == "p90")
    planned = sum(r.blocks_read for (a, kw), r in zip(specs, served)
                  if "where" in kw or isinstance(a, Aggregate))
    assert unfiltered > 0 and planned > 0
    assert (counts["block_sketch"], counts["plan_sketch"]) == (unfiltered, planned)
    solo_ds = rsp.open(str(tmp_path), device=dev)
    for (agg, kw), t, res in zip(specs, tickets, served):
        q = dataclasses.replace(as_query(agg, **kw), seed=derive_seed(11, t.id))
        solo = QueryExecutor(solo_ds, q).run()
        assert (res.blocks_read, res.converged) == (solo.blocks_read, solo.converged)
        for a, b in zip(res.aggregates, solo.aggregates):
            for f in ("estimate", "ci_lo", "ci_hi"):
                np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                              np.asarray(getattr(b, f)))
    solo_ds.close()
    ds.close()


FLASH_SHAPES = [
    # B, H, Hkv, S, D
    (2, 4, 2, 128, 64),      # GQA, whole tiles
    (1, 14, 2, 200, 64),     # qwen2-0.5b's heads (G = 7), ragged S
    (1, 40, 8, 96, 128),     # qwen3-14b's heads, D = 128
    (1, 48, 1, 130, 128),    # granite-20b's MQA (G = 48)
    (2, 2, 2, 1, 64),        # a single row
    (1, 8, 8, 1000, 64),     # MHA, ragged S over many tiles
    (1, 32, 32, 200, 112),   # zamba2-7b's shared block, D = 112, ragged S
    (1, 16, 16, 150, 80),    # hubert-xlarge's heads, D = 80, ragged S
    (2, 8, 2, 129, 80),      # GQA at D = 80, one row past a tile
]


def _qkv(B, H, Hkv, S, D, dtype, dev, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn((B, h, S, D), generator=g) for h in (H, Hkv, Hkv))
    return (t.to(dtype).to(dev) for t in (q, k, v))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", FLASH_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_kernel_matches_plain(dev, shape, dtype, causal):
    q, k, v = _qkv(*shape, dtype, dev)
    got = flash_attention_cuda(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == dtype
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 80, 112, 128])
@pytest.mark.parametrize("S", [127, 128, 129])
def test_flash_attention_kernel_at_the_tile_edges(dev, S, D, causal):
    # one 128-row query tile and kv tile, one row short of it, one row over
    q, k, v = _qkv(2, 4, 2, S, D, torch.bfloat16, dev, seed=S + D)
    got = flash_attention_cuda(q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


def test_flash_attention_takes_the_grouped_layout_as_strided_views(dev):
    _grouped_layout_matches_plain(dev, 64)


def test_flash_attention_takes_the_serve_layout_at_d112(dev):
    # zamba2-7b's shared block: D = 112 rows of 224 bytes in [B, S, heads, D]
    _grouped_layout_matches_plain(dev, 112)


def _grouped_layout_matches_plain(dev, D):
    B, S, Hkv, G = 2, 150, 2, 3
    g = torch.Generator(device="cpu").manual_seed(1)
    # as the attention layer makes them: [B, S, heads, D] transposed, no copy
    q = torch.randn((B, S, Hkv, G, D), generator=g).bfloat16().to(dev).permute(0, 2, 3, 1, 4)
    k = torch.randn((B, S, Hkv, D), generator=g).bfloat16().to(dev).transpose(1, 2)
    v = torch.randn((B, S, Hkv, D), generator=g).bfloat16().to(dev).transpose(1, 2)
    assert not q.is_contiguous() and not k.is_contiguous()
    kernels.reset_launch_counts()
    got = flash_attention(q, k, v, causal=True)
    assert kernels.launch_counts()["flash_attention"] == 1
    want = flash_attention(q, k, v, causal=True, impl="torch")
    assert got.shape == (B, Hkv, G, S, D)
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2)


def test_flash_attention_kernel_refuses_what_it_does_not_take(dev):
    q, k, v = _qkv(1, 2, 1, 64, 32, torch.bfloat16, dev)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention_cuda(q, k, v)
    q, k, v = _qkv(1, 2, 1, 64, 64, torch.float16, dev)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        flash_attention_cuda(q, k, v)
    q, k, v = _qkv(1, 2, 1, 64, 64, torch.bfloat16, dev)
    with pytest.raises(ValueError, match="head dim must be contiguous"):
        flash_attention_cuda(q.transpose(2, 3), k, v)
    with pytest.raises(ValueError, match="but the block is on"):
        flash_attention_cuda(q, k.cpu(), v)


BWD_SHAPES = [
    # B, H, Hkv, S, D
    (2, 4, 2, 128, 64),      # GQA, whole tiles
    (1, 14, 2, 200, 64),     # qwen2-0.5b's heads (G = 7), ragged S
    (1, 8, 8, 97, 112),      # MHA at D = 112, ragged S
    (1, 8, 1, 130, 128),     # MQA at D = 128, ragged S
    (2, 2, 2, 1, 64),        # a single row
    (1, 16, 16, 150, 80),    # MHA at D = 80, as hubert-xlarge has it, ragged S
    (2, 8, 2, 200, 80),      # GQA at D = 80
    # ragged S around the tiles: 64-row query steps of the dK/dV kernel,
    # 128-row CTAs, 128 (D <= 80) or 64 kv rows a dQ step
    (1, 4, 2, 63, 64),
    (1, 4, 2, 65, 80),
    (1, 4, 1, 129, 128),
    (1, 4, 4, 257, 112),
    (1, 7, 1, 257, 80),      # a group of 7 over three 128-row kv tiles
]


def _grads_close(got, want, tol=2e-2):
    """|a - b| <= tol (1 + |b|), the bf16 forward's gate."""
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        bad = (a.float() - b.float()).abs() > tol * (1 + b.float().abs())
        assert not bool(bad.any()), f"{name}: {int(bad.sum())} values beyond {tol}"


def _bwd_case(B, H, Hkv, S, D, causal, dev, seed=0):
    q, k, v = _qkv(B, H, Hkv, S, D, torch.bfloat16, dev, seed)
    g = torch.Generator(device="cpu").manual_seed(seed + 1)
    dout = torch.randn((B, H, S, D), generator=g).bfloat16().to(dev)
    return q, k, v, dout


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", BWD_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_flash_attention_bwd_kernel_matches_plain(dev, shape, causal):
    q, k, v, dout = _bwd_case(*shape, causal, dev)
    out32, (m, l) = flash_attention_stats(q, k, v, causal=causal)
    out = out32.bfloat16()
    want = flash_attention_bwd_plain(q, k, v, out, dout, m, l, causal=causal)
    kernels.reset_launch_counts()
    got = flash_attention_bwd_cuda(q, k, v, out, dout, log_sum_exp(m, l), causal=causal)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["flash_attention_bwd"] == 1
    _grads_close(got, want)
    again = flash_attention_bwd_cuda(q, k, v, out, dout, log_sum_exp(m, l), causal=causal)
    for a, b in zip(got, again):          # no atomics: the same bits every call
        assert torch.equal(a, b)


@pytest.mark.parametrize("D", [64, 80])
def test_flash_attention_bwd_gives_the_same_bits_over_many_kv_tiles(dev, D):
    # causal at S = 1000: the last dQ CTA walks 8 (D = 80) or 16 (D = 64)
    # kv tiles and the first dK/dV CTA 16 query steps of each of 2 heads,
    # every sum in a fixed order
    q, k, v, dout = _bwd_case(1, 4, 2, 1000, D, True, dev, seed=D + 5)
    out32, (m, l) = flash_attention_stats(q, k, v, causal=True)
    out, lse = out32.bfloat16(), log_sum_exp(m, l)
    first = flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal=True)
    for _ in range(3):
        again = flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal=True)
        for a, b in zip(first, again):
            assert torch.equal(a, b)
    _grads_close(first, flash_attention_bwd_plain(q, k, v, out, dout, m, l, causal=True))


def test_flash_attention_bwd_refuses_a_gradient_without_dvec(dev):
    # the known-wrong control: out zeroed drops Dvec from dS
    q, k, v, dout = _bwd_case(2, 4, 2, 256, 64, True, dev, seed=3)
    out32, (m, l) = flash_attention_stats(q, k, v, causal=True)
    want = flash_attention_bwd_plain(q, k, v, out32.bfloat16(), dout, m, l, causal=True)
    wrong = flash_attention_bwd_cuda(q, k, v, torch.zeros_like(dout), dout, log_sum_exp(m, l))
    with pytest.raises(AssertionError):
        _grads_close(wrong, want)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("D", [64, 80, 112, 128])
def test_flash_attention_lse_leaves_the_output_and_matches_the_statistics(dev, D, causal):
    q, k, v = _qkv(2, 4, 2, 129, D, torch.bfloat16, dev, seed=D)
    plain = flash_attention_cuda(q, k, v, causal=causal)
    out, lse = flash_attention_cuda(q, k, v, causal=causal, with_lse=True)
    _, (m, l) = flash_attention_stats(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert torch.equal(out, plain)
    want = log_sum_exp(m, l)
    assert bool(((lse - want).abs() <= 1e-5 * (1 + want.abs())).all())


@pytest.mark.parametrize("D,causal", [(64, True), (80, False), (80, True), (16, True)])
def test_flash_attention_gradient_on_the_card_matches_the_plain_function(dev, D, causal,
                                                                        monkeypatch):
    # through ops.flash_attention (FlashAttention): GQA sum; D = 80 runs at
    # the kernels' own width, D = 16 is padded to 64 with the unpadded
    # scale and the padded columns cut off
    B, H, Hkv, S = 2, 8, 2, 150
    q, k, v, dout = _bwd_case(B, H, Hkv, S, D, causal, dev, seed=D)
    got_in = [t.clone().requires_grad_() for t in (q, k, v)]
    want_in = [t.clone().requires_grad_() for t in (q, k, v)]
    widths = []
    for name in ("flash_attention_cuda", "flash_attention_bwd_cuda"):
        def seen(*args, _fn=getattr(fa_ops, name), **kw):
            widths.append(args[0].shape[-1])
            return _fn(*args, **kw)
        monkeypatch.setattr(fa_ops, name, seen)
    kernels.reset_launch_counts()
    out = flash_attention(*got_in, causal=causal)
    out.backward(dout)
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == 1 and counts["flash_attention_bwd"] == 1
    assert widths == [fa_ops.padded_head_dim(D)] * 2 == [64 if D == 16 else D] * 2
    ref = flash_attention(*want_in, causal=causal, impl="torch")
    ref.backward(dout)
    assert out.grad_fn is not None
    torch.testing.assert_close(out.float(), ref.float(), rtol=2e-2, atol=2e-2)
    _grads_close([t.grad for t in got_in], [t.grad for t in want_in])


def test_flash_attention_float32_gradient_on_the_card_raises(dev):
    q, k, v = (t.requires_grad_() for t in _qkv(1, 2, 1, 64, 64, torch.float32, dev))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match="no gradient"):
        flash_attention_cuda(q, k, v)


def test_ssd_and_wkv_kernels_refuse_inputs_that_require_grad(dev):
    # the raw launchers return no graph; ops.ssd and ops.wkv6 carry the
    # gradient; a state that requires grad is refused by both
    (xbar, dA, Bm, Cm), h0 = _ssd_arrays(1, 128, 2, "softplus", 0, with_h0=True)
    xbar = xbar.to(dev).requires_grad_()
    dA, Bm, Cm, h0 = dA.to(dev), Bm.to(dev), Cm.to(dev), h0.to(dev)
    with pytest.raises(ValueError, match="no gradient"):
        ssd_cuda(xbar, dA, Bm, Cm)
    y, _ = ssd(xbar, dA, Bm, Cm, chunk=128)
    assert y.grad_fn is not None
    with pytest.raises(NotImplementedError, match="initial state"):
        ssd(xbar, dA, Bm, Cm, chunk=128, h0=h0.requires_grad_())
    with torch.no_grad():      # serving: no graph wanted, the kernel runs
        ssd(xbar, dA, Bm, Cm, chunk=128)
    arrays, h0 = _wkv_arrays(1, 32, 2, "model", 0, with_h0=True)
    r, k, v, w, u = (a.to(dev) for a in arrays)
    u.requires_grad_()
    with pytest.raises(ValueError, match="no gradient"):
        wkv6_cuda(r, k, v, log_decay(w), u)
    y, _ = wkv6(r, k, v, w, u)
    assert y.grad_fn is not None
    with pytest.raises(NotImplementedError, match="initial state"):
        wkv6(r, k, v, w, u, h0=h0.to(dev).requires_grad_())


# the gradients of one position held elementwise, the summed ones in L2
BWD_TOL = 2e-4
BWD_SUM_REL_L2 = 1e-4


def _bwd_close(got, want, summed):
    for i, (a, b) in enumerate(zip(got, want)):
        assert bool(torch.isfinite(a).all()), i
        if i in summed:
            assert float((a - b).norm() / b.norm()) < BWD_SUM_REL_L2, i
        else:
            torch.testing.assert_close(a, b, rtol=BWD_TOL, atol=BWD_TOL)


def _ssd_arrays(B, L, H, decay, seed, with_h0=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, H, 64)).astype(np.float32)
    if decay == "weak":
        # xbar / sqrt(L) keeps the nearly undecayed state O(1) (chip_smoke.py)
        x *= L ** -0.5
        dA = rng.uniform(-1e-3, 0.0, size=(B, L, H)).astype(np.float32)
    elif decay == "strong":
        dA = np.full((B, L, H), -30.0, np.float32)
    else:
        dA = -np.log1p(np.exp(rng.normal(size=(B, L, H)))).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, L, 64)).astype(np.float32) for _ in range(2))
    h0 = rng.normal(size=(B, H, 64, 64)).astype(np.float32) if with_h0 else None
    return [torch.from_numpy(a) for a in (x, dA, Bm, Cm)], (
        None if h0 is None else torch.from_numpy(h0))


SSD_CASES = {
    # name: B, L, H, decay, h0
    "two chunks": (2, 256, 8, "softplus", False),
    "weak decay over 16 chunks": (1, 2048, 4, "weak", False),
    "strong decay": (1, 384, 6, "strong", False),
    "from h0": (2, 256, 3, "softplus", True),
    "zamba2 heads, B = 1": (1, 512, 112, "softplus", False),
}


@pytest.mark.parametrize("name", sorted(SSD_CASES))
def test_ssd_kernel_matches_plain(dev, name):
    B, L, H, decay, with_h0 = SSD_CASES[name]
    arrays, h0 = _ssd_arrays(B, L, H, decay, seed=L + H, with_h0=with_h0)
    arrays = [a.to(dev) for a in arrays]
    h0 = None if h0 is None else h0.to(dev)
    y, h = ssd_cuda(*arrays, h0=h0)
    want_y, want_h = ssd_plain(*arrays, chunk=128, h0=h0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    torch.testing.assert_close(y, want_y, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(h, want_h, rtol=2e-4, atol=2e-4)


# the backward's own cases beside the forward's: head counts that the
# backward's head tile does not take in one wave (3 heads; zamba2's 112 at
# B = 1 is among SSD_CASES) and a single chunk
SSD_BWD_CASES = {
    **SSD_CASES,
    "3 heads, B = 1": (1, 256, 3, "softplus", False),
    "one chunk": (1, 128, 8, "softplus", False),
}


def _ssd_bwd_inputs(name, dev, final):
    B, L, H, decay, with_h0 = SSD_BWD_CASES[name]
    arrays, h0 = _ssd_arrays(B, L, H, decay, seed=L + H, with_h0=with_h0)
    arrays = [a.to(dev) for a in arrays]
    h0 = None if h0 is None else h0.to(dev)
    y, h, hs = ssd_cuda(*arrays, h0=h0, states=True)
    g = torch.Generator(device="cpu").manual_seed(L)
    dy = torch.randn(y.shape, generator=g).to(dev)
    if decay == "weak":
        # dy / sqrt(L) keeps the nearly undecayed state's gradient O(1), as
        # the forward's case scales xbar
        dy *= L ** -0.5
    kw = {"dh_final": torch.randn(h.shape, generator=g).to(dev)} if final else {}
    return (*arrays, hs, dy), kw


@pytest.mark.parametrize("final", [False, True], ids=["dh 0", "dh"])
@pytest.mark.parametrize("name", sorted(SSD_BWD_CASES))
def test_ssd_bwd_kernel_matches_plain(dev, name, final):
    args, kw = _ssd_bwd_inputs(name, dev, final)
    kernels.reset_launch_counts()
    got = ssd_bwd_cuda(*args, **kw)
    want = ssd_bwd_plain(*args, chunk=128, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["mamba2_ssd_bwd"] == 1
    _bwd_close(got, want, summed={1, 2, 3})
    again = ssd_bwd_cuda(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_ssd_auto_impl_pads_a_ragged_length_and_counts(dev):
    arrays, _ = _ssd_arrays(2, 300, 4, "softplus", seed=3)
    arrays = [a.to(dev) for a in arrays]
    kernels.reset_launch_counts()
    y, h = ssd(*arrays, chunk=128)
    assert kernels.launch_counts()["mamba2_ssd"] == 1
    want_y, want_h = ssd(*arrays, chunk=128, impl="torch")
    assert y.shape == (2, 300, 4, 64)
    torch.testing.assert_close(y, want_y, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(h, want_h, rtol=2e-4, atol=2e-4)


def test_ssd_kernel_refuses_what_it_does_not_take(dev):
    arrays, _ = _ssd_arrays(1, 128, 2, "softplus", seed=1)
    x, dA, Bm, Cm = (a.to(dev) for a in arrays)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="float32"):
        ssd_cuda(x.double(), dA, Bm, Cm)
    with pytest.raises(ValueError, match="but the block is on"):
        ssd_cuda(x, dA.cpu(), Bm, Cm)
    with pytest.raises(ValueError, match="multiple of the kernel's chunk"):
        ssd_cuda(x[:, :100].contiguous(), dA[:, :100].contiguous(), Bm[:, :100].contiguous(),
                 Cm[:, :100].contiguous())
    with pytest.raises(ValueError, match="head dim 64"):
        ssd_cuda(x[..., :32].contiguous(), dA, Bm, Cm)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), dA, Bm, Cm)
    with pytest.raises(ValueError, match="chunk 128"):
        ssd(x, dA, Bm, Cm, chunk=64, impl="cuda")
    assert kernels.launch_counts()["mamba2_ssd"] == 0


def _wkv_arrays(B, T, H, decay, seed, with_h0=False):
    """r, k, v [B, T, H, 64], the decay w in (0, 1), u [H, 64] and h0."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, T, H, 64)).astype(np.float32) for _ in range(3))
    if decay == "weak":
        # k / sqrt(T) keeps the nearly undecayed state O(1) (chip_smoke.py)
        k *= T ** -0.5
        w = rng.uniform(0.999, 1.0, size=(B, T, H, 64))
    elif decay == "underflow":   # 1e-6, a quarter underflowed to 0
        w = np.where(rng.random((B, T, H, 64)) < 0.25, 0.0, 1e-6)
    else:                        # the model's: exp(-exp(w0 + noise)), w0 ~ N(0, 0.5)
        w0 = 0.5 * rng.normal(size=(H, 64))
        w = np.exp(-np.exp(w0 + 0.3 * rng.normal(size=(B, T, H, 64))))
    u = 0.5 * rng.normal(size=(H, 64))
    h0 = rng.normal(size=(B, H, 64, 64)).astype(np.float32) if with_h0 else None
    return [torch.from_numpy(a) for a in (r, k, v, w.astype(np.float32), u.astype(np.float32))], (
        None if h0 is None else torch.from_numpy(h0))


WKV_CASES = {
    # name: B, T, H, decay, h0
    "model decays": (2, 512, 4, "model", False),
    "weak decay over 64 chunks": (1, 1024, 2, "weak", False),
    "strong decay with underflow": (1, 256, 4, "underflow", False),
    "from h0": (2, 256, 3, "model", True),
    "rwkv6-1.6b heads, B = 1": (1, 256, 32, "model", False),
}


@pytest.mark.parametrize("name", sorted(WKV_CASES))
def test_wkv_kernel_matches_plain(dev, name):
    B, T, H, decay, with_h0 = WKV_CASES[name]
    arrays, h0 = _wkv_arrays(B, T, H, decay, seed=T + H, with_h0=with_h0)
    r, k, v, w, u = (a.to(dev) for a in arrays)
    h0 = None if h0 is None else h0.to(dev)
    logw = log_decay(w)
    y, h = wkv6_cuda(r, k, v, logw, u, h0=h0)
    want_y, want_h = wkv6_plain(r, k, v, logw, u, h0=h0)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    torch.testing.assert_close(y, want_y, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(h, want_h, rtol=2e-4, atol=2e-4)


# the backward's own cases: a single chunk, and rwkv6-1.6b's 32 heads at
# B = 8 (two CTAs of wkv6_bwd_chunk on each SM, many groups of chunks)
WKV_BWD_CASES = {
    **WKV_CASES,
    "one chunk": (1, 16, 4, "model", False),
    "rwkv6-1.6b heads, B = 8": (8, 2048, 32, "model", False),
}


def _wkv_bwd_inputs(name, dev, final):
    B, T, H, decay, with_h0 = WKV_BWD_CASES[name]
    arrays, h0 = _wkv_arrays(B, T, H, decay, seed=T + H, with_h0=with_h0)
    r, k, v, w, u = (a.to(dev) for a in arrays)
    h0 = None if h0 is None else h0.to(dev)
    logw = log_decay(w)
    y, h, hs = wkv6_cuda(r, k, v, logw, u, h0=h0, states=True)
    g = torch.Generator(device="cpu").manual_seed(T)
    dy = torch.randn(y.shape, generator=g).to(dev)
    if decay == "weak":
        dy *= T ** -0.5      # as the forward's case scales k (see the SSD's)
    kw = {"dh_final": torch.randn(h.shape, generator=g).to(dev)} if final else {}
    return (r, k, v, logw, u, hs, dy), kw


@pytest.mark.parametrize("final", [False, True], ids=["dh 0", "dh"])
@pytest.mark.parametrize("name", sorted(WKV_BWD_CASES))
def test_wkv_bwd_kernel_matches_plain(dev, name, final):
    args, kw = _wkv_bwd_inputs(name, dev, final)
    kernels.reset_launch_counts()
    got = wkv6_bwd_cuda(*args, **kw)
    want = wkv6_bwd_plain(*args, **kw)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["rwkv6_wkv_bwd"] == 1
    _bwd_close(got, want, summed={3, 4})
    again = wkv6_bwd_cuda(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_wkv_states_are_the_plain_chunk_starts(dev):
    arrays, h0 = _wkv_arrays(2, 64, 3, "model", seed=2, with_h0=True)
    r, k, v, w, u = (a.to(dev) for a in arrays)
    logw = log_decay(w)
    got = wkv6_cuda(r, k, v, logw, u, h0=h0.to(dev), states=True)[2]
    want = wkv6_plain(r, k, v, logw, u, h0=h0.to(dev), states=True)[2]
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("T,C", [(37, 64), (300, 16)])
def test_wkv_gradient_on_the_card_matches_the_plain_function(dev, T, C):
    # ops.wkv6 under grad: padded length and width, the clamp, both kernels
    arrays, _ = _wkv_arrays(2, T, 3, "underflow" if C == 16 else "model", seed=T)
    arrays = [a[..., :C].contiguous().to(dev) for a in arrays]
    got_in = [a.clone().requires_grad_() for a in arrays]
    want_in = [a.clone().requires_grad_() for a in arrays]
    g = torch.Generator(device="cpu").manual_seed(1)
    dy = torch.randn((2, T, 3, C), generator=g).to(dev)
    kernels.reset_launch_counts()
    y, _ = wkv6(*got_in)
    (y * dy).sum().backward()
    counts = kernels.launch_counts()
    assert counts["rwkv6_wkv"] == 1 and counts["rwkv6_wkv_bwd"] == 1
    y_want, _ = wkv6(*want_in, impl="torch")
    (y_want * dy).sum().backward()
    for i, (a, b) in enumerate(zip(got_in, want_in)):
        rel = float((a.grad - b.grad).norm() / b.grad.norm())
        assert rel < BWD_SUM_REL_L2 * 10, (i, rel)


@pytest.mark.parametrize("L,P", [(300, 64), (200, 16)])
def test_ssd_gradient_on_the_card_matches_the_plain_function(dev, L, P):
    arrays, _ = _ssd_arrays(2, L, 3, "softplus", seed=L)
    x, dA, Bm, Cm = (a.to(dev) for a in arrays)
    arrays = [x[..., :P].contiguous(), dA, Bm[..., :P].contiguous(), Cm[..., :P].contiguous()]
    got_in = [a.clone().requires_grad_() for a in arrays]
    want_in = [a.clone().requires_grad_() for a in arrays]
    g = torch.Generator(device="cpu").manual_seed(2)
    dy = torch.randn((2, L, 3, P), generator=g).to(dev)
    kernels.reset_launch_counts()
    y, _ = ssd(*got_in, chunk=128)
    (y * dy).sum().backward()
    counts = kernels.launch_counts()
    assert counts["mamba2_ssd"] == 1 and counts["mamba2_ssd_bwd"] == 1
    y_want, _ = ssd(*want_in, chunk=128, impl="torch")
    (y_want * dy).sum().backward()
    for i, (a, b) in enumerate(zip(got_in, want_in)):
        rel = float((a.grad - b.grad).norm() / b.grad.norm())
        assert rel < BWD_SUM_REL_L2 * 10, (i, rel)


def test_wkv_auto_impl_pads_a_ragged_length_from_h0_and_counts(dev):
    arrays, h0 = _wkv_arrays(2, 37, 3, "model", seed=4, with_h0=True)
    r, k, v, w, u = (a.to(dev) for a in arrays)
    h0 = h0.to(dev)
    kernels.reset_launch_counts()
    y, h = wkv6(r, k, v, w, u, h0=h0)
    assert kernels.launch_counts()["rwkv6_wkv"] == 1
    assert y.shape == (2, 37, 3, 64) and h.shape == (2, 3, 64, 64)
    for want_y, want_h in (wkv6(r, k, v, w, u, h0=h0, impl="torch"),
                           wkv6_scan(r, k, v, w, u, h0=h0)):
        torch.testing.assert_close(y, want_y, rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(h, want_h, rtol=2e-4, atol=2e-4)


def test_wkv_kernel_refuses_what_it_does_not_take(dev):
    arrays, _ = _wkv_arrays(1, 32, 2, "model", seed=1)
    r, k, v, w, u = (a.to(dev) for a in arrays)
    logw = log_decay(w)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="float32"):
        wkv6_cuda(r.double(), k, v, logw, u)
    with pytest.raises(ValueError, match="but the block is on"):
        wkv6_cuda(r, k, v, logw.cpu(), u)
    with pytest.raises(ValueError, match="multiple of the kernel's chunk"):
        wkv6_cuda(*(a[:, :20].contiguous() for a in (r, k, v, logw)), u)
    with pytest.raises(ValueError, match="head dim 64"):
        wkv6_cuda(*(a[..., :32].contiguous() for a in (r, k, v, logw)), u[:, :32].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        wkv6_cuda(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, logw, u)
    assert kernels.launch_counts()["rwkv6_wkv"] == 0


# the kernels each family's prefill launches through impl="auto"
SMOKE_KERNELS = {"dense": ("flash_attention",), "moe": ("flash_attention",),
                 "hybrid": ("mamba2_ssd", "flash_attention"), "rwkv": ("rwkv6_wkv",)}
SMOKE_ARCHS = ["llama3.2-1b", "qwen2-0.5b", "qwen3-14b", "granite-20b", "chameleon-34b",
               "zamba2-7b", "rwkv6-1.6b", "granite-moe-3b-a800m", "qwen3-moe-30b-a3b"]
# the card's logits against the CPU run's: the reference's decode-vs-forward
# tolerance (tests/test_models_smoke.py), |a - b| <= 8e-2 (1 + |b|)
SMOKE_TOL = 8e-2


@pytest.mark.parametrize("arch", SMOKE_ARCHS)
def test_smoke_arch_runs_its_kernels_on_the_card(dev, arch):
    """A smoke config's forward on the card launches the family's kernels
    at the padded widths, gives the CPU run's logits, and serves."""
    cfg = smoke_config(arch)
    cpu = build_lm(cfg, device="cpu", seed=5)
    card = build_lm(cfg, device="cpu", seed=5).to(dev)
    tokens = torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 40), np.int64))
    want = api.make_forward_fn(cpu)({"tokens": tokens}).float()
    kernels.reset_launch_counts()
    got = api.make_forward_fn(card)({"tokens": tokens.to(dev)}).float().cpu()
    counts = kernels.launch_counts()
    for name in SMOKE_KERNELS[cfg.family]:
        assert counts[name] >= 1, (name, counts)
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    diff = (got - want).abs()
    assert not bool((diff > SMOKE_TOL * (1 + want.abs())).any()), float(diff.max())
    out = Server(cfg, card, device=dev).generate(tokens[:, :24].numpy(), max_new_tokens=4)
    assert out.shape == (2, 28)


def test_mesh_query_on_the_card_equals_single_host(dev, tmp_path):
    """Four LocalTransport hosts over a stored RSP on the card: every host's
    answer equals the single-host answer on the card bit for bit, and the
    sketch kernels ran once for every block a host read (no host died and
    the queries read all their blocks, so once a block the fold read)."""
    import json

    from repro_torch import rsp
    from repro_torch.distributed import LocalTransport, run_local_hosts

    data = _data(16 * 1200, 6, classes=2)
    rsp.partition(data, blocks=16, seed=2, num_classes=2, backend="np", device="cpu") \
        .save(str(tmp_path))
    ds = rsp.open(str(tmp_path), device=dev, cache_blocks=16)
    queries = {"block_sketch": ("p90", dict(max_blocks=12, use_sketches=False, seed=4)),
               "plan_sketch": ("mean", dict(where="c0 > 1.5", columns=(0, 5), max_blocks=10,
                                            use_sketches=False, seed=5))}

    def sig(r):
        return json.dumps([[np.asarray(getattr(a, f)).ravel().tolist()
                            for f in ("estimate", "ci_lo", "ci_hi")] for a in r.aggregates]
                          + [r.blocks_read, r.converged])

    for kernel, (agg, kw) in queries.items():
        single = ds.query(agg, **kw)

        def run(t):
            dds = ds.distribute(t, straggler_grace=5.0, poll_interval=0.01)
            return sig(dds.query(agg, **kw)), dds.executor.stats().accesses

        kernels.reset_launch_counts()
        out = run_local_hosts(LocalTransport.group(4), run)
        counts = kernels.launch_counts()
        assert all(s == sig(single) for s, _ in out)
        assert counts[kernel] == sum(n for _, n in out) == single.blocks_read
    ds.close()


def test_collective_partition_on_the_card_equals_the_cuda_backend(dev):
    """Two gloo ranks, each on cuda:0: rank k's block equals block k of the
    cuda backend's partition on the card, with one rsp_shuffle launch a
    rank."""
    from repro_torch.distributed import serve_store
    from test_torch_mesh import assert_ok, gloo_init, marked, run_children

    source = r"""
import os, json
import numpy as np, torch, torch.distributed as dist
from repro_torch import kernels, rsp
from repro_torch.core import distributed_rsp_partition
rank, d = int(os.environ["RSP_PROCESS_ID"]), int(os.environ["RSP_NUM_PROCESSES"])
%s
rng = np.random.default_rng(0)
data = rng.normal(size=(8000, 29)).astype(np.float32)
want = rsp.partition(data, blocks=d, original_blocks=d, backend="cuda", seed=5,
                     summaries=False, device="cuda:0").stacked()
n = data.shape[0] // d
kernels.reset_launch_counts()
mine = distributed_rsp_partition(torch.from_numpy(data[rank * n:(rank + 1) * n]).cuda(), 5)
launches = kernels.launch_counts()["rsp_shuffle"]
print("RESULT " + json.dumps({"equal": bool(torch.equal(mine, want[rank])),
                              "device": str(mine.device), "launches": launches}), flush=True)
dist.barrier()
dist.destroy_process_group()
print("PARTITION_OK", flush=True)
""" % gloo_init()
    server = serve_store()
    children = run_children(source, 2, env={"RSP_STORE": f"127.0.0.1:{server.port}"},
                            timeout=300.0)
    assert_ok(children, "PARTITION_OK")
    for c in children:
        assert marked(c, "RESULT ") == {"equal": True, "device": "cuda:0", "launches": 1}


# ---------------------------------------------------------------------------
# the autotuner's configurations and the torch partition backend
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile", [1100, 110])
def test_every_tuned_shuffle_configuration_copies_the_plain_gather(dev, tile):
    from repro_torch.kernels.rsp_shuffle import shuffle_candidates

    x = torch.from_numpy(_data(4 * 3 * tile, 29, seed=tile)).reshape(4, -1, 29).to(dev)
    tp, ip = (torch.from_numpy(a).to(dev) for a in _perms(tile, 4, 3, tile))
    want = rsp_shuffle_plain(x, tp, ip, tile_rows=tile)
    cands = shuffle_candidates(tile, 29 * 4)
    assert {c.impl for c in cands} == {"cuda"}
    for c in cands:
        got = rsp_shuffle_cuda(x, tp, ip, tile_rows=tile, path=c.get("path"),
                               threads=c.get("threads"))
        assert torch.equal(got, want), c.label


@pytest.mark.parametrize("bins", [128, 0])
def test_every_tuned_block_sketch_configuration_matches_plain(dev, bins):
    from repro_torch.kernels.block_sketch.ops import as_config, block_sketch_candidates

    x = torch.from_numpy(_data(110_000, 29, seed=3)).to(dev)
    lo, invw = _block_args(x, bins)
    s2, h2 = block_sketch_plain(x, lo, invw, bins=bins)
    for c in block_sketch_candidates(bins):
        s1, h1 = block_sketch_cuda(x, lo, invw, bins=bins, config=as_config(c))
        _close(s1, s2)
        assert torch.equal(s1[0], s2[0]), c.label
        assert (h1 is None) == (bins == 0) and (h1 is None or torch.equal(h1, h2)), c.label
        again = block_sketch_cuda(x, lo, invw, bins=bins, config=as_config(c))
        assert _same((s1, h1), again), c.label    # one configuration: one fold order


@pytest.mark.parametrize("plan", [QUERY_B, QUERY_C], ids=["query b", "query c"])
def test_every_tuned_plan_configuration_matches_plain(dev, plan):
    from repro_torch.kernels.plan.ops import as_config, plan_candidates

    x = torch.from_numpy(_data(110_000, 29, classes=2, seed=4)).to(dev)
    fp = len(plan.resolve_columns(29))
    lo = torch.full((fp,), -8.0, device=dev)
    invw = torch.full((fp,), 128 / 20.0, device=dev)
    want = plan_sketch_plain(x, plan, lo, invw, bins=128)
    arrays = {p: PlanArrays.build(plan, 29, dev, path=p) for p in ("stage", "gather")}
    for c in plan_candidates(128):
        got = plan_sketch_cuda(x, arrays[c.get("path")], lo, invw, bins=128,
                               config=as_config(c))
        _close(got[0], want[0])
        assert torch.equal(got[0][0::5], want[0][0::5]) and torch.equal(got[2], want[2]), c.label
        assert torch.equal(got[1], want[1]), c.label


def test_the_tuner_on_the_card_measures_kernel_configurations_only(dev, tmp_path, monkeypatch):
    """With tuning on, the auto paths measure once a key, persist the
    winner in their own file and launch it; every record is a kernel
    configuration, and the answers equal the untuned ones."""
    import json

    from repro_torch import rsp
    from repro_torch.kernels import autotune

    x = torch.from_numpy(_data(20_000, 29, classes=2, seed=5)).to(dev)
    monkeypatch.setenv("REPRO_AUTOTUNE", "off")
    want = (block_sketch(x, bins=32, lo=-8.0, hi=8.0).mean,
            plan_sketch(x, QUERY_C, bins=32, lo=-8.0, hi=8.0).sketches[1].mean,
            rsp.partition(x.cpu().numpy(), blocks=10, seed=3, summaries=False).stacked())
    path = tmp_path / "autotune_torch.json"
    monkeypatch.setenv("REPRO_AUTOTUNE", "on")
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(path))
    tuner = autotune.Autotuner()
    monkeypatch.setattr(autotune, "_TUNER", tuner)
    got = (block_sketch(x, bins=32, lo=-8.0, hi=8.0).mean,
           plan_sketch(x, QUERY_C, bins=32, lo=-8.0, hi=8.0).sketches[1].mean,
           rsp.partition(x.cpu().numpy(), blocks=10, seed=3, summaries=False).stacked())
    assert tuner.measurements == 3
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
    assert torch.equal(got[2], want[2])
    records = json.loads(path.read_text())
    assert {k.split("|")[0] for k in records} == {"block_sketch", "plan_sketch", "rsp_shuffle"}
    for rec in records.values():
        assert rec["impl"] == "cuda" and not rec["fallback"] and rec["measured_us"]
    block_sketch(x, bins=32, lo=-8.0, hi=8.0)
    assert tuner.measurements == 3            # a cache hit


def test_torch_backend_on_the_card_equals_the_cpu(dev):
    from repro_torch import rsp
    from repro_torch.core.partition import is_partition

    data = _data(12_000, 5, classes=3)
    labels = (data[:, -1]).astype(np.int64)
    for arr in (data, labels, data.reshape(12_000, 5, 1)):
        kernels.reset_launch_counts()
        on_card = rsp.partition(arr, blocks=10, seed=7, backend="torch", summaries=False)
        on_cpu = rsp.partition(arr, blocks=10, seed=7, backend="torch", device="cpu",
                               summaries=False)
        assert on_card.stacked().device.type == "cuda"
        assert torch.equal(on_card.stacked().cpu(), on_cpu.stacked())
        assert is_partition(on_card.stacked(), arr)
        assert sum(kernels.launch_counts().values()) == 0   # no kernel on this path


def _to(tree, dev):
    out = {}
    for k, v in tree.items():
        out[k] = _to(v, dev) if isinstance(v, dict) else v.to(dev)
    return out


def _smoke_batch(cfg, dev, seed=1):
    if cfg.family == "encoder":
        cell = dataclasses.replace(SHAPES["train_4k"], seq_len=150, global_batch=2)
        return api.concrete_inputs(cfg, cell, seed=seed, device=dev)
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 151), dtype=np.int32)
    return {"tokens": torch.from_numpy(toks).to(dev)}


def _grads(cfg, state, batch):
    model = build_lm(cfg, state["params"], device=batch[next(iter(batch))].device,
                     trainable=True)
    loss, _ = api.make_loss_fn(model)(batch)
    loss.backward()
    return loss.detach(), param_grads(model, state["params"])


@pytest.mark.parametrize("arch", ["llama3.2-1b", "hubert-xlarge"])
def test_smoke_training_gradients_on_the_card_match_the_cpu(dev, arch):
    # every attention of the step through the kernels (head dim 16 padded to
    # 64), twice a layer forward (remat) and once backward; the gradients
    # within the CPU parity tests' tolerances of the plain versions' on the
    # host (tests/test_torch_train.py)
    cfg = smoke_config(arch)
    state = init_state(cfg, seed=0, device="cpu")
    batch = _smoke_batch(cfg, "cpu")
    want_loss, want = _grads(cfg, state, batch)
    kernels.reset_launch_counts()
    loss, got = _grads(cfg, _to(state, dev), _to(batch, dev))
    torch.cuda.synchronize()
    counts = kernels.launch_counts()
    assert counts["flash_attention"] == 2 * cfg.num_layers
    assert counts["flash_attention_bwd"] == cfg.num_layers
    assert abs(float(loss) - float(want_loss)) < 1e-2
    for (path, a), (_, b) in zip(iter_leaves(got), iter_leaves(want)):
        a, b = a.float().cpu(), b.float()
        assert float((a - b).norm() / b.norm()) < 3e-2, path
        assert float((a - b).abs().max() / b.abs().max()) < 5e-2, path


# the fewest layers holding every kernel of a family (zamba2: one Mamba2
# layer after one shared-block call), as chip_smoke.py's phase 10b cuts them
FAMILY_CUT = {"granite-moe-3b-a800m": 2, "zamba2-7b": 1, "rwkv6-1.6b": 2}
PLAIN = {"moe": {"attn_impl": "torch"}, "hybrid": {"attn_impl": "torch", "ssd_impl": "torch"},
         "rwkv": {"wkv_impl": "torch"}}


def _family_launches(cfg) -> dict:
    """Each kernel's launches in one training step: the forward twice a
    layer (remat), the backward once; zamba2's attention once a
    shared-block call."""
    L = cfg.num_layers
    if cfg.family == "rwkv":
        return {"rwkv6_wkv": 2 * L, "rwkv6_wkv_bwd": L}
    if cfg.family == "hybrid":
        full, _, rem = hybrid_layout(cfg)
        inv = full + (1 if rem else 0)
        return {"mamba2_ssd": 2 * L, "mamba2_ssd_bwd": L, "flash_attention": 2 * inv,
                "flash_attention_bwd": inv}
    return {"flash_attention": 2 * L, "flash_attention_bwd": L}


@pytest.mark.parametrize("arch", sorted(FAMILY_CUT))
def test_family_gradients_with_the_kernels_match_the_plain_versions(dev, arch):
    # a smoke config cut to FAMILY_CUT layers on the card: one step's loss
    # and gradients with every kernel (the widths padded to the kernels')
    # against the same step with the plain versions, within the CPU parity
    # tests' tolerances (tests/test_torch_train.py); the kernels launched as
    # a training step launches them; a leaf with no gradient in the plain
    # step (rwkv6's lora_a: lora_b starts at zero) has none with the kernels
    from repro_torch.models.common import softmax_cross_entropy

    cfg = dataclasses.replace(smoke_config(arch), num_layers=FAMILY_CUT[arch])
    state = init_state(cfg, seed=0, device=dev)
    tokens = _smoke_batch(cfg, dev)["tokens"]
    losses, grads = [], []
    for impls in ({}, PLAIN[cfg.family]):
        kernels.reset_launch_counts()
        model = build_lm(cfg, state["params"], device=dev, trainable=True)
        h, _, aux = model.hidden_aux(tokens[:, :-1], **impls)
        loss = softmax_cross_entropy(model.logits(h), tokens[:, 1:]) + aux
        loss.backward()
        torch.cuda.synchronize()
        counts = {k: v for k, v in kernels.launch_counts().items() if v}
        assert counts == (_family_launches(cfg) if not impls else {}), counts
        losses.append(float(loss.detach()))
        grads.append(param_grads(model, state["params"]))
    assert abs(losses[0] - losses[1]) < 1e-2
    for (path, a), (_, b) in zip(iter_leaves(grads[0]), iter_leaves(grads[1])):
        a, b = a.float(), b.float()
        if not b.any():
            assert not a.any(), path
            continue
        assert float((a - b).norm() / b.norm()) < 3e-2, path
        assert float((a - b).abs().max() / b.abs().max()) < 5e-2, path


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-3b-a800m", "zamba2-7b",
                                  "rwkv6-1.6b"])
def test_smoke_train_steps_on_the_card(dev, arch):
    cfg = smoke_config(arch)
    step = make_train_step(cfg, AdamWConfig(lr=1e-2), TrainConfig(total_steps=4, warmup_steps=1))
    state = init_state(cfg, seed=0, device=dev)
    losses = []
    for i in range(4):
        state, m = step(state, _smoke_batch(cfg, dev, seed=i % 2))
        losses.append(float(m["loss"]))
    assert int(state["opt"]["step"]) == 4 and np.isfinite(losses).all()
    assert losses[-1] < losses[1], losses
    assert all(p.dtype == torch.bfloat16 and p.is_cuda for _, p in iter_leaves(state["params"]))


DRY_RUN_FAMILIES = """
import json
from repro_torch import kernels
from repro_torch.configs import ShapeCell, smoke_config
from repro_torch.launch.dryrun import dryrun_cell, init_fake_world
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.roofline import family_launches

init_fake_world(1)
mesh = make_host_mesh((1, 1), ("data", "model"), device_type="cuda")
cell = ShapeCell("train_smoke", "train", 32, 4)
out = {}
for arch in ("llama3.2-1b", "granite-moe-3b-a800m", "zamba2-7b", "rwkv6-1.6b"):
    cfg = smoke_config(arch)
    r = dryrun_cell(arch, cell.name, cfg=cfg, cell=cell, mesh=mesh)
    out[arch] = [{k: v["launches"] for k, v in r["analysis"]["kernels"].items()},
                 family_launches(cfg)]
print(json.dumps({"families": out, "counts": kernels.launch_counts()}))
"""


def test_a_dry_run_records_each_training_steps_kernel_launches(dev):
    """A smoke training step traced on fake CUDA tensors (``launch/dryrun.py``
    on a fake world of one rank, in a child: the fake process group is
    process-wide) records the launches the real step makes
    (``family_launches``), and launches nothing."""
    import json
    import os
    import pathlib
    import subprocess
    import sys

    src = pathlib.Path(__file__).resolve().parent.parent / "src"
    proc = subprocess.run([sys.executable, "-c", DRY_RUN_FAMILIES], capture_output=True,
                          text=True, timeout=120, env=dict(os.environ, PYTHONPATH=str(src)))
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert all(v == 0 for v in got["counts"].values()), got["counts"]
    for arch, (recorded, expected) in got["families"].items():
        assert recorded == expected, arch
