"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and the CUDA toolkit: it carries the
``cuda`` marker and skips itself when no card is present.  The file imports
neither ``jax`` nor ``repro``, so it runs on a machine with the card alone:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Tolerances: shuffles, histograms, counts and ``nsel`` exact; moments within
1e-5 relative (the kernels sum in another order than the plain versions).
``chip_smoke.py`` repeats these checks at the main path's full shapes.
"""

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.block_sketch import block_sketch
from repro_torch.kernels.block_sketch.kernel import block_sketch_cuda, block_sketch_plain
from repro_torch.kernels.plan import PlanArrays, QueryPlan, plan_sketch
from repro_torch.kernels.plan.kernel import plan_sketch_cuda, plan_sketch_plain
from repro_torch.kernels.rsp_shuffle import rsp_shuffle_cuda, rsp_shuffle_plain

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
    assert n1 == n2
    _close(s1, s2)
    assert (h1 is None and h2 is None) or torch.equal(h1, h2)


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
