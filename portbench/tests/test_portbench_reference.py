"""The plain references against the program's host path at small sizes,
the frozen work counts at the cells' shapes, and the metric arithmetic on a
synthetic trace.  A test may import the program; the references may not."""

from __future__ import annotations

import dataclasses
import math

import pytest
import torch

from portbench.tests.helpers import CELLS, CONFIGS, SMALL, config, harness, run_small


def _tree(specs, seed=0):
    from portbench.reference.common import set_path

    g = torch.Generator().manual_seed(seed)
    tree = {}
    for path, shape, mean, std, *draw in specs:
        z = torch.randn(shape, generator=g)
        set_path(tree, path, draw[0](z) if draw else z * std + mean)
    return tree


def test_wkv_matches_the_recurrence():
    from portbench.reference.rwkv import wkv
    from repro_torch.kernels.rwkv6_wkv import wkv6_scan

    g = torch.Generator().manual_seed(1)
    B, T, H, C = 2, 37, 3, 8
    r, k, v = (torch.randn(B, T, H, C, generator=g) for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(B, T, H, C, generator=g)))
    u = torch.randn(H, C, generator=g)
    want, _ = wkv6_scan(r, k, v, w, u)
    got = wkv(r, k, v, torch.log(w), u)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


def test_ssd_matches_the_recurrence():
    from portbench.reference.hybrid import ssd
    from repro_torch.kernels.mamba2_ssd import ssd_recurrence

    g = torch.Generator().manual_seed(2)
    B, L, H, P, N = 2, 32, 3, 4, 5
    xbar = torch.randn(B, L, H, P, generator=g)
    dA = -torch.rand(B, L, H, generator=g)
    Bm, Cm = torch.randn(B, L, N, generator=g), torch.randn(B, L, N, generator=g)
    want, _ = ssd_recurrence(xbar, dA, Bm, Cm)
    got = ssd(xbar, dA, Bm, Cm, chunk=8)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", CONFIGS)
def test_forward_matches_the_program(name):
    from portbench.drivers.common import reference_module
    from portbench.drivers.train import model_config
    from portbench.reference.common import Precision
    from repro_torch.models.common import iter_leaves
    from repro_torch.models.transformer import build_lm, model_specs

    conf = config(name)
    cfg = {**conf["run"], **SMALL[conf["run"]["family"]]}
    ref = reference_module(conf)
    specs = ref.leaf_specs(cfg)
    want = {p: s.shape for p, s in iter_leaves(model_specs(model_config(cfg)))}
    assert {spec[0]: spec[1] for spec in specs} == want           # the same layout
    tree = _tree(specs)
    tokens = torch.randint(0, cfg["vocab_size"], (2, 32), generator=torch.Generator()
                           .manual_seed(3))
    with torch.no_grad():
        prog = build_lm(model_config(cfg), tree, device="cpu")(tokens)[0].float()
        plain = ref.logits(tree, tokens, cfg, Precision())
        low = ref.logits(tree, tokens, cfg, Precision("fp8"))
    rms = lambda a: float(torch.sqrt(((a - plain) ** 2).mean() / plain.var()))  # noqa: E731
    # bf16 activations against float32: a few percent; the fp8 control far further
    assert rms(prog) < 0.06
    assert rms(low) > 3 * rms(prog)


def test_adamw_matches_the_program():
    from portbench.reference.adamw import AdamW
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update

    g = torch.Generator().manual_seed(4)
    params = {"a": torch.randn(5, 7, generator=g), "b": torch.randn(3, generator=g)}
    opt = dict(lr=1e-2, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, grad_clip=1.0)
    state = adamw_init(params)
    mine = AdamW([params["a"].clone(), params["b"].clone()], **opt)
    for _ in range(3):
        grads = {"a": torch.randn(5, 7, generator=g), "b": torch.randn(3, generator=g)}
        state, _, _ = adamw_update(state, grads, AdamWConfig(**opt))
        mine.step([grads["a"], grads["b"]])
    for got, want in zip(mine.params, (state["master"]["a"], state["master"]["b"])):
        assert torch.allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", CELLS)
def test_a_small_run_is_correct_and_the_control_is_not_closer(name):
    res = run_small(name, 20240001, control="fp8", judge=False)
    prog, low = res["checks"], res["control"]
    assert prog["rows_not_in_corpus"]["value"] == 0
    assert prog["partition_defects"]["value"] == 0
    worse = [k for k in low if low[k] > 2 * prog[k]["value"]]
    assert worse, (prog, low)


def test_work_counts_at_the_cells_shapes():
    from portbench.work import flash, model_ops, ssd, wkv

    # WKV at [8, 2048, 32, 64], chunks of 16: 128 chunks a (row, head), 120
    # strictly lower pairs; a chunk's operations
    # 1,024 + 5,120 + 64 + 38,400 + 3,072 + 131,072 + 15,360 + 3,072 + 131,072 + 8,192
    per_chunk = 336_448
    assert wkv.wkv_work(8, 2048, 32) == (8 * 32 * 128 * per_chunk, 675_291_136)
    assert wkv.wkv_work(16, 2048, 32)[0] == 2 * 8 * 32 * 128 * per_chunk
    # its backward: 8 Q C^2 + 2 Q^2 C + 17 pairs C + 12 Q C = 699,904 a chunk
    assert wkv.wkv_bwd_work(8, 2048, 32)[0] == 8 * 32 * 128 * 699_904
    assert wkv.wkv_bwd_work(8, 2048, 32)[1] == 4 * (9 * 8 * 2048 * 32 * 64
                                                    + 8 * 128 * 32 * 64 * 64 + 2 * 32 * 64)
    # SSD at [8, 2048, 112, 64], N 64, chunks of 128: 8,256 causal pairs a chunk
    tri = 128 * 129 // 2
    assert ssd.ssd_work(8, 2048, 112)[0] == 2 * 8 * 16 * (tri * 64 + 112 * (
        tri * 64 + 2 * 128 * 64 * 64))
    # flash at [8, 32, 2048, 112], causal: 2,098,176 pairs
    assert flash.flash_work(8, 32, 32, 2048, 112, True)[0] == 4 * 8 * 32 * 112 * 2_098_176
    assert flash.flash_bwd_work(8, 32, 32, 2048, 112, True)[0] == 10 * 8 * 32 * 112 * 2_098_176
    rwkv, zamba = config("rwkv6-1.6b")["run"], config("zamba2-7b-24l")["run"]
    assert model_ops.train_ops(rwkv, 8, 2048) == (141_836_999_983_104, 2_670_446_247_936)
    assert model_ops.train_ops(zamba, 8, 2048) == (287_991_851_384_832, 4_953_219_268_608)
    bf16, f32 = model_ops.rwkv_score_ops(rwkv, 16, 2048)
    assert bf16 == 2 * 24 * (6 * 2048**2 + 2 * 2048 * 7168) * 32768 + 2 * 2048 * 65536 * 32768
    assert f32 == 2 * 24 * 12 * 2048 * 32 * 32768 + 24 * wkv.wkv_work(16, 2048, 32)[0]


def test_work_counts_equal_the_programs():
    from portbench.drivers.train import model_config
    from portbench.work import flash, model_ops, ssd, wkv
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.mamba2_ssd import ssd_bwd_work, ssd_work
    from repro_torch.kernels.rwkv6_wkv import wkv_bwd_work, wkv_work
    from repro_torch.launch.roofline import family_train_ops

    assert wkv.wkv_work(8, 2048, 32) == wkv_work(8, 2048, 32)
    assert wkv.wkv_bwd_work(8, 2048, 32) == wkv_bwd_work(8, 2048, 32)
    assert ssd.ssd_work(8, 2048, 112) == ssd_work(8, 2048, 112)
    assert ssd.ssd_bwd_work(8, 2048, 112) == ssd_bwd_work(8, 2048, 112)
    assert flash.flash_work(8, 32, 32, 2048, 112, True, lse=True) == fk.flash_work(
        8, 32, 32, 2048, 112, True, lse=True)
    assert flash.flash_bwd_work(8, 32, 32, 2048, 112, True) == fk.flash_bwd_work(
        8, 32, 32, 2048, 112, True)
    for name in CONFIGS:
        cfg = config(name)["run"]
        assert model_ops.train_ops(cfg, 8, 2048) == family_train_ops(model_config(cfg), 8, 2048)


def _trace():
    from portbench.trace import DeviceEvent, HostOp, Trace

    ms = 1_000_000
    window = HostOp("portbench.window", 0, 100 * ms, 1)
    step = HostOp("portbench.step", 0, 90 * ms, 1)
    loader = HostOp("portbench.loader", 90 * ms, 100 * ms, 1)
    fwd = HostOp("portbench.entry.wkv6", 10 * ms, 20 * ms, 1)
    launch = HostOp("aten::add", 11 * ms, 12 * ms, 1)
    bwd = HostOp("autograd::engine::evaluate_function: WKV6Backward", 30 * ms, 40 * ms, 2)
    node = HostOp("WKV6Backward", 31 * ms, 39 * ms, 2)      # the same call, nested
    outside = HostOp("aten::mm", 50 * ms, 51 * ms, 1)
    dev = [DeviceEvent("wkv6_chunks", 12 * ms, 8 * ms, fwd),
           DeviceEvent("void at::native::add_kernel", 15 * ms, 10 * ms, launch),  # overlaps
           DeviceEvent("wkv6_bwd_chunk", 40 * ms, 20 * ms, bwd),
           DeviceEvent("gemm", 70 * ms, 10 * ms, outside)]
    return Trace((0, 100 * ms), dev, [window, step, loader, fwd, launch, bwd, node, outside])


def test_metric_arithmetic_on_a_synthetic_trace():
    from portbench.metrics import (aten_kernel_ms, device_idle_share, loader_wait_ms,
                                   scan_roofline, step_mfu)
    from portbench.work import model_ops, peaks, wkv
    from portbench.trace import longest_gaps

    tr = _trace()
    # busy: [12, 25] + [40, 60] + [70, 80] ms = 43 ms of 100
    assert tr.busy_s() == pytest.approx(0.043)
    # idle [0, 12), [25, 40), [60, 70) under the step span, [80, 100) half under the loader's
    assert longest_gaps(tr)[:2] == [["loader", pytest.approx(0.02)], ["step", pytest.approx(0.015)]]
    rwkv = config("rwkv6-1.6b")["run"]
    wl = {"traffic": {"batch": 8, "length": 2049}}      # an rwkv6 training step's shapes
    ctx = harness.Readings(metric="x.train", trace=tr, steps=2, config=rwkv, workload=wl,
                           spans={"loader": 0.004}, span_counts={"loader": 2})
    assert device_idle_share.read(ctx) == pytest.approx(57.0)
    assert aten_kernel_ms.read(ctx) == pytest.approx(5.0)
    assert loader_wait_ms.read(ctx) == pytest.approx(2.0)
    bound = (peaks.bound_seconds(*wkv.wkv_work(8, 2048, 32))
             + peaks.bound_seconds(*wkv.wkv_bwd_work(8, 2048, 32)))
    # the entries' device time: 8 ms launched in the forward, 10 ms by an op inside it, 20 ms
    assert scan_roofline.read(ctx) == pytest.approx(100 * bound / 0.038)
    least = peaks.least_seconds(*model_ops.train_ops(rwkv, 8, 2048))
    assert step_mfu.read(ctx) == pytest.approx(100 * least / 0.05)
    assert math.isclose(peaks.bound_seconds(67e12, 1.0), 1.0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    res = harness.run_cell(name, 777, 5.0, False)
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"


def test_dataclass_fields_cover_the_run_config():
    from repro_torch.models.config import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    for name in CONFIGS:
        assert set(config(name)["run"]) <= names
