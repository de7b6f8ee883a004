"""The port's roofline arithmetic and report against the reference's.

``repro_torch.configs``' cells, ``models.common.param_count``,
``launch.roofline.model_flops``, ``roofline_terms``, ``summarize_cell``
and ``launch.report``'s tables are held to the reference's on the same
inputs (the reference's ``launch.mesh`` constants monkeypatched to the
port's H100 figures; no reference file changes).  The recorder's FLOP
count is held to the reference analyzer's loop test, the kernels'
shape-only path is checked launcher by launcher on fake tensors, and the
model-level bounds moved out of ``chip_smoke.py`` reproduce the figures
``PERF.md`` prints.
"""

import json
import math

import pytest
import torch

import repro.configs as ref_configs
import repro.launch.mesh as ref_mesh
import repro.launch.report as ref_report
import repro.launch.roofline as ref_roofline
from repro.models import api as ref_api
from repro.models.common import param_count as ref_param_count

from repro_torch import kernels
from repro_torch.configs import ARCHS, SHAPES, SUBQUADRATIC, cell_applicable, cells
from repro_torch.kernels import _cuda
from repro_torch.kernels.flash_attention import (
    flash_attention_bwd_cuda, flash_attention_cuda, flash_bwd_work, flash_work)
from repro_torch.kernels.mamba2_ssd import ssd_bwd_cuda, ssd_bwd_work, ssd_cuda, ssd_work
from repro_torch.kernels.rsp_shuffle import rsp_shuffle_cuda, shuffle_bytes
from repro_torch.kernels.rwkv6_wkv import wkv6_bwd_cuda, wkv6_cuda, wkv_bwd_work, wkv_work
from repro_torch.kernels.rwkv6_wkv.kernel import bwd_groups
from repro_torch.launch import mesh as port_mesh
from repro_torch.launch import report
from repro_torch.launch.dryrun import _fake_mode
from repro_torch.launch.roofline import (
    DryRunRecorder,
    analyze,
    decode_step_bytes,
    family_train_ops,
    model_flops,
    roofline_terms,
    summarize_cell,
    train_flops,
)
from repro_torch.models import api
from repro_torch.models.common import param_count


@pytest.fixture
def h100_reference(monkeypatch):
    """The reference's roofline on the port's constants: the H100's bf16
    peak and HBM rate, and the network between nodes for its ICI link."""
    monkeypatch.setattr(ref_mesh, "PEAK_FLOPS_BF16", port_mesh.PEAK_FLOPS_BF16)
    monkeypatch.setattr(ref_mesh, "HBM_BW", port_mesh.HBM_BW)
    monkeypatch.setattr(ref_mesh, "ICI_LINK_BW", port_mesh.NETWORK_BW)


# ---------------------------------------------------------------------------
# configs and parameter counts
# ---------------------------------------------------------------------------

def test_cells_and_applicability_are_the_references():
    assert cells() == ref_configs.cells()
    assert SUBQUADRATIC == ref_configs.SUBQUADRATIC
    assert list(ARCHS) == list(ref_configs.ARCHS)
    for arch in ARCHS:
        for shape in SHAPES:
            assert cell_applicable(arch, shape) == ref_configs.cell_applicable(arch, shape)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_count_is_the_references(arch):
    assert param_count(api.model_specs(ARCHS[arch])) == \
        ref_param_count(ref_api.model_specs(ref_configs.ARCHS[arch]))


# ---------------------------------------------------------------------------
# model_flops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", cells())
def test_model_flops_is_the_references(arch, shape):
    got = model_flops(ARCHS[arch], SHAPES[shape])
    want = ref_roofline.model_flops(ref_configs.ARCHS[arch], ref_configs.SHAPES[shape])
    assert got == pytest.approx(want, rel=1e-12)


def test_model_flops_sanity():
    # tests/test_dryrun_launch.py's bounds: dense train ~ 6 N D
    f = model_flops(ARCHS["llama3.2-1b"], SHAPES["train_4k"])
    assert 6e15 < f < 1.2e16
    # MoE active params ~3B of 30B -> flops closer to a 3B dense model
    f_moe = model_flops(ARCHS["qwen3-moe-30b-a3b"], SHAPES["train_4k"])
    f_dense30 = 6 * 30e9 * 256 * 4096
    assert f_moe < 0.25 * f_dense30
    # decode processes B tokens, not B*S
    f_dec = model_flops(ARCHS["llama3.2-1b"], SHAPES["decode_32k"])
    assert f_dec < f / 1000


# ---------------------------------------------------------------------------
# the recorder and the roofline terms (tests/test_dryrun_launch.py:57-116)
# ---------------------------------------------------------------------------

def test_recorder_counts_every_iteration_of_a_loop():
    with _fake_mode():
        x = torch.empty((8, 8), dtype=torch.float32, device="cuda")
        rec = DryRunRecorder()
        rec.track_arguments(x)
        with rec:
            for _ in range(5):
                x = x @ x
    a = analyze(rec)
    # one 8x8x8 product (1,024 flops) each of 5 iterations
    assert a["flops"] == 2 * 8 * 8 * 8 * 5
    assert a["aten_flops"] == a["flops"] and a["kernels"] == {}
    # each product reads two 256-byte operands and writes one
    assert a["bytes"] == 5 * 3 * 256
    assert rec.arguments == 256


def test_recorder_frees_what_dies_and_keeps_its_peak():
    with _fake_mode():
        x = torch.empty((1024,), dtype=torch.float32, device="cuda")
        rec = DryRunRecorder()
        rec.track_arguments(x)
        with rec:
            y = x * 2            # +4 KB
            z = y.view(32, 32)   # a view: no new storage
            del y
            w = z + 1            # +4 KB while z (y's storage) lives
            del z, w
            v = torch.empty((4096,), device="cuda")     # +16 KB, after both died
            del v
    assert rec.arguments == 4096
    assert rec.peak == 4096 + 16384
    assert rec.temp == 16384
    assert rec.live == 4096


def test_roofline_terms_collectives_and_wire_factors():
    analysis = {"flops": 0.0, "bytes": 0.0,
                "collectives": {"all-reduce": {"count": 1.0, "bytes": 4096.0},
                                "all-gather": {"count": 1.0, "bytes": 4096.0}}}
    t = roofline_terms(analysis, chips=256)
    # wire = 2x all-reduce + 1x all-gather
    assert t["wire_bytes"] == pytest.approx(2 * 4096 + 4096)
    assert t["t_collective_s"] == pytest.approx((2 * 4096 + 4096) / port_mesh.NETWORK_BW)


def test_float32_kernel_operations_are_timed_at_the_float32_rate():
    analysis = {"flops": 3e12, "bytes": 0.0, "collectives": {},
                "kernels": {"mamba2_ssd": {"launches": 1, "ops": 1e12, "bytes": 0,
                                           "dtype": "f32"},
                            "flash_attention": {"launches": 1, "ops": 1e12, "bytes": 0,
                                                "dtype": "bf16"}}}
    t = roofline_terms(analysis, chips=1)
    assert t["t_compute_s"] == pytest.approx(2e12 / port_mesh.PEAK_FLOPS_BF16
                                             + 1e12 / port_mesh.PEAK_FLOPS_FP32)


def test_float32_aten_products_are_timed_at_the_float32_rate():
    with _fake_mode():
        a = torch.empty((64, 32), dtype=torch.float32, device="cuda")
        b = torch.empty((32, 16), dtype=torch.bfloat16, device="cuda")
        rec = DryRunRecorder()
        rec.track_arguments((a, b))
        with rec:
            a @ a.T                          # float32: 2 * 64 * 32 * 64
            b.T @ b                          # bf16: 2 * 16 * 32 * 16
    got = analyze(rec)
    f32, bf16 = 2 * 64 * 32 * 64, 2 * 16 * 32 * 16
    assert got["aten_flops"] == got["flops"] == f32 + bf16
    assert got["aten_flops_f32"] == f32
    t = roofline_terms(got, chips=1)
    assert t["t_compute_s"] == pytest.approx(bf16 / port_mesh.PEAK_FLOPS_BF16
                                             + f32 / port_mesh.PEAK_FLOPS_FP32)


ANALYSES = {
    "compute": {"flops": 4.2e14, "bytes": 3.1e11,
                "collectives": {"all-reduce": {"count": 14.0, "bytes": 4.9e9},
                                "all-gather": {"count": 17.0, "bytes": 2.6e9}}},
    "memory": {"flops": 3.0e10, "bytes": 3.2e10,
               "collectives": {"all-gather": {"count": 9.0, "bytes": 4.2e8}}},
    "collective": {"flops": 1.0e9, "bytes": 1.0e8,
                   "collectives": {"all-to-all": {"count": 1.0, "bytes": 1.7e7},
                                   "reduce-scatter": {"count": 2.0, "bytes": 3.0e9}}},
}


@pytest.mark.parametrize("which", sorted(ANALYSES))
@pytest.mark.parametrize("arch,shape,multi_pod", [("llama3.2-1b", "train_4k", False),
                                                  ("qwen3-moe-30b-a3b", "prefill_32k", True),
                                                  ("zamba2-7b", "long_500k", False)])
def test_roofline_terms_and_summary_are_the_references(h100_reference, which, arch, shape,
                                                       multi_pod):
    analysis = ANALYSES[which]
    got = roofline_terms(analysis, chips=256)
    want = ref_roofline.roofline_terms(analysis, chips=256)
    assert got["dominant"] == want["dominant"] == which
    for k in ("t_compute_s", "t_memory_s", "t_collective_s", "wire_bytes"):
        assert got[k] == pytest.approx(want[k], rel=1e-15)
    result = {"arch": arch, "shape": shape, "multi_pod": multi_pod, "analysis": analysis}
    got = summarize_cell(result, ARCHS[arch], SHAPES[shape])
    want = ref_roofline.summarize_cell(result, ref_configs.ARCHS[arch],
                                       ref_configs.SHAPES[shape])
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k] == (v if isinstance(v, str) else pytest.approx(v, rel=1e-12)), k


# ---------------------------------------------------------------------------
# the kernels' shape-only path, launcher by launcher
# ---------------------------------------------------------------------------

@pytest.fixture
def no_library(monkeypatch):
    """``_cuda.library`` raises if anything asks for it; the counters start
    at 0."""
    def refuse():
        raise AssertionError("the shape-only path asked for the kernel library")

    monkeypatch.setattr(_cuda, "library", refuse)
    kernels.reset_launch_counts()
    yield
    assert all(v == 0 for v in kernels.launch_counts().values()), kernels.launch_counts()


def _fake(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="cuda")


def _recorded(fn):
    with _fake_mode():
        rec = DryRunRecorder()
        with rec:
            out = fn()
        outs = out if isinstance(out, tuple) else (out,)
        assert all(t.device.type == "cuda" for t in outs)
        shapes = [(tuple(t.shape), t.dtype) for t in outs]
    return shapes, rec.kernels


@pytest.mark.parametrize("causal", [True, False])
def test_flash_shape_only(no_library, causal):
    B, H, Hkv, S, D = 2, 8, 2, 300, 80
    shapes, rec = _recorded(lambda: flash_attention_cuda(
        _fake(B, H, S, D, dtype=torch.bfloat16), _fake(B, Hkv, S, D, dtype=torch.bfloat16),
        _fake(B, Hkv, S, D, dtype=torch.bfloat16), causal=causal, with_lse=True))
    assert shapes == [((B, H, S, D), torch.bfloat16), ((B, H, S), torch.float32)]
    ops, nbytes = flash_work(B, H, Hkv, S, D, causal, lse=True)
    assert rec == {"flash_attention": {"launches": 1, "ops": ops, "bytes": nbytes,
                                       "dtype": "bf16"}}
    shapes, rec = _recorded(lambda: flash_attention_bwd_cuda(
        _fake(B, H, S, D, dtype=torch.bfloat16), _fake(B, Hkv, S, D, dtype=torch.bfloat16),
        _fake(B, Hkv, S, D, dtype=torch.bfloat16), _fake(B, H, S, D, dtype=torch.bfloat16),
        _fake(B, H, S, D, dtype=torch.bfloat16), _fake(B, H, S), causal=causal))
    assert shapes == [((B, H, S, D), torch.bfloat16)] + \
        [((B, Hkv, S, D), torch.bfloat16)] * 2
    ops, nbytes = flash_bwd_work(B, H, Hkv, S, D, causal)
    assert rec == {"flash_attention_bwd": {"launches": 1, "ops": ops, "bytes": nbytes,
                                           "dtype": "bf16"}}


def test_ssd_shape_only(no_library):
    B, L, H = 2, 256, 8
    shapes, rec = _recorded(lambda: ssd_cuda(_fake(B, L, H, 64), _fake(B, L, H), _fake(B, L, 64),
                                             _fake(B, L, 64), states=True))
    assert shapes == [((B, L, H, 64), torch.float32), ((B, H, 64, 64), torch.float32),
                      ((B, L // 128, H, 64, 64), torch.float32)]
    ops, nbytes = ssd_work(B, L, H)
    assert rec == {"mamba2_ssd": {"launches": 1, "ops": ops, "bytes": nbytes, "dtype": "f32"}}
    shapes, rec = _recorded(lambda: ssd_bwd_cuda(
        _fake(B, L, H, 64), _fake(B, L, H), _fake(B, L, 64), _fake(B, L, 64),
        _fake(B, L // 128, H, 64, 64), _fake(B, L, H, 64)))
    assert shapes == [((B, L, H, 64), torch.float32), ((B, L, H), torch.float32),
                      ((B, L, 64), torch.float32), ((B, L, 64), torch.float32)]
    ops, nbytes = ssd_bwd_work(B, L, H)
    assert rec == {"mamba2_ssd_bwd": {"launches": 1, "ops": ops, "bytes": nbytes,
                                      "dtype": "f32"}}


def test_wkv_shape_only(no_library):
    B, T, H = 2, 64, 4
    r = lambda: _fake(B, T, H, 64)  # noqa: E731
    shapes, rec = _recorded(lambda: wkv6_cuda(r(), r(), r(), r(), _fake(H, 64), states=True))
    assert shapes == [((B, T, H, 64), torch.float32), ((B, H, 64, 64), torch.float32),
                      ((B, T // 16, H, 64, 64), torch.float32)]
    ops, nbytes = wkv_work(B, T, H)
    assert rec == {"rwkv6_wkv": {"launches": 1, "ops": ops, "bytes": nbytes, "dtype": "f32"}}
    shapes, rec = _recorded(lambda: wkv6_bwd_cuda(r(), r(), r(), r(), _fake(H, 64),
                                                  _fake(B, T // 16, H, 64, 64), r()))
    assert shapes == [((B, T, H, 64), torch.float32)] * 4 + \
        [((H, 64), torch.float32)]
    ops, nbytes = wkv_bwd_work(B, T, H)
    assert rec == {"rwkv6_wkv_bwd": {"launches": 1, "ops": ops, "bytes": nbytes, "dtype": "f32"}}
    assert bwd_groups(T) == 1


def test_shuffle_shape_only(no_library):
    b, nt, t, d = 4, 8, 16, 29
    x, tp, ip = (torch.empty(shape, dtype=dtype, device="meta") for shape, dtype in
                 (((b, nt * t, d), torch.float32), ((b, nt), torch.int32),
                  ((b, nt, t), torch.int32)))
    shapes, rec = _recorded(lambda: rsp_shuffle_cuda(_fake(b, nt * t, d),
                                                     _fake(b, nt, dtype=torch.int32),
                                                     _fake(b, nt, t, dtype=torch.int32),
                                                     tile_rows=t))
    assert shapes == [((b, nt * t, d), torch.float32)]
    assert rec == {"rsp_shuffle": {"launches": 1, "ops": 0, "bytes": shuffle_bytes(x, tp, ip),
                                   "dtype": "f32"}}
    # a 2-D block goes through the same launch
    shapes, rec = _recorded(lambda: rsp_shuffle_cuda(_fake(nt * t, d),
                                                     _fake(nt, dtype=torch.int32),
                                                     _fake(nt, t, dtype=torch.int32),
                                                     tile_rows=t))
    assert shapes == [((nt * t, d), torch.float32)] and rec["rsp_shuffle"]["launches"] == 1


def test_a_launcher_with_no_dry_run_records_nothing(no_library):
    with _fake_mode():
        out = ssd_cuda(_fake(1, 128, 2, 64), _fake(1, 128, 2), _fake(1, 128, 64),
                       _fake(1, 128, 64))
    assert tuple(out[0].shape) == (1, 128, 2, 64)
    assert _cuda._DRY_RUNS == []


@pytest.mark.parametrize("launch", [
    lambda t: flash_attention_cuda(t(1, 2, 8, 64), t(1, 2, 8, 64), t(1, 2, 8, 64)),
    lambda t: ssd_cuda(t(1, 128, 2, 64), t(1, 128, 2), t(1, 128, 64), t(1, 128, 64)),
    lambda t: wkv6_cuda(t(1, 16, 2, 64), t(1, 16, 2, 64), t(1, 16, 2, 64), t(1, 16, 2, 64),
                        t(2, 64)),
    lambda t: rsp_shuffle_cuda(t(2, 8, 4), torch.zeros((2, 2), dtype=torch.int32),
                               torch.zeros((2, 2, 4), dtype=torch.int32), tile_rows=4),
], ids=["flash", "ssd", "wkv", "shuffle"])
def test_a_real_cpu_tensor_still_raises(no_library, launch):
    with pytest.raises(ValueError, match="CUDA tensor"):
        launch(lambda *shape: torch.zeros(shape))


# ---------------------------------------------------------------------------
# the model-level bounds moved out of chip_smoke.py (PERF.md section 2)
# ---------------------------------------------------------------------------

def _round(x: float, digits: int) -> float:
    return float(f"{x:.{digits}e}")


def test_training_bounds_reproduce_the_printed_figures():
    import dataclasses

    assert _round(train_flops(ARCHS["llama3.2-1b"], 8, 2048), 3) == 1.281e14
    assert _round(train_flops(ARCHS["hubert-xlarge"], 8, 2048), 3) == 1.177e14
    # (arch, layers, bf16 and its printed digits, float32)
    for arch, layers, bf16, digits, f32 in (("rwkv6-1.6b", None, 1.418e14, 3, 2.67e12),
                                            ("zamba2-7b", 24, 2.880e14, 3, 4.95e12),
                                            ("granite-moe-3b-a800m", None, 9.65e13, 2, 1.93e11)):
        cfg = ARCHS[arch] if layers is None else dataclasses.replace(ARCHS[arch],
                                                                     num_layers=layers)
        got_bf16, got_f32 = family_train_ops(cfg, 8, 2048)
        assert _round(got_bf16, digits) == bf16, (arch, got_bf16)
        assert _round(got_f32, 2) == f32, (arch, got_f32)


def test_decode_bounds_reproduce_the_printed_figures():
    # PERF.md section 2: a decode step's bytes at batch 8 after a 2048-token
    # prompt (llama3.2-1b 64 new tokens, zamba2-7b 32)
    assert round(decode_step_bytes(ARCHS["llama3.2-1b"], 8, 2048 + 64)["step"] / 1e9, 3) == 6.051
    assert round(decode_step_bytes(ARCHS["zamba2-7b"], 8, 2048 + 32)["step"] / 1e9, 3) == 36.276
    assert round(decode_step_bytes(ARCHS["rwkv6-1.6b"], 8)["step"] / 1e9, 3) == 6.032


def test_work_functions_reproduce_the_printed_bounds():
    # PERF.md section 6: the SSD's 45.35 GFLOP at zamba2-7b's prefill shape,
    # the WKV's 675.3 MB at rwkv6-1.6b's
    assert round(ssd_work(8, 2048, 112)[0] / 1e9, 2) == 45.35
    assert round(wkv_work(8, 2048, 32)[1] / 1e6, 1) == 675.3
    # the flash backward's 344 GFLOP at llama3.2-1b's training shape
    assert round(flash_bwd_work(8, 32, 8, 2048, 64, True)[0] / 1e9) == 344


# ---------------------------------------------------------------------------
# the report's tables against the reference's
# ---------------------------------------------------------------------------

def _result(arch, shape, mp, flops, args, temp, optimized=False, colls=None):
    return {"arch": arch, "shape": shape, "multi_pod": mp, "optimized": optimized,
            "lower_s": 2.0, "compile_s": 0.0,
            "memory": {"argument_size_in_bytes": args, "output_size_in_bytes": args // 2,
                       "temp_size_in_bytes": temp},
            "analysis": {"flops": flops, "bytes": flops / 7.0,
                         "collectives": colls or {"all-gather": {"count": 9.0,
                                                                 "bytes": 4.2e8}}}}


@pytest.fixture
def results_dir(tmp_path):
    rows = [
        _result("llama3.2-1b", "train_4k", False, 4.2e14, 3.0e8, 1.2e11,
                colls={"all-reduce": {"count": 14.0, "bytes": 4.9e9},
                       "all-gather": {"count": 17.0, "bytes": 2.6e9}}),
        _result("llama3.2-1b", "train_4k", True, 2.1e14, 3.0e8, 6.0e10),
        _result("llama3.2-1b", "train_4k", False, 3.9e14, 3.0e8, 9.0e10, optimized=True),
        _result("qwen2-0.5b", "decode_32k", False, 3.05e10, 2.7e8, 6.4e9),
        _result("qwen2-0.5b", "decode_32k", True, 1.52e10, 1.7e8, 3.2e9),
        _result("qwen2-0.5b", "decode_32k", False, 2.9e10, 2.7e8, 6.0e9, optimized=True),
        _result("zamba2-7b", "long_500k", False, 8.8e11, 5.5e9, 1.9e10,
                colls={"all-gather": {"count": 120.0, "bytes": 1.4e10},
                       "all-to-all": {"count": 2.0, "bytes": 1.0e6}}),
        _result("hubert-xlarge", "prefill_32k", False, 9.9e14, 1.2e8, 3.3e9),
    ]
    rsp = {"arch": "rsp-partition", "shape": "records16384x4097", "multi_pod": False,
           "compile_s": 0.0, "lower_s": 0.1, "memory": {"argument_size_in_bytes": 16781312},
           "analysis": {"flops": 0.0, "bytes": 117481664.0,
                        "collectives": {"all-to-all": {"count": 1.0, "bytes": 16781312.0}}}}
    for i, r in enumerate(rows + [rsp]):
        (tmp_path / f"r{i}.json").write_text(json.dumps(r))
    (tmp_path / "broken.err").write_text("a failed cell leaves no JSON")
    return tmp_path


def _drop_column(table: str, i: int) -> list[list[str]]:
    return [[c for j, c in enumerate(line.split("|")) if j != i + 1]
            for line in table.splitlines()]


def test_report_tables_are_the_references(results_dir):
    got, want = report.load_results(str(results_dir)), ref_report.load_results(str(results_dir))
    assert got == want
    assert "fits 80G?" in report.dryrun_table(got).splitlines()[0]
    # every column but the fit column (the H100's 80 GB against a v5e's 16 GiB)
    assert _drop_column(report.dryrun_table(got), 6) == \
        _drop_column(ref_report.dryrun_table(want), 6)
    assert report.skip_table() == ref_report.skip_table()
    assert report.rsp_partition_rows(got) == ref_report.rsp_partition_rows(want)
    assert report.fmt_bytes(123456789.0) == ref_report.fmt_bytes(123456789.0)
    for x in (3.2, 0.0123, 4.5e-6):
        assert report.fmt_s(x) == ref_report.fmt_s(x)


def test_report_fit_column_holds_the_cards_memory(results_dir):
    rows = report.dryrun_table(report.load_results(str(results_dir))).splitlines()[2:]
    fits = {(r.split("|")[1].strip(), r.split("|")[2].strip(), r.split("|")[3].strip()):
            r.split("|")[7].strip() for r in rows if "MISSING" not in r}
    # 3e8 + 1.2e11 bytes do not fit 80 GB; 2.7e8 + 6.4e9 do
    assert fits[("llama3.2-1b", "train_4k", "16x16")] == "NO"
    assert fits[("qwen2-0.5b", "decode_32k", "16x16")] == "yes"
    assert math.isclose(port_mesh.HBM_CAPACITY, 80e9)


def test_report_roofline_tables_are_the_references(h100_reference, results_dir):
    got, want = report.load_results(str(results_dir)), ref_report.load_results(str(results_dir))
    assert report.roofline_table(got) == ref_report.roofline_table(want)
    assert [w[:4] for w in report.worst_cells(got)] == [w[:4] for w in
                                                        ref_report.worst_cells(want)]
    got_opt = report.load_results(str(results_dir), optimized=True)
    want_opt = ref_report.load_results(str(results_dir), optimized=True)
    assert report.perf_comparison(got, got_opt) == ref_report.perf_comparison(want, want_opt)
