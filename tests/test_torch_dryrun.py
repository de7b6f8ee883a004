"""The port's dry run (``repro_torch.launch.dryrun``) against real runs and
against the reference's shardings.

The fake process group is process-wide, so every case that needs a world
runs in a child process with a timeout of its own:

* the recorder's FLOPs and argument bytes of a smoke-width training step
  traced on a fake (1, 1) world (fake host tensors: ``impl="auto"`` takes
  the plain versions, so no kernel is recorded) equal ``FlopCounterMode``'s
  count and the state's and batch's bytes of the same step run for real on
  the CPU, for every family;
* the per-rank argument bytes of qwen2-0.5b's ``decode_32k`` and of a smoke
  config's ``train_4k``, on the 16x16 and 2x16x16 meshes, equal the sum of
  the reference's ``NamedSharding.shard_shape`` bytes over the same leaves
  (the reference on 512 forced XLA host devices; the reference's caches
  also hold an int32 ``length`` and ``pos``, the port's hold ints);
* the reference test's properties of the port's JSONs
  (``tests/test_dryrun_launch.py``), and the RSP partition's program;
* the kernels' shape-only path inside traced models on fake CUDA tensors:
  each forward kernel recorded once a layer, the kernel library never
  asked for, no launch counted.  (A training step on fake CUDA tensors
  needs a PyTorch built with CUDA: autograd asks the CUDA device guard for
  a stream, which a CPU-only build lacks.  ``chip_smoke.py``'s phase 11
  and ``tests/test_torch_cuda.py`` hold its launches to
  ``family_launches`` on the card's build.)
"""

import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
SRC = ROOT / "src"
SLAB = 1024 * 4097 * 4          # a rank's records of the partition (16 ranks, 16,384 records)
CHILD_TIMEOUT = 120


def _child(code: str, *, env: dict | None = None, timeout: int = CHILD_TIMEOUT) -> dict:
    """Run ``code`` in a fresh interpreter; its last stdout line is JSON."""
    full = dict(os.environ)
    full.pop("XLA_FLAGS", None)
    # one intra-op thread: the children run beside the other test workers
    full.update(PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1", **(env or {}))
    proc = subprocess.run([sys.executable, "-c", code], env=full, capture_output=True,
                          text=True, timeout=timeout, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _cli(args: list[str], out: pathlib.Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *args,
                           "--out", str(out)], env=env, capture_output=True, text=True,
                          timeout=CHILD_TIMEOUT, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    lines = proc.stdout.splitlines()
    return json.loads("\n".join(lines[lines.index("{"):]))


# ---------------------------------------------------------------------------
# the recorder against a real step
# ---------------------------------------------------------------------------

REAL_STEP = """
import json
import torch
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import ShapeCell, smoke_config
from repro_torch.distributed.sharding import default_rules
from repro_torch.launch.dryrun import dryrun_cell, init_fake_world
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.roofline import local_bytes
from repro_torch.models import api
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.loop import TrainConfig, init_state, make_train_step

init_fake_world(1)
mesh = make_host_mesh((1, 1), ("data", "model"), device_type="cpu")
cell = ShapeCell("train_smoke", "train", 32, 4)
tc = TrainConfig(total_steps=10, warmup_steps=1)
out = {}
for arch in ARCHS:
    cfg = smoke_config(arch)
    dry = dryrun_cell(arch, cell.name, cfg=cfg, cell=cell, train_cfg=tc, mesh=mesh)
    rules = default_rules(mesh, cfg=cfg)
    state = init_state(cfg, 0, device="cpu", rules=rules)
    batch = api.concrete_inputs(cfg, cell, 0, device="cpu")
    args = local_bytes(state) + local_bytes(batch)
    step = make_train_step(cfg, AdamWConfig(), tc, rules=rules)
    with FlopCounterMode(display=False) as fc:
        _, metrics = step(state, batch)
    out[arch] = {"dry": dry, "flops": fc.get_total_flops(), "args": args,
                 "loss": float(metrics["loss"])}
print(json.dumps(out))
"""
ARCHS = ["llama3.2-1b", "granite-moe-3b-a800m", "zamba2-7b", "rwkv6-1.6b", "hubert-xlarge"]


@pytest.fixture(scope="module")
def real_steps():
    return _child(f"ARCHS = {ARCHS!r}\n" + REAL_STEP)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_recorder_matches_a_real_step(real_steps, arch):
    got = real_steps[arch]
    dry = got["dry"]
    analysis = dry["analysis"]
    assert analysis["aten_flops"] == got["flops"] > 0
    assert analysis["kernels"] == {}                  # the plain versions on the host
    assert analysis["flops"] == analysis["aten_flops"]
    assert dry["memory"]["argument_size_in_bytes"] == got["args"]
    # one rank: the gradients' mean over the data ranks is an all-reduce
    assert analysis["collectives"]["all-reduce"]["count"] > 0
    assert dry["memory"]["temp_size_in_bytes"] > 0 and dry["chips"] == 1
    assert got["loss"] == got["loss"]                  # the real step ran to a finite loss


MOE_DISPATCH = """
import json
import torch.distributed as dist
from repro_torch.configs import ShapeCell, smoke_config
from repro_torch.launch.dryrun import dryrun_cell, init_fake_world
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe

calls = []
apply = moe.moe_apply

def spy(params, x, cfg, **kw):
    calls.append([list(x.shape), kw.get("moe_groups", 1), kw.get("dropless", False)])
    return apply(params, x, cfg, **kw)

moe.moe_apply = spy
arch = "granite-moe-3b-a800m"
cfg = smoke_config(arch)
out = {}
for data, rows in ((4, 8), (1, 2)):
    init_fake_world(data)
    mesh = make_host_mesh((data, 1), ("data", "model"), device_type="cpu")
    calls.clear()
    r = dryrun_cell(arch, "train_smoke", cfg=cfg, cell=ShapeCell("train_smoke", "train", 32, rows),
                    mesh=mesh)
    out[data] = {"calls": list(calls), "aten_flops": r["analysis"]["aten_flops"]}
    dist.destroy_process_group()
print(json.dumps(out))
"""


TENSOR_PARALLEL = """
import json
import torch.distributed as dist
from repro_torch.configs import ShapeCell, smoke_config
from repro_torch.launch.dryrun import dryrun_cell, init_fake_world
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.roofline import local_bytes
from repro_torch.models.transformer import init_caches

arch = "llama3.2-1b"
cfg = smoke_config(arch)
train = ShapeCell("train_smoke", "train", 32, 4)
decode = ShapeCell("decode_smoke", "decode", 64, 4)
out = {}
for model in (1, 4):
    init_fake_world(model)
    mesh = make_host_mesh((1, model), ("data", "model"), device_type="cpu")
    out[model] = {cell.kind: dryrun_cell(arch, cell.name, cfg=cfg, cell=cell, mesh=mesh)
                  for cell in (train, decode)}
    dist.destroy_process_group()
out["caches"] = local_bytes(init_caches(cfg, decode.global_batch, decode.seq_len,
                                        device="cpu"))
print(json.dumps(out))
"""


def test_a_model_rank_computes_its_own_shard():
    # a fake (1, 4) world: rank 0 computes its heads, ff columns and vocab
    # rows, so its aten FLOPs fall below 0.4x one rank's of the whole
    # model, and a decode step gathers no parameter and no cache (its
    # all-gathers are q's columns and the attention output's head-dim
    # chunks, activations of one token)
    from repro_torch.configs import smoke_config
    from repro_torch.models import api
    from repro_torch.models.common import param_count

    got = _child(TENSOR_PARALLEL)
    whole, split = got["1"], got["4"]
    for kind in ("train", "decode"):
        assert split[kind]["analysis"]["aten_flops"] <= 0.4 * whole[kind]["analysis"]["aten_flops"]
    params = 2 * param_count(api.model_specs(smoke_config("llama3.2-1b")))   # bf16
    gathered = split["decode"]["analysis"]["collectives"]["all-gather"]["bytes"]
    assert 0 < gathered < 0.05 * min(params, got["caches"]), (gathered, params, got["caches"])
    # the reductions GSPMD inserts: all-reduces over "model" in both steps
    def reduces(r):
        return r["analysis"]["collectives"].get("all-reduce", {}).get("count", 0)

    for kind in ("train", "decode"):
        assert reduces(split[kind]) > reduces(whole[kind])


def test_a_moe_train_cells_dispatch_is_its_local_shards():
    # a rank of a (4, 1) mesh dispatches its 2 of 8 rows as a (1, 1) mesh
    # dispatches a batch of 2: one group (the reference's moe_groups = dp
    # cuts the global batch into one group a data rank, which a rank's
    # shard already is)
    got = _child(MOE_DISPATCH)
    assert got["4"] == got["1"]
    assert got["4"]["calls"] and all(g == 1 for _, g, _ in got["4"]["calls"])


FAKE_WORLD_ONLY_IN_A_DRY_RUN = """
import json
import torch
from repro_torch.core.partition import distributed_rsp_partition, exchange_refusal
from repro_torch.launch.dryrun import _fake_mode, init_fake_world
from repro_torch.launch.mesh import make_host_mesh

init_fake_world(4)
real = torch.zeros((8, 3), dtype=torch.int32)
out = {"real": exchange_refusal(None, real), "no shard": exchange_refusal(None)}
try:
    distributed_rsp_partition(real, 0)
    out["partition"] = "exchanged"
except ValueError as e:
    out["partition"] = str(e)
with _fake_mode():
    out["fake"] = exchange_refusal(None, torch.empty((8, 3), dtype=torch.int32))
    out["fake mesh"] = make_host_mesh((2, 2), ("data", "model"), device_type="cuda").device_type
out["card"] = torch.cuda.is_available()
try:
    make_host_mesh((2, 2), ("data", "model"), device_type="cuda")
    out["mesh"] = "built"
except RuntimeError as e:
    out["mesh"] = str(e)
print(json.dumps(out))
"""


def test_the_fake_world_serves_only_a_dry_run():
    # the "fake" backend moves no data: a real shard is refused its exchange,
    # and a CUDA mesh with no card is built only under a fake mode
    got = _child(FAKE_WORLD_ONLY_IN_A_DRY_RUN)
    for key in ("real", "no shard", "partition"):
        assert "backend is 'fake'" in got[key], key
    assert got["fake"] is None
    assert got["fake mesh"] == "cuda"
    if not got["card"]:
        assert "no CUDA device is available" in got["mesh"]


COLLECTIVES = """
import json
import torch
import torch.distributed as dist
from torch.distributed import _functional_collectives as fc
from repro_torch.launch.dryrun import _fake_mode, init_fake_world
from repro_torch.launch.roofline import DryRunRecorder, analyze, roofline_terms

init_fake_world(256)
with _fake_mode():
    x = torch.empty(1024, dtype=torch.float32, device="cuda")
    part = torch.empty(4, dtype=torch.float32, device="cuda")
    rec = DryRunRecorder()
    with rec:
        dist.all_reduce(x)                                     # c10d, in place
        y = fc.all_gather_tensor(part, 0, dist.group.WORLD)    # functional: 256 x 4
        y = fc.wait_tensor(y)
a = analyze(rec)
print(json.dumps({"collectives": a["collectives"], "flops": a["flops"],
                  "wire": roofline_terms(a, chips=256)["wire_bytes"]}))
"""


def test_recorder_collectives_and_wire_factors():
    # tests/test_dryrun_launch.py:93-116 on a fake world of 256 ranks: an
    # all-reduce and an all-gather whose per-rank outputs are 1,024 float32
    got = _child(COLLECTIVES)
    assert got["collectives"] == {"all-reduce": {"count": 1.0, "bytes": 4096.0},
                                  "all-gather": {"count": 1.0, "bytes": 4096.0}}
    assert got["flops"] == 0
    assert got["wire"] == 2 * 4096 + 4096


# ---------------------------------------------------------------------------
# per-rank argument bytes against the reference's shard shapes
# ---------------------------------------------------------------------------

REFERENCE_SHARDS = """
import json
import jax
import numpy as np
from repro.configs import ARCHS, SHAPES, smoke_config
from repro.distributed.sharding import (abstract_compute_params, abstract_state,
                                        batch_shardings, cache_shardings, default_rules)
from repro.launch.mesh import make_production_mesh
from repro.models import api

def nbytes(structs, shardings=None):
    total = 0
    flat = jax.tree_util.tree_flatten_with_path(structs)[0]
    shs = None if shardings is None else jax.tree.leaves(shardings)
    for i, (path, s) in enumerate(flat):
        if getattr(path[-1], "key", None) in ("length", "pos"):
            continue      # ints in the port's caches
        sh = s.sharding if shardings is None else shs[i]
        total += int(np.prod(sh.shard_shape(s.shape))) * np.dtype(s.dtype).itemsize
    return total

out = {}
for mp in (False, True):
    mesh = make_production_mesh(multi_pod=mp)
    for case in ("decode", "train"):
        cfg, cell = ((ARCHS["qwen2-0.5b"], SHAPES["decode_32k"]) if case == "decode"
                     else (smoke_config("llama3.2-1b"), SHAPES["train_4k"]))
        rules = default_rules(mesh, cfg=cfg)
        specs = api.model_specs(cfg)
        batch = api.input_specs(cfg, cell)
        total = nbytes(abstract_compute_params(specs, rules))
        total += nbytes(batch, batch_shardings(batch, rules))
        if case == "train":
            total += nbytes(abstract_state(specs, rules))
        else:
            caches = api.cache_specs(cfg, cell.global_batch, cell.seq_len)
            total += nbytes(caches, cache_shardings(caches, rules))
        out[f"{case}_{'multi' if mp else 'single'}"] = total
print(json.dumps(out))
"""

SMOKE_TRAIN = """
import json
from repro_torch.configs import smoke_config
from repro_torch.launch.dryrun import _fake_mode, build_cell, init_fake_world
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.roofline import DryRunRecorder
mp = {multi_pod!r}
init_fake_world(512 if mp else 256)
shape, axes = ((2, 16, 16), ("pod", "data", "model")) if mp else ((16, 16), ("data", "model"))
mesh = make_host_mesh(shape, axes, device_type="cpu")
with _fake_mode():
    # the arguments dryrun_cell counts, without tracing the step
    fn, args = build_cell("llama3.2-1b", "train_4k", cfg=smoke_config("llama3.2-1b"), mesh=mesh)
    print(json.dumps({{"arguments": DryRunRecorder().track_arguments(args)}}))
"""


@pytest.fixture(scope="module")
def reference_shards():
    return _child(REFERENCE_SHARDS,
                  env={"XLA_FLAGS": "--xla_force_host_platform_device_count=512"})


@pytest.fixture(scope="module")
def qwen_decode(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_torch")
    return {mesh: _cli(["--arch", "qwen2-0.5b", "--shape", "decode_32k"]
                       + (["--multi-pod"] if mesh == "multi" else []), out)
            for mesh in ("single", "multi")}


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_decode_arguments_are_the_references_shards(reference_shards, qwen_decode, mesh):
    got = qwen_decode[mesh]["memory"]["argument_size_in_bytes"]
    assert got == reference_shards[f"decode_{mesh}"]


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_train_arguments_are_the_references_shards(reference_shards, mesh):
    r = _child(SMOKE_TRAIN.format(multi_pod=mesh == "multi"))
    assert r["arguments"] == reference_shards[f"train_{mesh}"]


def test_the_reference_tests_properties_hold(qwen_decode):
    # tests/test_dryrun_launch.py:26-44, with the card's memory for a v5e's
    from repro_torch.launch.mesh import HBM_CAPACITY

    for r in qwen_decode.values():
        assert r["analysis"]["flops"] > 0
        assert r["memory"]["argument_size_in_bytes"] > 0
        used = r["memory"]["argument_size_in_bytes"] + r["memory"]["temp_size_in_bytes"]
        assert used < HBM_CAPACITY, f"{used / 1e9:.1f} GB"
        assert r["compile_s"] == 0.0 and r["cost"]["flops"] == r["analysis"]["flops"]
        # the q columns and the attention output's head-dim chunks are gathered
        assert r["analysis"]["collectives"]["all-gather"]["bytes"] > 0
    # multi-pod shards the batch over 2x more data ranks -> fewer flops per rank
    assert qwen_decode["multi"]["analysis"]["flops"] <= \
        qwen_decode["single"]["analysis"]["flops"] * 1.05


def test_rsp_partition_program(tmp_path):
    r = _cli(["--arch", "rsp-partition"], tmp_path)
    assert json.loads((tmp_path / "rsp-partition_single.json").read_text()) == r
    a = r["analysis"]
    assert a["flops"] == 0
    assert a["bytes"] > 2 * SLAB
    assert a["collectives"]["all-to-all"] == {"count": 1.0, "bytes": float(SLAB)}
    assert a["kernels"]["rsp_shuffle"]["launches"] == 1
    assert r["memory"]["argument_size_in_bytes"] == SLAB
    assert r["shape"] == "records16384x4097"


def test_save_hlo_is_refused(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                           "qwen2-0.5b", "--shape", "decode_32k", "--save-hlo", "x.hlo",
                           "--out", str(tmp_path)],
                          env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True,
                          text=True, timeout=CHILD_TIMEOUT)
    assert proc.returncode != 0 and "no counterpart" in proc.stderr


# ---------------------------------------------------------------------------
# the shape-only path inside traced models
# ---------------------------------------------------------------------------

FORWARD_LAUNCHES = """
import json
from repro_torch import kernels
from repro_torch.configs import ShapeCell, smoke_config
from repro_torch.kernels import _cuda
from repro_torch.launch.dryrun import _fake_mode, dryrun_cell, init_fake_world
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.roofline import shared_calls

def refuse():
    raise AssertionError("the shape-only path asked for the kernel library")

_cuda.library = refuse
init_fake_world(1)
with _fake_mode():          # a CUDA mesh needs no card in a dry run
    mesh = make_host_mesh((1, 1), ("data", "model"), device_type="cuda")
cell = ShapeCell("prefill_smoke", "prefill", 40, 4)
out = {}
for arch in ("llama3.2-1b", "zamba2-7b", "rwkv6-1.6b", "hubert-xlarge"):
    cfg = smoke_config(arch)
    r = dryrun_cell(arch, cell.name, cfg=cfg, cell=cell, mesh=mesh)
    out[arch] = {"kernels": r["analysis"]["kernels"], "layers": cfg.num_layers,
                 "shared": shared_calls(cfg) if cfg.family == "hybrid" else 0}
out["counts"] = kernels.launch_counts()
print(json.dumps(out))
"""


def test_forward_kernels_take_the_shape_only_path():
    got = _child(FORWARD_LAUNCHES)
    assert all(v == 0 for v in got.pop("counts").values())
    launches = {arch: {k: v["launches"] for k, v in g["kernels"].items()}
                for arch, g in got.items()}
    L = {arch: g["layers"] for arch, g in got.items()}
    assert launches["llama3.2-1b"] == {"flash_attention": L["llama3.2-1b"]}
    assert launches["hubert-xlarge"] == {"flash_attention": L["hubert-xlarge"]}
    assert launches["zamba2-7b"] == {"mamba2_ssd": L["zamba2-7b"],
                                     "flash_attention": got["zamba2-7b"]["shared"]}
    assert launches["rwkv6-1.6b"] == {"rwkv6_wkv": L["rwkv6-1.6b"]}
    for g in got.values():
        for name, k in g["kernels"].items():
            assert k["ops"] > 0 and k["bytes"] > 0
            assert k["dtype"] == ("bf16" if name == "flash_attention" else "f32")
