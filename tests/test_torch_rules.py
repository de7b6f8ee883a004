"""Rules of the port: it imports neither ``jax`` nor the reference package,
its entry points run on the card unless asked for the CPU, and a CUDA
kernel is never stood in for on a CUDA tensor (here: it is never launched
on the CPU at all)."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch import kernels, rsp
from repro_torch.checkpoint import store
from repro_torch.configs import smoke_config
from repro_torch.core.monitor import DriftMonitor
from repro_torch.core.registry import RSPStore
from repro_torch.data import BlockSource, RSPLoader
from repro_torch.device import resolve_device
from repro_torch.kernels.block_sketch import block_sketch
from repro_torch.kernels.block_sketch.kernel import block_sketch_cuda
from repro_torch.kernels.flash_attention import flash_attention, flash_attention_cuda
from repro_torch.kernels.mamba2_ssd import ssd_cuda
from repro_torch.kernels.rwkv6_wkv import wkv6, wkv6_cuda
from repro_torch.models.transformer import DenseLM, HybridLM, RWKVLM, init_caches
from repro_torch.kernels.plan import PlanArrays, QueryPlan, compile_plan, plan_sketch
from repro_torch.kernels.plan.kernel import plan_sketch_cuda
from repro_torch.kernels.rsp_shuffle import rsp_shuffle_cuda
from repro_torch.optim import AdamWConfig
from repro_torch.serve import EnsembleServer, Server
from repro_torch.train import TrainConfig, init_state, make_train_step

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _cuda_absent():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CPU-only behaviour does not apply")


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import sys, repro_torch, repro_torch.rsp, repro_torch.kernels.plan, "
        "repro_torch.data, repro_torch.obs, repro_torch.kernels.flash_attention, "
        "repro_torch.serve, repro_torch.launch.serve, repro_torch.checkpoint.store, "
        "repro_torch.kernels.mamba2_ssd, repro_torch.models.mamba2, "
        "repro_torch.kernels.rwkv6_wkv, repro_torch.models.rwkv6, repro_torch.core.ensemble, "
        "repro_torch.core.similarity, repro_torch.core.monitor, repro_torch.data.loader, "
        "repro_torch.distributed, repro_torch.distributed.rsp, "
        "repro_torch.distributed.elastic\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'repro', 'jaxlib') "
        "or m.startswith(('jax.', 'repro.', 'jaxlib.')))\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_the_distributed_package_imports_without_jax():
    """With ``jax`` and the reference unimportable, the mesh layer loads, and
    its elastic helpers pull in no model code."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'repro'):\n"
        "    sys.modules[name] = None\n"
        "from repro_torch.distributed import (DistributedDataset, LocalTransport, "
        "BlockOwnership, LeaseScheduler, TCPStoreTransport)\n"
        "import repro_torch.distributed.elastic\n"
        "models = sorted(m for m in sys.modules if m.startswith(('repro_torch.models', "
        "'repro_torch.configs', 'repro_torch.serve.engine')))\n"
        "print(models); sys.exit(1 if models else 0)\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    assert res.returncode == 0, res.stdout + res.stderr


def test_collective_entry_points_default_to_the_card():
    _cuda_absent()
    data = np.zeros((64, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rsp.partition(data, blocks=2, backend="collective", mesh=object())


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_entry_points_default_to_the_card():
    _cuda_absent()
    data = np.zeros((40, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rsp.partition(data, blocks=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rsp.open(str(ROOT / "tests" / "fixtures" / "v1_store"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rsp.RSPDataset(rsp.RSPSpec(40, 2, 2, (3,)), blocks=data.reshape(2, 20, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def _host_model():
    return DenseLM(smoke_config("llama3.2-1b"), device="cpu")


LM_ENTRY_POINTS = {
    "DenseLM": lambda: DenseLM(smoke_config("llama3.2-1b")),
    "Server": lambda: Server(smoke_config("llama3.2-1b"), _host_model()),
    "EnsembleServer": lambda: EnsembleServer(smoke_config("llama3.2-1b"), [_host_model()] * 2),
    "init_caches": lambda: init_caches(smoke_config("llama3.2-1b"), 1, 8),
    "HybridLM": lambda: HybridLM(smoke_config("zamba2-7b")),
    "init_caches(hybrid)": lambda: init_caches(smoke_config("zamba2-7b"), 1, 8),
    "RWKVLM": lambda: RWKVLM(smoke_config("rwkv6-1.6b")),
    "init_caches(rwkv)": lambda: init_caches(smoke_config("rwkv6-1.6b"), 1, 8),
    "restore": lambda: store.restore(str(ROOT / "no_such_checkpoint"), 0),
    "launch.serve": lambda: __import__("repro_torch.launch.serve", fromlist=["main"]).main([]),
}


@pytest.mark.parametrize("name", sorted(LM_ENTRY_POINTS))
def test_lm_entry_points_default_to_the_card(name):
    _cuda_absent()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LM_ENTRY_POINTS[name]()


V1_STORE = RSPStore(str(ROOT / "tests" / "fixtures" / "v1_store"))
BLOCKS = np.zeros((2, 20, 3), np.float32)
DEFAULT_DEVICE_CONSTRUCTORS = {
    "MemoryFetcher": lambda: rsp.MemoryFetcher(BLOCKS),
    "StoreFetcher": lambda: rsp.StoreFetcher(V1_STORE),
    "MmapFetcher": lambda: rsp.MmapFetcher(V1_STORE),
    "as_fetcher(array)": lambda: rsp.as_fetcher(BLOCKS),
    "as_fetcher(store)": lambda: rsp.as_fetcher(V1_STORE),
    "as_fetcher(store, mmap)": lambda: rsp.as_fetcher(V1_STORE, mode="mmap"),
    "BlockExecutor": lambda: rsp.BlockExecutor(BLOCKS, prefetch=0),
    "BlockSource(blocks)": lambda: BlockSource(blocks=BLOCKS),
    "BlockSource(store)": lambda: BlockSource(store=V1_STORE),
    "RSPLoader": lambda: RSPLoader(BlockSource(store=V1_STORE), batch_size=4),
    "RSPDataset.loader": lambda: rsp.RSPDataset(V1_STORE.spec(), store=V1_STORE).loader(4),
    "DriftMonitor": lambda: DriftMonitor(BLOCKS),
    "compile_plan": lambda: compile_plan(QueryPlan(predicates="c0 > 0"), num_features=3,
                                         impl="cuda"),
}


@pytest.mark.parametrize("name", sorted(DEFAULT_DEVICE_CONSTRUCTORS))
def test_fetchers_and_compiled_plans_default_to_the_card(name):
    _cuda_absent()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DEFAULT_DEVICE_CONSTRUCTORS[name]()


def test_fetchers_run_on_the_host_only_when_asked():
    store, blocks = V1_STORE, BLOCKS
    assert rsp.StoreFetcher(store, device="cpu").fetch(0).device.type == "cpu"
    assert rsp.MmapFetcher(store, device="cpu").fetch(0).device.type == "cpu"
    assert rsp.as_fetcher(blocks, device="cpu").fetch(1).device.type == "cpu"
    assert rsp.as_fetcher(torch.from_numpy(blocks)).fetch(0).device.type == "cpu"


def test_cuda_impl_on_a_cpu_tensor_raises():
    x = torch.zeros((64, 4))
    lo, invw = torch.zeros(4), torch.ones(4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        block_sketch(x, bins=4, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        block_sketch_cuda(x, lo, invw, bins=4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        plan_sketch(x, QueryPlan(predicates="c0 > 0"), impl="cuda")
    tp = torch.zeros(2, dtype=torch.int32)
    ip = torch.zeros((2, 32), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        rsp_shuffle_cuda(x, tp, ip, tile_rows=32)
    with pytest.raises(ValueError, match="unknown impl"):
        block_sketch(x, impl="pallas")
    with pytest.raises(ValueError, match="at most"):
        PlanArrays.build(QueryPlan(predicates=[f"c0 > {i}" for i in range(17)]), 4, "cpu")
    # the shuffle kernel copies 2- or 4-byte words
    with pytest.raises(ValueError, match="even number of bytes"):
        rsp_shuffle_cuda(torch.zeros((64, 3), dtype=torch.uint8), tp, ip, tile_rows=32)
    q, kv = torch.zeros((1, 4, 16, 64)), torch.zeros((1, 2, 16, 64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention(q, kv, kv, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention_cuda(q.bfloat16(), kv.bfloat16(), kv.bfloat16())
    with pytest.raises(ValueError, match="multiple of Hkv"):
        flash_attention_cuda(torch.zeros((1, 3, 16, 64)), kv, kv)
    rkvw, u = torch.full((1, 16, 2, 64), 0.5), torch.zeros((2, 64))
    with pytest.raises(ValueError, match="CUDA tensor"):
        wkv6(rkvw, rkvw, rkvw, rkvw, u, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        wkv6_cuda(rkvw, rkvw, rkvw, rkvw, u)


def _on_another_device():
    """Each CUDA wrapper with its small inputs on another device (``meta``)
    than the block (the host): the wrapper must refuse before it reads a
    pointer."""
    x = torch.zeros((64, 4))
    meta = torch.device("meta")
    lo, invw = torch.zeros(4, device=meta), torch.ones(4, device=meta)
    tp = torch.zeros(2, dtype=torch.int32, device=meta)
    ip = torch.zeros((2, 32), dtype=torch.int32, device=meta)
    arrays = PlanArrays.build(QueryPlan(predicates="c0 > 0", columns=(0, 2)), 4, meta)
    q, kv = torch.zeros((1, 4, 16, 64)), torch.zeros((1, 2, 16, 64), device=meta)
    return {
        "flash_attention": lambda: flash_attention_cuda(q, kv, kv),
        "mamba2_ssd": lambda: ssd_cuda(torch.zeros((1, 128, 2, 64)),
                                       *(torch.zeros(s, device=meta)
                                         for s in ((1, 128, 2), (1, 128, 64), (1, 128, 64)))),
        "rwkv6_wkv": lambda: wkv6_cuda(*(torch.zeros((1, 16, 2, 64)) for _ in range(3)),
                                       torch.zeros((1, 16, 2, 64), device=meta),
                                       torch.zeros((2, 64))),
        "rsp_shuffle": lambda: rsp_shuffle_cuda(x, tp, ip, tile_rows=32),
        "block_sketch": lambda: block_sketch_cuda(x, lo, invw, bins=4),
        "plan_sketch": lambda: plan_sketch_cuda(x, arrays, None, None, bins=0),
        "plan_sketch grid": lambda: plan_sketch_cuda(
            x, PlanArrays.build(QueryPlan(columns=(0, 2)), 4, "cpu"), lo[:2], invw[:2], bins=4),
    }


@pytest.mark.parametrize("name", sorted(_on_another_device()))
def test_cuda_wrappers_refuse_inputs_on_another_device(name):
    with pytest.raises(ValueError, match="but the block is on cpu"):
        _on_another_device()[name]()


def test_launch_counters_stay_zero_on_cpu_runs(tmp_path):
    _cuda_absent()
    kernels.reset_launch_counts()
    data = np.random.default_rng(0).normal(size=(1600, 5)).astype(np.float32)
    data[:, 4] = np.arange(1600) % 2
    ds = rsp.partition(data, blocks=4, backend="cuda", num_classes=2, device="cpu")
    ds.save(str(tmp_path))
    ds = rsp.open(str(tmp_path), device="cpu")
    ds.query(["mean", "p95"], use_sketches=False, sketch_impl="auto")
    ds.query("mean", where="c0 > 0", columns=(0, 1), use_sketches=False)
    ds.query(rsp.Aggregate("mean", by_label=True), use_sketches=False)
    cfg = smoke_config("qwen2-0.5b")
    prompts = np.zeros((2, 5), np.int32)
    Server(cfg, DenseLM(cfg, device="cpu"), device="cpu").generate(prompts, max_new_tokens=3)
    EnsembleServer(cfg, [DenseLM(cfg, device="cpu", seed=s) for s in (1, 2)],
                   device="cpu").generate(prompts, max_new_tokens=2)
    hcfg = smoke_config("zamba2-7b")
    Server(hcfg, HybridLM(hcfg, device="cpu"), device="cpu").generate(prompts, max_new_tokens=2)
    rcfg = smoke_config("rwkv6-1.6b")
    Server(rcfg, RWKVLM(rcfg, device="cpu"), device="cpu").generate(prompts, max_new_tokens=2)
    ds.ensemble(rsp.make_logreg(4, 2, steps=5), eval_x=data[:50, :4], eval_y=data[:50, 4],
                g=2, batches=1)
    ds.similarity(1)
    ds.loader(64).next_batch()
    DriftMonitor(ds.take([0, 1])[..., :4], device="cpu").score(ds.block(2)[:, :4])
    for arch in ("zamba2-7b", "rwkv6-1.6b"):     # a training step through the scans' backwards
        tcfg = smoke_config(arch)
        make_train_step(tcfg, AdamWConfig(), TrainConfig(total_steps=1))(
            init_state(tcfg, device="cpu"), {"tokens": torch.zeros((2, 9), dtype=torch.int32)})
    assert kernels.launch_counts() == {"rsp_shuffle": 0, "block_sketch": 0, "plan_sketch": 0,
                                       "flash_attention": 0, "flash_attention_bwd": 0,
                                       "mamba2_ssd": 0, "mamba2_ssd_bwd": 0, "rwkv6_wkv": 0,
                                       "rwkv6_wkv_bwd": 0}


def test_cuda_build_is_keyed_by_sources(tmp_path):
    from repro_torch.kernels import _cuda

    key = _cuda.source_hash()
    assert len(key) == 16 and key == _cuda.source_hash()
    assert {p.name for p in _cuda._sources()} == {
        "rsp_shuffle.cu", "block_sketch.cu", "plan_sketch.cu", "flash_attention.cu",
        "flash_attention_bwd.cu", "mamba2_ssd.cu", "mamba2_ssd_bwd.cu", "rwkv6_wkv.cu",
        "rwkv6_wkv_bwd.cu"}
    assert _cuda.BUILD_ROOT.parts[-2:] == ("build", "repro_torch_kernels")
