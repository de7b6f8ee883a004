"""The program's named ranges (``repro_torch.obs.range``) and the tracer's
clock.

A range opens a ``record_function`` while a torch profiler records and a
tracer span while telemetry is on; with neither it is one shared no-op.
Under ``torch.profiler`` on the CPU a training step shows
``train.forward``, ``train.backward`` (once each microbatch) and
``train.optimizer`` (once a step), ``models.remat`` only inside the
backward and only with remat on, ``models.weight_cast`` only where float32
weights are cast down, and one ``rwkv6.ddlerp`` a layer a forward.  The
tracer stamps on the profiler's clock, so an ``obs`` span holds the
profiler's range it encloses, in the exports of both.  The trainer's
logged step time counts the step alone (the card's case is marked
``cuda``).  The file imports neither ``jax`` nor ``repro``.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import subprocess
import sys
import time
import tracemalloc
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs
from repro_torch.configs import smoke_config
from repro_torch.core import RSPSpec, two_stage_partition_np
from repro_torch.data import BlockSource, RSPLoader, make_token_corpus
from repro_torch.models.api import make_forward_fn
from repro_torch.models.transformer import build_lm, hybrid_layout
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, Trainer, init_state, make_train_step

SRC = Path(__file__).resolve().parents[1] / "src"
PROGRAM = ("train.", "models.", "rwkv6.")


@pytest.fixture(autouse=True)
def _telemetry_off():
    obs.reset()
    yield
    obs.reset()


def _ranges(prof) -> list:
    """The program's ranges a finished profile saw, as Kineto events."""
    return [e for e in prof.profiler.kineto_results.events() if e.name().startswith(PROGRAM)]


def _count(events) -> collections.Counter:
    return collections.Counter(e.name() for e in events)


def _inside(e, outer) -> bool:
    return any(o.start_ns() <= e.start_ns() and e.end_ns() <= o.end_ns() for o in outer)


def _tokens(cfg, batch=2, length=17, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, length), dtype=torch.int32, generator=g)


def _profiled_step(cfg, microbatch=0):
    step = make_train_step(cfg, AdamWConfig(lr=1e-3),
                           TrainConfig(total_steps=10, warmup_steps=2, microbatch=microbatch))
    state = init_state(cfg, 0, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        step(state, {"tokens": _tokens(cfg)})
    return _ranges(prof)


# -- the off path ------------------------------------------------------------

def test_a_range_with_no_recorder_opens_nothing(monkeypatch):
    opened = []

    class Counting(torch.autograd.profiler.record_function):
        def __init__(self, name, *a, **kw):
            opened.append(name)
            super().__init__(name, *a, **kw)

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    r = obs.range("train.forward")
    assert r is obs.NO_RANGE and obs.range("models.remat") is r
    with r:
        torch.ones(3).sum()
    assert opened == [] and len(obs.get_tracer()) == 0
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.range("train.forward"):
            torch.ones(3).sum()
    assert opened == ["train.forward"]
    with obs.range("train.forward"):          # the profiler has stopped
        pass
    assert opened == ["train.forward"]


def test_an_off_range_costs_under_a_microsecond_and_allocates_nothing():
    def loop(n):
        for _ in range(n):
            with obs.range("models.weight_cast"):
                pass

    loop(1000)
    best = float("inf")
    for _ in range(7):
        t = time.perf_counter()
        loop(20_000)
        best = min(best, (time.perf_counter() - t) / 20_000)
    assert best < 1e-6, f"{best * 1e6:.3f} us a range"

    tracemalloc.start()
    try:
        loop(10)
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        loop(50_000)
        now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert now - before <= 0 and peak - before < 1024


def test_obs_imports_without_torch():
    pkg = SRC / "repro_torch" / "obs"
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('obs_alone', {str(pkg / '__init__.py')!r},"
        f" submodule_search_locations=[{str(pkg)!r}])\n"
        "mod = importlib.util.module_from_spec(spec); sys.modules['obs_alone'] = mod\n"
        "spec.loader.exec_module(mod)\n"
        "with mod.range('x'): pass\n"
        "assert mod.range('x') is mod.NO_RANGE\n"
        "print('torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


# -- the ranges of a step and a forward --------------------------------------

HYBRID_CASES = {"remat": (True, 0), "no remat": (False, 0), "2 microbatches": (True, 2)}


@pytest.mark.parametrize("case", sorted(HYBRID_CASES))
def test_a_hybrid_step_opens_the_train_ranges(case):
    remat, microbatch = HYBRID_CASES[case]
    cfg = dataclasses.replace(smoke_config("zamba2-7b"), remat=remat)
    events = _profiled_step(cfg, microbatch)
    count = _count(events)
    n = max(microbatch, 1)
    assert count["train.forward"] == count["train.backward"] == n
    assert count["train.optimizer"] == 1
    assert count["models.weight_cast"] == 0          # bf16 weights: no cast
    period = hybrid_layout(cfg)[1]
    layer_calls = cfg.num_layers + -(-cfg.num_layers // period)   # Mamba2 layers and shared calls
    assert count["models.remat"] == (layer_calls * n if remat else 0)
    backward = [e for e in events if e.name() == "train.backward"]
    forward = [e for e in events if e.name() == "train.forward"]
    for e in events:
        if e.name() == "models.remat":
            assert _inside(e, backward) and not _inside(e, forward)
    optimizer = next(e for e in events if e.name() == "train.optimizer")
    assert all(e.end_ns() <= optimizer.start_ns() for e in forward + backward)


def test_a_float32_rwkv6_forward_casts_its_weights_and_opens_a_ddlerp_a_layer():
    cfg = smoke_config("rwkv6-1.6b")
    model = build_lm(cfg, None, device="cpu")          # float32 weights, served in bf16
    forward = make_forward_fn(model)
    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU]) as prof:
        forward({"tokens": _tokens(cfg)})
    count = _count(_ranges(prof))
    assert count["rwkv6.ddlerp"] == cfg.num_layers
    # r, k, v, g, o and the channel mix's key, value and receptance a layer,
    # and the head
    assert count["models.weight_cast"] == 8 * cfg.num_layers + 1
    assert set(count) == {"rwkv6.ddlerp", "models.weight_cast"}


def test_a_bf16_rwkv6_step_casts_nothing_and_recomputes_each_ddlerp():
    cfg = smoke_config("rwkv6-1.6b")
    events = _profiled_step(cfg)
    count = _count(events)
    assert count["models.weight_cast"] == 0
    assert count["rwkv6.ddlerp"] == 2 * cfg.num_layers
    remat = [e for e in events if e.name() == "models.remat"]
    assert len(remat) == cfg.num_layers
    assert sum(_inside(e, remat) for e in events if e.name() == "rwkv6.ddlerp") == cfg.num_layers


# -- one clock -----------------------------------------------------------------

def test_an_obs_span_holds_the_profiler_range_it_encloses(tmp_path):
    obs.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.range("train.backward"):
            with obs.range("models.remat"):
                torch.ones(64, 64).sum()
    kineto = {e.name(): e for e in _ranges(prof)}
    spans = {e["name"]: e for e in obs.get_tracer().chrome_events() if e["ph"] == "X"}
    assert set(kineto) == set(spans) == {"train.backward", "models.remat"}
    assert spans["models.remat"]["args"]["parent_id"] == spans["train.backward"]["args"]["span_id"]

    path = tmp_path / "obs.json"
    obs.get_tracer().export_chrome(path)
    ours = json.loads(path.read_text())
    prof.export_chrome_trace(str(tmp_path / "kineto.json"))
    theirs = json.loads((tmp_path / "kineto.json").read_text())
    assert ours["baseTimeNanoseconds"] == theirs["baseTimeNanoseconds"]
    base = ours["baseTimeNanoseconds"]
    their_events = {e["name"]: e for e in theirs["traceEvents"] if e.get("name") in spans}
    for e in ours["traceEvents"]:
        if e["ph"] != "X":
            continue
        k = kineto[e["name"]]
        start, end = base + round(e["ts"] * 1e3), base + round((e["ts"] + e["dur"]) * 1e3)
        # the span opens before the profiler's range and closes after it
        assert start <= k.start_ns() and k.end_ns() <= end + 1
        t = their_events[e["name"]]
        assert e["ts"] <= t["ts"] and t["ts"] + t["dur"] <= e["ts"] + e["dur"] + 1e-3


def test_telemetry_alone_records_a_span_per_range():
    obs.enable()
    cfg = smoke_config("rwkv6-1.6b")
    step = make_train_step(cfg, AdamWConfig(lr=1e-3), TrainConfig(total_steps=10, warmup_steps=2))
    step(init_state(cfg, 0, device="cpu"), {"tokens": _tokens(cfg)})
    names = collections.Counter(e["name"] for e in obs.get_tracer().chrome_events()
                                if e["ph"] == "X")
    assert names["train.forward"] == names["train.backward"] == names["train.optimizer"] == 1
    assert names["rwkv6.ddlerp"] == 2 * cfg.num_layers


# -- the trainer's step time -----------------------------------------------------

def _loader(device):
    corpus = make_token_corpus(256, 17, vocab_size=256, seed=0)
    spec = RSPSpec(num_records=256, num_blocks=16, num_original_blocks=16, seed=1)
    return RSPLoader(BlockSource(blocks=two_stage_partition_np(corpus, spec), device=device),
                     batch_size=8, seed=3)


def _trainer(path, device, batch_transform):
    tc = TrainConfig(total_steps=3, warmup_steps=1, checkpoint_every=100, log_every=1, seed=0)
    return Trainer(smoke_config("llama3.2-1b"), AdamWConfig(lr=1e-2), tc, _loader(device),
                   str(path / "ckpt"), device=device, batch_transform=batch_transform)


def test_a_logged_step_on_the_host_counts_its_own_time(tmp_path):
    trainer = _trainer(tmp_path, "cpu", lambda b: {"tokens": b.to(torch.int32)})
    step_fn = trainer.step_fn

    def slow(state, batch):
        time.sleep(0.05)
        return step_fn(state, batch)

    trainer.step_fn = slow
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.run()
    assert [h["step"] for h in trainer.history] == [1, 2, 3]
    assert all(h["sec_per_step"] >= 0.05 for h in trainer.history), trainer.history
    count = _count(_ranges(prof))
    assert count["train.forward"] == count["train.backward"] == count["train.optimizer"] == 3


@pytest.mark.cuda
def test_a_logged_step_on_the_card_leaves_out_work_queued_before_it(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")

    def transform(b):
        # a long wait queued on the stream just before the logged step
        torch.cuda._sleep(int(2e9))
        return {"tokens": b.to(torch.int32)}

    # a first run builds the kernels and the libraries' handles, which its
    # first logged step would otherwise wait for
    _trainer(tmp_path / "warm", "cuda", lambda b: {"tokens": b.to(torch.int32)}).run()
    trainer = _trainer(tmp_path, "cuda", transform)
    trainer.run()
    torch.cuda.synchronize()
    steps = [h["sec_per_step"] for h in trainer.history]
    assert len(steps) == 3
    # each _sleep is about a second of the card's time; a step of the smoke
    # config is milliseconds
    assert all(0 < s < 0.25 for s in steps), steps
