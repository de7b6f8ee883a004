"""Tensor-parallel compute over "model" (``repro_torch.distributed.
tensor_parallel``), held to the single-process step and to the
reference's GSPMD step on the CPU.

One set of gloo children a mesh -- (1, 2), (2, 2) and (1, 3) -- carries
every case (``tests/test_torch_mesh.py``'s ``run_children``, one intra-op
thread each).  Each child runs, for every case of its mesh, from the
reference's initial parameters (``repro.models.common.init_params``, key
0) and the same batches:

* 3 training steps under ``default_rules`` against 3 single-process steps
  of the same batches (each child runs those too), teacher-forced as
  ``tests/test_torch_train.py`` forces the hybrid and RWKV6 (each step
  starts from the single-process state), held to that file's tolerances:
  loss 1e-3, gradient norm 1e-2 relative, and every leaf's first and
  second moments 5e-2 relative L2 (its ``_moments_close``; a first step's
  Adam update is the sign of each gradient entry, which bf16 rounding
  flips near zero, so the master's update is not compared).  An MoE
  router choice near a tie can flip under the row-parallel sums' rounding
  and send a token to another expert, so the split run replays the
  unsplit run's top-k choices (its own router's probabilities taken at
  them).  The hybrid's and RWKV6's gradients are ill-conditioned at the
  smoke width -- a WKV output near zero at a sequence's first position
  meets the group norm's eps, and the single-process step's own gradient
  norm moves 19% (RWKV6) and its leaves up to 11% (both) under a 1e-3
  relative perturbation of the embedding -- so RWKV6 runs with the group
  norm's eps at 1e-2 and both are held to 3e-2 (gradient norm) and 3e-1
  (moments, ``SCAN_*``);
* the same 3 steps free-running, against the reference's GSPMD steps
  (below);
* a prefill of 2 x 8 tokens and 3 decode tokens (the encoder: its
  forward) on this rank's parameter and cache chunks (``local_caches``),
  every position's logits gathered over "model" and held to the
  single-process run's within ``LOGIT_TOL`` (bf16 logits; the dense,
  hybrid and RWKV6 layer-by-layer checks' 2e-2, relative to the largest
  logit);
* the MoE layer alone (``moe_apply``) on one input, expert and
  ``expert_ff`` split, within 2e-2 of the unsplit layer (bf16 combine
  added in another order, ``MOE_LAYER_TOL``);
* llama's gradients with the backward on another thread, as the autograd
  engine runs a CUDA backward (where the layers' recomputation must keep
  the forward's tensor-parallel context), equal to the same thread's;
* on (1, 2), a dense step's aten FLOPs on each rank (``FlopCounterMode``)
  at most 0.6x the single-process step's, and rank 0's FLOPs and argument
  bytes those of the dry run of the same step on a fake two-rank world
  (``launch/dryrun.py``, fake host tensors).

The reference's jitted ``make_train_step(rules=default_rules(mesh))`` runs
the same 3 steps in one child on a forced-host-device mesh of the same
shape (as ``tests/distributed_harness.py``'s ``run_forced_devices``),
beside the gloo children; its losses and gradient norms are held to the
port's free-running steps at ``REF_LOSS_TOL`` 2e-3 and
``REF_GRAD_NORM_REL`` 2e-2 (or the family's gradient-norm tolerance, if
larger) -- all 3 steps for the dense decoders and the encoder, the first
for the rest.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.configs import smoke_config as ref_smoke_config
from repro.models import api as ref_api
from repro.models.common import init_params as ref_init_params
from repro_torch.distributed import serve_store
from test_torch_mesh import SRC, assert_ok, gloo_init, marked, run_children

LOSS_TOL = 1e-3
GRAD_NORM_REL = 1e-2
UPDATE_REL_L2 = 5e-2
LOGIT_TOL = 2e-2
MOE_LAYER_TOL = 2e-2
# the hybrid's and RWKV6's gradients (see the module's notes)
SCAN_GRAD_NORM_REL = 3e-2
SCAN_MOMENT_REL_L2 = 3e-1
REF_LOSS_TOL = 2e-3
REF_GRAD_NORM_REL = 2e-2
FLOP_RATIO = 0.6
STEPS, BATCH, SEQ, LR = 3, 8, 17, 1e-2

# name: (arch, config overrides, meshes, held to the reference's GSPMD
# step at its first step only: the hybrid's and RWKV6's full-rate steps
# amplify any rounding, and an MoE router choice near a tie may flip)
CASES = {
    "llama": ("llama3.2-1b", {}, ("1x2", "2x2"), False),
    # 4 heads of 12 on 3 ranks: the q columns and o rows rest in chunks of
    # 16 (a head and a third), and the vocab of 256 stays whole
    "llama 4 heads on 3": ("llama3.2-1b", {"head_dim": 12}, ("1x3",), False),
    "qwen3": ("qwen3-14b", {}, ("1x2", "2x2"), False),
    "hubert": ("hubert-xlarge", {}, ("1x2", "2x2"), False),
    # 5 experts on 2 model ranks: expert_ff takes the split (granite-moe's
    # 40 experts on 16 ranks)
    "granite-moe": ("granite-moe-3b-a800m", {"num_experts": 5}, ("1x2", "2x2"), True),
    "qwen3-moe": ("qwen3-moe-30b-a3b", {}, ("1x2", "2x2"), True),
    "zamba2": ("zamba2-7b", {}, ("1x2", "2x2"), True),
    # the group norm's eps raised (see the module's notes)
    "rwkv6": ("rwkv6-1.6b", {"norm_eps": 1e-2}, ("1x2", "2x2"), True),
}
MESHES = {"1x2": (1, 2), "2x2": (2, 2), "1x3": (1, 3)}


def _cases(mesh: str) -> list[str]:
    return [name for name, c in CASES.items() if mesh in c[2]]


CHILD = r"""
import dataclasses, json, os, sys, threading, time
import numpy as np
import torch
import torch.distributed as dist
%(GLOO_INIT)s
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs import smoke_config
from repro_torch.distributed import tensor_parallel as tpl
from repro_torch.distributed.elastic import reshard_state, state_shardings
from repro_torch.distributed.sharding import (activation_sharding, default_rules, gather,
                                              local_caches, local_chunk, param_shardings)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.roofline import local_bytes
from repro_torch.models import api, moe as moe_lib
from repro_torch.models.common import iter_leaves, set_leaf
from repro_torch.models.transformer import build_lm, init_caches
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, init_state, make_train_step
from torch.distributed.tensor import DTensor

torch.set_num_threads(1)
out_dir = os.environ["RSP_OUT"]
shape = tuple(json.loads(os.environ["MESH"]))
BATCH_ROWS = %(BATCH)d // shape[0]       # a data rank's rows
cases = json.loads(os.environ["CASES"])
mesh = make_host_mesh(shape, ("data", "model"), device_type="cpu")
rank = dist.get_rank()


def tree_of(npz):
    out = {}
    for key in npz.files:
        set_leaf(out, tuple(key.split("/")), npz[key])
    return out


def batches(name):
    npz = np.load(os.path.join(out_dir, name + "_batches.npz"))
    keys = sorted({k.split(":")[1] for k in npz.files})
    out = []
    for i in range(%(STEPS)d):
        b = {}
        for k in keys:
            a = torch.from_numpy(npz[f"{i}:{k}"])
            b[k] = a.bfloat16() if k == "frames" else a
        out.append(b)
    return out


def full_local(t):
    return gather(t) if isinstance(t, DTensor) else t


def masters(state):
    return {"/".join(p): full_local(t).clone() for p, t in iter_leaves(state["opt"]["master"])}


def rel_l2(a, b):
    return float(torch.linalg.vector_norm(a - b) / max(float(torch.linalg.vector_norm(b)), 1e-30))


def gather_vocab(logits, tp):
    # every rank's columns of vocab-split logits, made whole
    if tp is None or not tp.splits("vocab"):
        return logits
    return tpl.gather_last(logits.float(), logits.shape[-1] * tp.size, tp)


def serve(cfg, params, tp, rules, frames=None):
    # a prefill of 2 x 8 tokens and 3 decode tokens (the encoder: its
    # forward); under rules on this data rank's rows
    rows = slice(None)
    if rules is not None:
        d, n = mesh.get_coordinate()[0], shape[0]
        rows = slice(d * 2 // n, (d + 1) * 2 // n)
    with torch.no_grad(), activation_sharding(rules), tpl.tensor_parallel(tp):
        model = build_lm(cfg, params, device="cpu")
        if cfg.family == "encoder":
            return [gather_vocab(api.make_forward_fn(model)({"frames": frames[rows]}),
                                 tp).float()]
        toks = torch.from_numpy(np.random.default_rng(7).integers(
            0, cfg.vocab_size, (2, 11), dtype=np.int32))[rows]
        caches = init_caches(cfg, toks.shape[0], 16, dtype=torch.float32, device="cpu")
        if rules is not None:
            caches = local_caches(caches, rules)
        logits, caches = api.make_prefill_fn(model)(caches, {"tokens": toks[:, :8]})
        outs = [gather_vocab(logits, tp).float()]
        for t in range(8, 11):
            logits, caches = api.make_decode_fn(model)(caches, {"tokens": toks[:, t:t + 1]})
            outs.append(gather_vocab(logits, tp).float())
        return outs


def step_flops(step, state, batch):
    with FlopCounterMode(display=False) as counter:
        step(state, batch)
    return counter.get_total_flops()


ROUTES, MODE = [], ["off", 0]
_route = moe_lib.route


def route(params, xt, c):
    # record the unsplit run's top-k choices; replay them in the split run,
    # its own router's probabilities taken at them (renormalised as route
    # does), so a choice near a tie cannot flip under the split's rounding
    logits, probs, top_w, top_idx = _route(params, xt, c)
    if MODE[0] == "record":
        ROUTES.append(top_idx.clone())
    elif MODE[0] == "replay":
        top_idx = ROUTES[MODE[1]]
        MODE[1] += 1
        n = probs.shape[1]            # this data rank's tokens of the batch
        if top_idx.shape[1] != n:
            d = mesh.get_coordinate()[0]
            top_idx = top_idx[:, d * n:(d + 1) * n]
        top_probs = torch.gather(probs, -1, top_idx)
        top_w = top_probs / torch.clamp_min(top_probs.sum(-1, keepdim=True), 1e-9)
    return logits, probs, top_w, top_idx


moe_lib.route = route


def paired(split_fn, single_fn):
    # the unsplit call records its routes, the split call replays them
    ROUTES.clear()
    MODE[:] = ["record", 0]
    want = single_fn()
    MODE[:] = ["replay", 0]
    got = split_fn()
    MODE[:] = ["off", 0]
    return got, want


def moments(state, part):
    return {"/".join(p): full_local(t).clone() for p, t in iter_leaves(state["opt"][part])}


report = {}
for name in cases:
    t_case = time.time()
    arch, over, forced = cases[name]
    cfg = dataclasses.replace(smoke_config(arch), **over)
    params = tree_of(np.load(os.path.join(out_dir, name + "_params.npz")))
    rules = default_rules(mesh, cfg=cfg)
    tp = tpl.from_rules(rules)
    tcfg = TrainConfig(total_steps=%(STEPS)d, warmup_steps=1)
    step = make_train_step(cfg, AdamWConfig(lr=%(LR)r), tcfg, rules=rules)
    single = make_train_step(cfg, AdamWConfig(lr=%(LR)r), tcfg)
    # teacher-forced: each step from the single-process state, the MoE's
    # routes replayed; every leaf's moments held
    ref_state = init_state(cfg, params=params, device="cpu")
    hist, ref_hist, worst = [], [], {}
    for batch in batches(name):
        state = reshard_state(ref_state, state_shardings(cfg, rules))
        (state, m), (ref_state, rm) = paired(lambda: step(state, batch),
                                              lambda: single(ref_state, batch))
        hist.append({k: float(v) for k, v in m.items()})
        ref_hist.append({k: float(v) for k, v in rm.items()})
        for part in ("m", "v"):
            got = moments(state, part)
            for k, w in moments(ref_state, part).items():
                if torch.any(w != 0):
                    worst[part + ":" + k] = max(worst.get(part + ":" + k, 0.0),
                                                rel_l2(got[k], w))
    # free-running, against the reference's GSPMD steps
    state = init_state(cfg, params=params, device="cpu", rules=rules)
    free = []
    for batch in batches(name):
        state, m = step(state, batch)
        free.append({k: float(v) for k, v in m.items()})
    entry = {"hist": hist, "single": ref_hist, "moments": worst, "free": free}
    # serving on the rank's chunks against the unsplit model
    p0 = {"/".join(p): t for p, t in iter_leaves(init_state(cfg, params=params, device="cpu")["params"])}
    frames = batches(name)[0].get("frames")
    frames = frames[:2, :8] if frames is not None else None
    local = {}
    for path, sh in iter_leaves(param_shardings(api.model_specs(cfg), rules)):
        set_leaf(local, path, local_chunk(p0["/".join(path)].float(), mesh, sh.placements()))
    full = {}
    for k, t in p0.items():
        set_leaf(full, tuple(k.split("/")), t.float())
    got, want = paired(lambda: serve(cfg, local, tp, rules, frames),
                       lambda: serve(cfg, full, None, None, frames))
    d, n = mesh.get_coordinate()[0], shape[0]
    want = [w[d * 2 // n:(d + 1) * 2 // n] for w in want]
    # numpy's allclose at rtol = atol = LOGIT_TOL: below 1 passes
    entry["logits"] = [float(((g - w).abs() / (%(LOGIT_TOL)r * (1 + w.abs()))).max())
                       for g, w in zip(got, want)]
    if cfg.family == "moe":
        # the layer alone, split and unsplit, on one input
        mcfg = cfg.moe_config()
        lp, fp = ({n: t[0] for n, t in tree["layers"]["moe"].items() if n != "router"}
                  for tree in (local, full))
        lp["router"] = {"w": local["layers"]["moe"]["router"]["w"][0]}
        fp["router"] = {"w": full["layers"]["moe"]["router"]["w"][0]}
        x = torch.from_numpy(np.random.default_rng(3).normal(
            size=(2, 8, cfg.d_model)).astype(np.float32)).bfloat16()
        with torch.no_grad():
            with activation_sharding(rules), tpl.tensor_parallel(tp):
                a, aux_a = moe_lib.moe_apply(lp, x, mcfg, dropless=True)
            b, aux_b = moe_lib.moe_apply(fp, x, mcfg, dropless=True)
        entry["moe_layer"] = float((a.float() - b.float()).abs().max() / b.float().abs().max())
        entry["moe_aux"] = [float(aux_a), float(aux_b)]
    if name == "llama":
        # the backward on another thread, as the autograd engine runs a CUDA
        # backward: the layers' recomputation keeps the forward's contexts
        tstate = init_state(cfg, params=params, device="cpu", rules=rules)
        tlocal = {}
        for path, t in iter_leaves(tstate["params"]):
            set_leaf(tlocal, path, t.to_local())
        grads = []
        for threaded in (False, True):
            with activation_sharding(rules), tpl.tensor_parallel(tp):
                model = build_lm(cfg, tlocal, device="cpu", trainable=True)
                loss, _ = api.make_loss_fn(model)(
                    {"tokens": batches(name)[0]["tokens"][:BATCH_ROWS]})
            if threaded:
                worker = threading.Thread(target=loss.backward)
                worker.start()
                worker.join()
            else:
                loss.backward()
            grads.append({p: t.grad.clone() for p, t in model.named_parameters()})
        entry["threaded_backward"] = all(torch.equal(grads[0][k], grads[1][k]) for k in grads[0])
    if name == "llama" and shape == (1, 2):
        fstate = init_state(cfg, params=params, device="cpu", rules=rules)
        sstate = init_state(cfg, params=params, device="cpu")
        b0 = batches(name)[0]
        entry["flops"] = [step_flops(step, fstate, b0), step_flops(single, sstate, b0)]
        entry["arguments"] = local_bytes(fstate) + sum(local_bytes(v) for v in b0.values())
    entry["seconds"] = time.time() - t_case
    report[name] = entry
print("RESULT " + json.dumps(report), flush=True)
dist.destroy_process_group()
print("TP_OK", flush=True)
"""


REF_CHILD = r"""
import dataclasses, json, os, time
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from repro.configs import smoke_config
from repro.distributed import sharding as ref_sharding
from repro.models import api
from repro.optim.adamw import AdamWConfig, adamw_init
from repro.train.loop import TrainConfig, make_train_step

out_dir = os.environ["RSP_OUT"]
shape = tuple(json.loads(os.environ["MESH"]))
cases = json.loads(os.environ["CASES"])
mesh = Mesh(np.array(jax.devices()[:shape[0] * shape[1]]).reshape(shape), ("data", "model"))
report = {}
for name in cases:
    t0 = time.time()
    arch, over, _ = cases[name]
    cfg = dataclasses.replace(smoke_config(arch), **over)
    npz = np.load(os.path.join(out_dir, name + "_params.npz"))
    flat = {tuple(k.split("/")): jnp.asarray(npz[k]) for k in npz.files}
    specs = api.model_specs(cfg)
    rules = ref_sharding.default_rules(mesh, cfg=cfg)
    params = jax.tree_util.tree_map_with_path(
        lambda p, s: flat[tuple(k.key for k in p)], specs,
        is_leaf=lambda x: hasattr(x, "axes"))
    psh = jax.tree.map(lambda s: NamedSharding(mesh, rules.spec_for(s.axes)), specs,
                       is_leaf=lambda x: hasattr(x, "axes"))
    params = jax.tree.map(jax.device_put, params, psh)
    state = {"params": jax.tree.map(lambda a: a.astype(jnp.bfloat16), params),
             "opt": adamw_init(params)}
    step = jax.jit(make_train_step(cfg, AdamWConfig(lr=%(LR)r), TrainConfig(
        total_steps=%(STEPS)d, warmup_steps=1), rules=rules))
    bnpz = np.load(os.path.join(out_dir, name + "_batches.npz"))
    keys = sorted({k.split(":")[1] for k in bnpz.files})
    hist = []
    for i in range(%(STEPS)d):
        batch = {k: jnp.asarray(bnpz[f"{i}:{k}"]) for k in keys}
        if "frames" in batch:
            batch["frames"] = batch["frames"].astype(jnp.bfloat16)
        bsh = NamedSharding(mesh, jax.sharding.PartitionSpec(rules.rules["batch"]))
        batch = {k: jax.device_put(v, bsh) for k, v in batch.items()}
        state, m = step(state, batch)
        hist.append({k: float(v) for k, v in m.items()})
    report[name] = hist
    print("SECONDS", name, time.time() - t0, flush=True)
print("RESULT " + json.dumps(report), flush=True)
"""


DRY_CHILD = r"""
import json
from repro_torch.configs import ShapeCell, smoke_config
from repro_torch.launch.dryrun import dryrun_cell, init_fake_world
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train import TrainConfig

init_fake_world(2)
mesh = make_host_mesh((1, 2), ("data", "model"), device_type="cpu")
r = dryrun_cell("llama3.2-1b", "t", cfg=smoke_config("llama3.2-1b"),
                cell=ShapeCell("t", "train", %(SEQ)d - 1, %(BATCH)d),
                train_cfg=TrainConfig(total_steps=%(STEPS)d, warmup_steps=1), mesh=mesh)
print("RESULT " + json.dumps({"flops": r["analysis"]["aten_flops"],
                              "arguments": r["memory"]["argument_size_in_bytes"]}))
"""


def _write_inputs(out_dir, names):
    """The reference's initial parameters (key 0) and 3 batches of each
    case, as npz files the children read."""
    for name in names:
        arch, over, _, _ = CASES[name]
        rcfg = dataclasses.replace(ref_smoke_config(arch), **over)
        params = ref_init_params(ref_api.model_specs(rcfg), jax.random.PRNGKey(0))
        flat = {"/".join(k.key for k in path): np.asarray(v, np.float32)
                for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
        np.savez(os.path.join(out_dir, name + "_params.npz"), **flat)
        rng = np.random.default_rng(5)
        arrays = {}
        for i in range(STEPS):
            if rcfg.family == "encoder":
                arrays[f"{i}:frames"] = rng.normal(size=(BATCH, SEQ - 1, rcfg.d_model)).astype(
                    np.float32)
                arrays[f"{i}:targets"] = rng.integers(0, rcfg.vocab_size, (BATCH, SEQ - 1),
                                                      dtype=np.int32)
                arrays[f"{i}:mask"] = rng.random((BATCH, SEQ - 1)) < 0.3
            else:
                arrays[f"{i}:tokens"] = rng.integers(0, rcfg.vocab_size, (BATCH, SEQ),
                                                     dtype=np.int32)
        np.savez(os.path.join(out_dir, name + "_batches.npz"), **arrays)


def _run(mesh_name, tmp_path):
    shape = MESHES[mesh_name]
    names = _cases(mesh_name)
    _write_inputs(str(tmp_path), names)
    cases = json.dumps({n: [CASES[n][0], CASES[n][1], CASES[n][3]] for n in names})
    # the reference's GSPMD steps, beside the gloo children
    env = dict(os.environ, RSP_OUT=str(tmp_path), MESH=json.dumps(shape), CASES=cases,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={shape[0] * shape[1]}",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC + os.pathsep + os.environ.get("PYTHONPATH", ""))
    # three children, a third of the cases each: their jit compiles dominate
    refs = [subprocess.Popen([sys.executable, "-c", REF_CHILD % {"LR": LR, "STEPS": STEPS}],
                             env=dict(env, CASES=json.dumps(
                                 {n: c for n, c in json.loads(cases).items()
                                  if names.index(n) % 3 == i})),
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i in range(min(3, len(names)))]
    if mesh_name == "1x2":       # rank 0 of a fake two-rank world's dry run of the llama step
        refs.append(subprocess.Popen(
            [sys.executable, "-c", DRY_CHILD % {"SEQ": SEQ, "BATCH": BATCH, "STEPS": STEPS}],
            env=dict(env, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    server = serve_store()
    source = CHILD % {"GLOO_INIT": gloo_init(), "LR": LR, "STEPS": STEPS,
                      "LOGIT_TOL": LOGIT_TOL, "BATCH": BATCH}
    try:
        children = run_children(source, shape[0] * shape[1], timeout=300.0,
                                env={"RSP_STORE": f"127.0.0.1:{server.port}",
                                     "MESH": json.dumps(shape), "RSP_OUT": str(tmp_path),
                                     "CASES": cases})
        outs = [ref.communicate(timeout=400) for ref in refs]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
    assert_ok(children, "TP_OK")
    report = {}
    for i, (ref, (out, err)) in enumerate(zip(refs, outs)):
        assert ref.returncode == 0, err[-4000:]
        line = next(ln for ln in out.splitlines() if ln.startswith("RESULT "))
        got = json.loads(line[len("RESULT "):])
        report.update({"dry run": got} if i == len(names[:3]) else got)
    return [marked(c, "RESULT ") for c in children], report


def _check(results, ref, mesh_name):
    for name in _cases(mesh_name):
        free_running = not CASES[name][3]
        scan = name in ("zamba2", "rwkv6")
        norm_rel = SCAN_GRAD_NORM_REL if scan else GRAD_NORM_REL
        moment_rel = SCAN_MOMENT_REL_L2 if scan else UPDATE_REL_L2
        first = results[0][name]
        for r in results:              # every rank reports the same steps
            assert r[name]["hist"] == first["hist"], name
            assert r[name]["free"] == first["free"], name
        for i, (g, w) in enumerate(zip(first["hist"], first["single"])):
            assert abs(g["loss"] - w["loss"]) < LOSS_TOL, (name, i, g, w)
            assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=norm_rel), (name, i, g, w)
            assert g["lr"] == w["lr"]
        assert first["moments"], name
        for key, rel in first["moments"].items():
            assert rel < moment_rel, (name, key, rel)
        for i, (g, rm) in enumerate(zip(first["free"], ref[name])):
            if i == 0 or free_running:   # against the reference's GSPMD step
                assert abs(g["loss"] - rm["loss"]) < REF_LOSS_TOL, (name, i, g, rm)
                assert g["grad_norm"] == pytest.approx(
                    rm["grad_norm"], rel=max(REF_GRAD_NORM_REL, norm_rel)), (name, i, g, rm)
        for r in results:
            assert max(r[name]["logits"]) < 1, (name, r[name]["logits"])
            assert r[name].get("threaded_backward", True), name
            if "moe_layer" in r[name]:
                assert r[name]["moe_layer"] < MOE_LAYER_TOL, (name, r[name]["moe_layer"])
                a, b = r[name]["moe_aux"]
                assert a == pytest.approx(b, rel=1e-6), name     # computed once, replicated


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_tensor_parallel_steps_and_serving_match(mesh_name, tmp_path):
    results, ref = _run(mesh_name, tmp_path)
    _check(results, ref, mesh_name)
    if mesh_name == "1x2":
        for r in results:
            got, single = r["llama"]["flops"]
            assert got <= FLOP_RATIO * single, (got, single)
        # the dry run of the step on a fake two-rank world is rank 0's program
        assert ref["dry run"] == {"flops": results[0]["llama"]["flops"][0],
                                  "arguments": results[0]["llama"]["arguments"]}
