"""The port's sharding rules, placements and training under rules, held to
the reference's ``repro.distributed.sharding`` on the CPU.

* Specs: every config's spec tree (path, shape, logical axes) equals the
  reference's, and ``default_rules`` on an ``AbstractMesh`` of each shape
  gives the reference's rules, param specs, ZeRO specs and cache specs on a
  ``Mesh`` of the same shape over repeated host devices
  (``tests/test_distributed.py``'s construction), up to the 512 ranks of
  two pods.  The reference's own rule tests are ported.
* Placements: on a 2 x 2 gloo mesh every rank's local shard has the shape
  the reference's ``NamedSharding.shard_shape`` gives; a ("pod", "data")
  entry deals shard p * D + d to rank (p, d); gathering gives the bits
  back.
* Training under rules (llama's smoke config, 3 steps of a global batch
  of 8 x 17) is held to ``tests/test_torch_train.py``'s tolerances (loss
  1e-3, gradient norm 1e-2 relative, master updates 5e-2 relative L2) on
  every mesh: model ranks compute their own heads, ff columns and vocab
  rows (``distributed.tensor_parallel``), whose row-parallel sums add in
  another order than one card's products, and each data rank's bf16
  gradients of its shard, summed in float32, round otherwise than the
  gradients of the whole batch.  Each rank's master, m and v have the
  reference's ZeRO shard shapes.

Multi-rank cases run gloo children (``tests/test_torch_mesh.py``'s
``run_children``, 60 s a child); they and the single-process step run one
intra-op thread each, so reductions add in the same order.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import NamedSharding as RefNamedSharding
from jax.sharding import PartitionSpec as RefP

from repro.configs import ARCHS as REF_ARCHS
from repro.distributed import sharding as ref_sharding
from repro.models import api as ref_api
from repro.models.common import ParamSpec as RefParamSpec
from repro.models.transformer import init_caches as ref_init_caches
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.distributed import serve_store
from repro_torch.distributed.sharding import (
    AbstractMesh,
    P,
    ShardingRules,
    abstract_compute_params,
    abstract_state,
    activation_sharding,
    attach_shardings,
    activation_spec,
    batch_shardings,
    block_ownership,
    cache_shardings,
    constrain,
    default_rules,
    optimizer_shardings,
    param_shardings,
    zero_shard_spec,
)
from repro_torch.distributed.ownership import BlockOwnership
from repro_torch.launch.mesh import (
    MULTI_POD_AXES,
    MULTI_POD_SHAPE,
    make_host_mesh,
    make_production_mesh,
)
from repro_torch.models import api
from repro_torch.models.common import ParamSpec, iter_leaves
from repro_torch.models.transformer import init_caches
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, init_state, make_train_step
from test_torch_mesh import assert_ok, gloo_init, marked, run_children

MESHES = {
    "1x1": ((1, 1), ("data", "model")),
    "1x4": ((1, 4), ("data", "model")),
    "4x1": ((4, 1), ("data", "model")),
    "2x2": ((2, 2), ("data", "model")),
    "16x16": ((16, 16), ("data", "model")),
    "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
}

LOSS_TOL = 1e-3
GRAD_NORM_REL = 1e-2
UPDATE_REL_L2 = 5e-2
STEPS, BATCH, SEQ, LR = 3, 8, 17, 1e-2


def _ref_mesh(shape, axes) -> Mesh:
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices() * n).reshape(shape), axes)


def _ref_specs(specs) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, RefParamSpec))[0]
    return {tuple(k.key for k in path): s for path, s in flat}


def _ref_paths(tree) -> dict:
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(k.key for k in path): leaf for path, leaf in flat}


# ---------------------------------------------------------------------------
# specs and rules against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_spec_tree_matches_the_reference(arch):
    want = {p: (s.shape, s.axes, s.init, s.scale)
            for p, s in _ref_specs(ref_api.model_specs(REF_ARCHS[arch])).items()}
    got = {p: (s.shape, s.axes, s.init, s.scale)
           for p, s in iter_leaves(api.model_specs(ARCHS[arch]))}
    assert got == want


def test_param_spec_checks_its_rank():
    with pytest.raises(ValueError, match="rank mismatch"):
        ParamSpec((3, 4), ("embed",))


_CACHE_SHAPES: dict = {}


def _cache_trees(arch):
    """(reference abstract caches, the port's caches as meta tensors) at
    batch 2, length 4."""
    if arch not in _CACHE_SHAPES:
        caches = init_caches(ARCHS[arch], 2, 4, device="cpu")
        meta = {}
        for path, leaf in iter_leaves(caches):
            node = meta
            for name in path[:-1]:
                node = node.setdefault(name, {})
            node[path[-1]] = (torch.empty(leaf.shape, dtype=leaf.dtype, device="meta")
                              if isinstance(leaf, torch.Tensor) else leaf)
        del caches
        _CACHE_SHAPES[arch] = (jax.eval_shape(lambda: ref_init_caches(REF_ARCHS[arch], 2, 4)),
                               meta)
    return _CACHE_SHAPES[arch]


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_rules_and_every_spec_match_the_reference(arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    ref_rules = ref_sharding.default_rules(_ref_mesh(shape, axes), cfg=REF_ARCHS[arch])
    rules = default_rules(AbstractMesh(shape, axes), cfg=ARCHS[arch])
    assert rules.rules == ref_rules.rules
    ref_specs = _ref_specs(ref_api.model_specs(REF_ARCHS[arch]))
    specs = dict(iter_leaves(api.model_specs(ARCHS[arch])))
    assert specs.keys() == ref_specs.keys()
    for path, spec in specs.items():
        r = ref_specs[path]
        assert tuple(rules.spec_for(spec.axes)) == tuple(ref_rules.spec_for(r.axes)), path
        assert tuple(zero_shard_spec(spec, rules)) == tuple(
            ref_sharding.zero_shard_spec(r, ref_rules)), path
    got_p = {p: tuple(s.spec)
             for p, s in iter_leaves(param_shardings(api.model_specs(ARCHS[arch]), rules))}
    assert got_p == {p: tuple(rules.spec_for(s.axes)) for p, s in specs.items()}
    opt = optimizer_shardings(api.model_specs(ARCHS[arch]), rules)
    assert tuple(opt["step"].spec) == ()
    assert all(tuple(s.spec) == tuple(zero_shard_spec(specs[p], rules))
               for p, s in iter_leaves(opt["master"]))
    if ARCHS[arch].family == "encoder":
        return
    ref_caches, caches = _cache_trees(arch)
    want = {p: tuple(s.spec)
            for p, s in _ref_paths(ref_sharding.cache_shardings(ref_caches, ref_rules)).items()}
    got = {p: tuple(s.spec) for p, s in iter_leaves(cache_shardings(caches, rules))}
    assert got == want


def _rules(num_kv=8, tp=1):
    return default_rules(AbstractMesh((1, tp), ("data", "model")), num_kv_heads=num_kv)


def test_rules_kv_sharding_threshold():
    # kv heads shard over 'model' only when divisible by the TP degree
    assert _rules(8, tp=4).rules["kv_heads"] == "model"
    assert _rules(8, tp=4).rules["heads_inner"] is None
    assert _rules(1, tp=4).rules["kv_heads"] is None
    assert _rules(1, tp=4).rules["heads_inner"] == "model"
    assert _rules(6, tp=4).rules["kv_heads"] is None  # 6 % 4 != 0


def test_spec_mapping():
    r = _rules()
    assert r.spec_for(("embed", "ff")) == P(None, "model")
    assert r.spec_for(("layers", "embed", "heads")) == P(None, None, "model")
    assert r.spec_for(("vocab", "embed")) == P("model", None)


def test_zero_shard_picks_largest_replicated_dim():
    r = default_rules(AbstractMesh((4, 1), ("data", "model")))
    # [layers=8, d=64, ff->model]: ZeRO should shard d (=64, divisible by 4)
    spec = ParamSpec((8, 64, 128), ("layers", "embed", "ff"))
    assert zero_shard_spec(spec, r) in (P("data", None, "model"), P(None, "data", "model"))
    # all dims too small / already sharded -> unchanged
    assert zero_shard_spec(ParamSpec((3,), ("embed",)), r) == P(None)


def test_constrain_noop_without_context():
    x = torch.ones((2, 3))
    y = constrain(x, ("batch", None))
    assert y is x


@pytest.mark.parametrize("case", ["size-1 batch", "batch against kv_seq"])
def test_constrain_resolves_the_reference_spec(case, monkeypatch):
    shape, axes, kv_seq = {
        "size-1 batch": ((1, 8, 16), ("batch", "heads", None), False),
        "batch against kv_seq": ((4, 2, 16, 8), ("batch", "kv_heads", "kv_seq", None), True),
    }[case]
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, sh: seen.append(sh.spec) or x)
    ref_rules = ref_sharding.default_rules(_ref_mesh((2, 2), ("data", "model")),
                                           num_kv_heads=2, shard_kv_seq=kv_seq)
    with ref_sharding.activation_sharding(ref_rules):
        ref_sharding.constrain(jnp.zeros(shape), axes)
    rules = default_rules(AbstractMesh((2, 2), ("data", "model")), num_kv_heads=2,
                          shard_kv_seq=kv_seq)
    assert rules.rules == ref_rules.rules
    assert tuple(activation_spec(shape, axes, rules)) == tuple(seen[0])
    x = torch.zeros(shape)
    with activation_sharding(rules):
        assert constrain(x, axes) is x          # a plain tensor: each rank holds it whole
        with pytest.raises(ValueError, match="rank"):
            constrain(x, axes[:-1])


def test_batch_and_abstract_shardings_match_the_reference():
    shape, axes = MESHES["2x16x16"]
    rcfg, cfg = REF_ARCHS["llama3.2-1b"], ARCHS["llama3.2-1b"]
    ref_rules = ref_sharding.default_rules(_ref_mesh(shape, axes), cfg=rcfg)
    rules = default_rules(AbstractMesh(MULTI_POD_SHAPE, MULTI_POD_AXES), cfg=cfg)
    batch = {"tokens": jax.ShapeDtypeStruct((256, 4097), jnp.int32),
             "one": jax.ShapeDtypeStruct((1, 8), jnp.int32)}
    want = {k: tuple(s.spec) for k, s in ref_sharding.batch_shardings(batch, ref_rules).items()}
    got = batch_shardings({"tokens": torch.empty((256, 4097), device="meta"),
                           "one": torch.empty((1, 8), device="meta")}, rules)
    assert {k: tuple(s.spec) for k, s in got.items()} == want
    assert got["tokens"].shard_shape((256, 4097)) == RefNamedSharding(
        _ref_mesh(shape, axes), RefP(*want["tokens"])).shard_shape((256, 4097))
    # the abstract state and compute parameters carry the reference's specs
    ref_state = _ref_paths(ref_sharding.abstract_state(ref_api.model_specs(rcfg), ref_rules))
    state = dict(iter_leaves(abstract_state(api.model_specs(cfg), rules)))
    assert state.keys() == ref_state.keys()
    for path, leaf in state.items():
        ref = ref_state[path]
        assert leaf.shape == ref.shape and leaf.meta.device.type == "meta", path
        assert tuple(leaf.sharding.spec) == tuple(ref.sharding.spec), path
        assert leaf.sharding.shard_shape(leaf.shape) == ref.sharding.shard_shape(ref.shape), path
    assert state[("step",)].dtype == torch.int32
    # attach_shardings pairs any tree of shapes with its shardings
    ref_caches, caches = _cache_trees("llama3.2-1b")
    ref_att = _ref_paths(ref_sharding.attach_shardings(
        ref_caches, ref_sharding.cache_shardings(ref_caches, ref_rules)))
    tensors = {"layers": {k: v for k, v in caches["layers"].items() if k != "length"}}
    att = dict(iter_leaves(attach_shardings(tensors, cache_shardings(tensors, rules))))
    assert att.keys() == {p for p in ref_att if p[-1] != "length" and p != ("pos",)}
    for path, leaf in att.items():
        assert leaf.shape == ref_att[path].shape and leaf.dtype == torch.bfloat16
        assert tuple(leaf.sharding.spec) == tuple(ref_att[path].sharding.spec), path
    ref_params = _ref_paths(ref_sharding.abstract_compute_params(ref_api.model_specs(rcfg),
                                                                 ref_rules))
    params = dict(iter_leaves(abstract_compute_params(api.model_specs(cfg), rules)))
    for path, leaf in params.items():
        assert leaf.dtype == torch.bfloat16 and leaf.shape == ref_params[path].shape
        assert tuple(leaf.sharding.spec) == tuple(ref_params[path].sharding.spec), path


def test_block_ownership_is_the_deal():
    assert block_ownership(10, 3, seed=2) == BlockOwnership.deal(10, 3, seed=2)
    assert block_ownership(10) == BlockOwnership.deal(10, 1)     # no process group


def test_meshes_need_a_process_group_and_the_production_size():
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh((1, 1), ("data", "model"), device_type="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh()


# ---------------------------------------------------------------------------
# placements on a real gloo mesh
# ---------------------------------------------------------------------------

PLACEMENT_CHILD = r"""
import json, os
import torch
import torch.distributed as dist
%(GLOO_INIT)s
from repro_torch.configs import smoke_config
from repro_torch.distributed.ownership import BlockOwnership
from repro_torch.distributed.sharding import (NamedSharding, P, activation_sharding,
                                              block_ownership, constrain, default_rules, gather,
                                              param_shardings, optimizer_shardings, shard_tensor)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import api
from repro_torch.models.common import iter_leaves

cfg = smoke_config("llama3.2-1b")
mesh = make_host_mesh((2, 2), ("data", "model"), device_type="cpu")
rules = default_rules(mesh, cfg=cfg)
specs = api.model_specs(cfg)
gen = torch.Generator().manual_seed(3)
shapes, exact = {}, True
for kind, tree in (("param", param_shardings(specs, rules)),
                   ("zero", optimizer_shardings(specs, rules)["master"])):
    for path, sh in iter_leaves(tree):
        spec = dict(iter_leaves(specs))[path]
        full = torch.randn(spec.shape, generator=gen)
        dt = shard_tensor(full, sh)
        shapes[kind + ":" + "/".join(path)] = list(dt.to_local().shape)
        exact &= torch.equal(gather(dt), full)

# a ("pod", "data") entry on a (2, 2, 1) mesh: rank (p, d) holds shard p * 2 + d
mesh3 = make_host_mesh((2, 2, 1), ("pod", "data", "model"), device_type="cpu")
full = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
dt = shard_tensor(full, NamedSharding(mesh3, P(("pod", "data"), None)))
p, d, _ = mesh3.get_coordinate()
dealt = torch.equal(dt.to_local(), full[2 * (p * 2 + d): 2 * (p * 2 + d) + 2])
exact &= torch.equal(gather(dt), full)

# constrain redistributes a DTensor to the resolved spec
x = shard_tensor(torch.randn(4, 8, generator=gen), NamedSharding(mesh, P(None, None)))
with activation_sharding(rules):
    y = constrain(x, ("batch", "heads"))

# a host mesh holds every rank of the world, never a part of it
try:
    make_host_mesh((1, 2), ("data", "model"), device_type="cpu")
    refused = ""
except ValueError as e:
    refused = str(e)
# the deal of a mesh is by its rank count
deals = (block_ownership(10, mesh) == BlockOwnership.deal(10, 4)
         and block_ownership(10, 2) == BlockOwnership.deal(10, 2)
         and block_ownership(10) == BlockOwnership.deal(10, 4))
print("RESULT " + json.dumps({"shapes": shapes, "exact": bool(exact), "dealt": dealt,
                              "constrained": list(y.to_local().shape), "refused": refused,
                              "deals": deals}), flush=True)
dist.destroy_process_group()
print("PLACED_OK", flush=True)
""" % {"GLOO_INIT": gloo_init()}


def test_placements_give_the_reference_shard_shapes():
    server = serve_store()
    children = run_children(PLACEMENT_CHILD, 4, env={"RSP_STORE": f"127.0.0.1:{server.port}"})
    assert_ok(children, "PLACED_OK")
    ref_mesh = _ref_mesh((2, 2), ("data", "model"))
    cfg = smoke_config("llama3.2-1b")
    from repro.configs import smoke_config as ref_smoke_config

    ref_rules = ref_sharding.default_rules(ref_mesh, cfg=ref_smoke_config("llama3.2-1b"))
    want = {}
    for path, s in _ref_specs(ref_api.model_specs(ref_smoke_config("llama3.2-1b"))).items():
        key = "/".join(path)
        want["param:" + key] = list(ref_rules.named(s.axes).shard_shape(s.shape))
        want["zero:" + key] = list(RefNamedSharding(
            ref_mesh, ref_sharding.zero_shard_spec(s, ref_rules)).shard_shape(s.shape))
    assert len(want) == 2 * len(list(iter_leaves(api.model_specs(cfg))))
    for child in children:
        got = marked(child, "RESULT ")
        assert got["shapes"] == want
        assert got["exact"] and got["dealt"] and got["deals"]
        assert got["constrained"] == [2, 4]
        assert "holds 2 ranks; the process group has 4" in got["refused"]


# ---------------------------------------------------------------------------
# training under rules
# ---------------------------------------------------------------------------

TRAIN_CHILD = r"""
import json, os
import numpy as np
import torch
import torch.distributed as dist
%(GLOO_INIT)s
from repro_torch.configs import smoke_config
from repro_torch.distributed.sharding import default_rules, gather
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.common import iter_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, init_state, make_train_step

from repro_torch.models import api

# the batch each rank's loss sees
seen, make_loss_fn = [], api.make_loss_fn
def spy(model, **kw):
    fn = make_loss_fn(model, **kw)
    return lambda batch: (seen.append(batch["tokens"][:, 0].tolist()), fn(batch))[1]
api.make_loss_fn = spy

shape = tuple(json.loads(os.environ["MESH"]))
cfg = smoke_config("llama3.2-1b")
mesh = make_host_mesh(shape, ("data", "model"), device_type="cpu")
rules = default_rules(mesh, cfg=cfg)
state = init_state(cfg, 0, device="cpu", rules=rules)
step = make_train_step(cfg, AdamWConfig(lr=%(LR)r), TrainConfig(total_steps=%(STEPS)d,
                                                                 warmup_steps=1), rules=rules)
rng = np.random.default_rng(5)
hist = []
for _ in range(%(STEPS)d):
    toks = rng.integers(0, cfg.vocab_size, (%(BATCH)d, %(SEQ)d), dtype=np.int32)
    state, m = step(state, {"tokens": torch.from_numpy(toks)})
    hist.append({k: float(v) for k, v in m.items()})
    if len(seen) == 1:
        first = toks[:, 0].tolist()
# a global batch the data ranks do not divide is refused on every rank,
# before any collective (10 rows on 4 data ranks, 9 on 2)
refused = ""
if shape[0] > 1:
    rows = %(BATCH)d + shape[0] // 2
    toks = rng.integers(0, cfg.vocab_size, (rows, %(SEQ)d), dtype=np.int32)
    try:
        step(state, {"tokens": torch.from_numpy(toks)})
    except ValueError as e:
        refused = str(e)
local = {part + ":" + "/".join(p): list(t.to_local().shape)
         for part in ("master", "m", "v") for p, t in iter_leaves(state["opt"][part])}
full = {"/".join(p): gather(t).numpy() for p, t in iter_leaves(state["opt"]["master"])}
params = {"/".join(p): gather(t).float().numpy() for p, t in iter_leaves(state["params"])}
if dist.get_rank() == 0:
    np.savez(os.path.join(os.environ["RSP_OUT"], "master.npz"), **full)
    np.savez(os.path.join(os.environ["RSP_OUT"], "params.npz"), **params)
print("RESULT " + json.dumps({"hist": hist, "local": local, "coord": mesh.get_coordinate(),
                              "seen": seen[0], "first": first, "refused": refused,
                              "step": int(gather(state["opt"]["step"]))}), flush=True)
dist.destroy_process_group()
print("TRAIN_OK", flush=True)
""" % {"GLOO_INIT": gloo_init(), "LR": LR, "STEPS": STEPS, "BATCH": BATCH, "SEQ": SEQ}


@pytest.fixture(scope="module")
def single_process_run():
    """The step without rules, one intra-op thread (as the children run):
    (history, initial master, final master)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = smoke_config("llama3.2-1b")
        state = init_state(cfg, 0, device="cpu")
        before = {"/".join(p): t.clone().numpy() for p, t in iter_leaves(state["opt"]["master"])}
        step = make_train_step(cfg, AdamWConfig(lr=LR), TrainConfig(total_steps=STEPS,
                                                                     warmup_steps=1))
        rng = np.random.default_rng(5)
        hist = []
        for _ in range(STEPS):
            toks = rng.integers(0, cfg.vocab_size, (BATCH, SEQ), dtype=np.int32)
            state, m = step(state, {"tokens": torch.from_numpy(toks)})
            hist.append({k: float(v) for k, v in m.items()})
        after = {"/".join(p): t.numpy() for p, t in iter_leaves(state["opt"]["master"])}
        return hist, before, after
    finally:
        torch.set_num_threads(threads)


def _ref_zero_shapes(shape) -> dict:
    from repro.configs import smoke_config as ref_smoke_config

    rcfg = ref_smoke_config("llama3.2-1b")
    ref_mesh = _ref_mesh(shape, ("data", "model"))
    ref_rules = ref_sharding.default_rules(ref_mesh, cfg=rcfg)
    out = {}
    for path, s in _ref_specs(ref_api.model_specs(rcfg)).items():
        local = list(RefNamedSharding(ref_mesh, ref_sharding.zero_shard_spec(s, ref_rules))
                     .shard_shape(s.shape))
        for part in ("master", "m", "v"):
            out[part + ":" + "/".join(path)] = local
    return out


@pytest.mark.parametrize("shape", [(1, 2), (1, 4), (2, 1), (4, 1), (2, 2)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_training_under_rules_matches_the_single_process_step(shape, tmp_path,
                                                             single_process_run):
    server = serve_store()
    children = run_children(TRAIN_CHILD, shape[0] * shape[1],
                            env={"RSP_STORE": f"127.0.0.1:{server.port}", "MESH": json.dumps(shape),
                                 "RSP_OUT": str(tmp_path)})
    assert_ok(children, "TRAIN_OK")
    hist, before, after = single_process_run
    results = [marked(c, "RESULT ") for c in children]
    want_local = _ref_zero_shapes(shape)
    rows = BATCH // shape[0]
    for r in results:
        assert r["local"] == want_local
        assert r["step"] == STEPS
        # each data rank's loss saw its own rows of the global batch
        d = r["coord"][0]
        assert r["seen"] == r["first"][d * rows:(d + 1) * rows]
        assert r["hist"] == results[0]["hist"]          # every rank reports the same step
        if shape[0] > 1:
            assert "does not divide" in r["refused"], r["refused"]
    got = results[0]["hist"]
    master = dict(np.load(tmp_path / "master.npz"))
    params = dict(np.load(tmp_path / "params.npz"))
    assert master.keys() == after.keys()
    for key, leaf in params.items():             # the parameters are the master in bf16
        assert np.array_equal(leaf, torch.from_numpy(master[key]).bfloat16().float().numpy())
    # model ranks compute their own heads, ff columns and vocab rows, whose
    # row-parallel sums add in another order than one card's products; data
    # ranks sum their shards' bf16 gradients in float32: the same tolerances
    for g, w in zip(got, hist):
        assert abs(g["loss"] - w["loss"]) < LOSS_TOL
        assert g["grad_norm"] == pytest.approx(w["grad_norm"], rel=GRAD_NORM_REL)
        assert g["lr"] == w["lr"]
    for key, leaf in master.items():
        upd, ref = leaf - before[key], after[key] - before[key]
        assert np.linalg.norm(upd - ref) / np.linalg.norm(ref) < UPDATE_REL_L2, key


def test_rules_need_named_mesh_axes():
    rules = ShardingRules(AbstractMesh((2,), ("data",)), {"batch": "data"})
    assert rules.spec_for(("batch", None)) == P("data", None)
    with pytest.raises(ValueError, match="no axis"):
        rules.placements(P("model"))
