"""The port's zamba2 hybrid against the reference's, on the CPU at smoke size
(5 layers, a shared block every 2: two full rounds and an epilogue).

Weights are the reference's (``init_params`` from a JAX key), carried as
numpy arrays by the port's tree loader (``HybridLM(cfg, params=tree)``) or
through a checkpoint written by ``repro.checkpoint.store.save``.  The
reference runs with its Pallas kernels in interpret mode (flash attention
and the SSD scan) and with its default jnp path.

Tolerance: 2e-2 absolute and relative on bf16 logits and caches of
magnitude below 1, as in ``test_torch_models.py``; greedy tokens must match
exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as ref_store
from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_config as ref_smoke_config
from repro.models import api as ref_api
from repro.models import transformer as ref_tr
from repro.models.common import init_params as ref_init_params
from repro.models.common import param_count as ref_param_count
from repro.serve.engine import EnsembleServer as RefEnsembleServer
from repro.serve.engine import Server as RefServer
from repro_torch import kernels
from repro_torch.checkpoint import store
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import api, transformer
from repro_torch.models.common import iter_leaves
from repro_torch.models.transformer import DenseLM, HybridLM, build_lm, forward_lm
from repro_torch.serve import EnsembleServer, Server

TOL = 2e-2
ARCH = "zamba2-7b"
PATHS = {"jnp": False, "pallas": True}


def _ref_cfg(use_pallas=False):
    return dataclasses.replace(ref_smoke_config(ARCH), use_pallas=use_pallas)


@functools.lru_cache(maxsize=None)
def _params(seed):
    return ref_init_params(ref_api.model_specs(_ref_cfg()), jax.random.PRNGKey(seed))


def _model(seed=0):
    return HybridLM(smoke_config(ARCH), params=jax.tree.map(np.asarray, _params(seed)),
                    device="cpu")


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.to(torch.float32).numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _tokens(seed, shape=(2, 12)):
    return np.random.default_rng(seed).integers(0, 256, shape, np.int32)


def test_the_smoke_config_exercises_the_epilogue():
    cfg = smoke_config(ARCH)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(ref_smoke_config(ARCH), f.name), f.name
    assert transformer.hybrid_layout(cfg) == (2, 2, 1)
    assert transformer.hybrid_layout(ARCHS[ARCH]) == (13, 6, 3)
    model = _model()
    assert len(model.layers) == 5 and model.period == 2
    tree = _params(0)
    np.testing.assert_array_equal(model.layers[3].mamba["x"]["w"].numpy(),
                                  np.asarray(tree["rounds"]["mamba"]["x"]["w"][1, 1]))
    np.testing.assert_array_equal(model.layers[4].mamba["A_log"].numpy(),
                                  np.asarray(tree["epilogue"]["mamba"]["A_log"][0]))


def test_full_width_specs_and_count_match_the_reference():
    cfg = ARCHS[ARCH]
    ref = ref_api.model_specs(REF_ARCHS[ARCH])
    flat = jax.tree_util.tree_flatten_with_path(ref, is_leaf=lambda x: hasattr(x, "axes"))[0]
    want = {tuple(k.key for k in path): (s.shape, s.init, s.scale) for path, s in flat}
    got = {path: (s.shape, s.init, s.scale) for path, s in iter_leaves(api.model_specs(cfg))}
    assert got == want
    count = sum(int(np.prod(s[0])) for s in got.values())
    assert count == ref_param_count(ref) == 6_776_229_968
    assert got[("rounds", "mamba", "out", "w")][0] == (13, 6, 7168, 3584)
    assert got[("epilogue", "mamba", "out", "w")][0] == (3, 7168, 3584)
    assert cfg.resolved_head_dim == 112


@pytest.mark.parametrize("path", sorted(PATHS))
def test_forward_lm_logits(path):
    rcfg = _ref_cfg(PATHS[path])
    toks = _tokens(1)
    want = jax.jit(ref_api.make_forward_fn(rcfg))(_params(0), {"tokens": jnp.asarray(toks)})
    got, caches, aux = forward_lm(_model(), torch.from_numpy(toks).long())
    assert caches is None and float(aux) == 0.0
    assert got.shape == (2, 12, 256) and got.dtype == torch.bfloat16
    _close(got, want)


def test_prefill_then_decode_matches_the_reference():
    rcfg = _ref_cfg()
    params = _params(0)
    toks = _tokens(5, (2, 10))
    rc = ref_tr.init_caches(rcfg, 2, 16, dtype=jnp.float32)
    prefill = jax.jit(ref_api.make_prefill_fn(rcfg))
    logits, rc = prefill(params, rc, {"tokens": jnp.asarray(toks[:, :9])})
    logits2, rc = jax.jit(ref_api.make_decode_fn(rcfg))(params, rc,
                                                         {"tokens": jnp.asarray(toks[:, 9:])})

    model = _model()
    tt = torch.from_numpy(toks).long()
    pc = transformer.init_caches(model.cfg, 2, 16, dtype=torch.float32, device="cpu")
    assert pc["layers"]["attn"]["k"].shape == (3, 2, 4, 16, 16)
    assert pc["layers"]["mamba"]["conv"].shape == (5, 2, 3, 160)
    assert pc["layers"]["mamba"]["ssm"].shape == (5, 2, 8, 16, 16)
    ssm = pc["layers"]["mamba"]["ssm"]
    got, pc = api.make_prefill_fn(model)(pc, {"tokens": tt[:, :9]})
    _close(got, logits)
    got2, pc = api.make_decode_fn(model)(pc, {"tokens": tt[:, 9:]})
    _close(got2, logits2)
    assert pc["layers"]["mamba"]["ssm"] is ssm          # updated in place
    assert pc["pos"] == int(rc["pos"]) == 10 and pc["layers"]["attn"]["length"] == 10
    ref_layers = rc["layers"]
    _close(pc["layers"]["attn"]["k"], ref_layers["attn"]["k"])
    _close(pc["layers"]["attn"]["v"], ref_layers["attn"]["v"])
    _close(pc["layers"]["mamba"]["conv"], ref_layers["mamba"]["conv"])
    _close(pc["layers"]["mamba"]["ssm"], ref_layers["mamba"]["ssm"])


def test_decode_from_the_caches_equals_a_full_forward():
    model = _model(1)
    tt = torch.from_numpy(_tokens(7, (3, 14))).long()
    full, _ = model(tt)
    pc = transformer.init_caches(model.cfg, 3, 14, dtype=torch.float32, device="cpu")
    step, pc = api.make_prefill_fn(model)(pc, {"tokens": tt[:, :9]})
    steps = [step]
    for t in range(9, 13):
        step, pc = api.make_decode_fn(model)(pc, {"tokens": tt[:, t:t + 1]})
        steps.append(step)
    _close(torch.cat(steps, dim=1), full[:, 8:13].float().numpy())


@pytest.mark.parametrize("path", sorted(PATHS))
def test_greedy_generate_gives_the_reference_tokens(path):
    rcfg = _ref_cfg(PATHS[path])
    prompts = _tokens(9, (3, 8))
    want = RefServer(rcfg, _params(0)).generate(jnp.asarray(prompts), max_new_tokens=10)
    server = Server(smoke_config(ARCH), _model(), device="cpu")
    kernels.reset_launch_counts()
    got, logits = server.generate(prompts, max_new_tokens=10, return_logits=True)
    assert kernels.launch_counts() == dict.fromkeys(kernels.launch_counts(), 0)
    assert got.shape == (3, 18) and got.dtype == np.int32
    np.testing.assert_array_equal(got, np.asarray(want))
    assert torch.equal(logits.argmax(-1), torch.from_numpy(got[:, 8:]).long())


def test_ensemble_generate_gives_the_reference_tokens():
    rcfg = _ref_cfg()
    prompts = _tokens(4, (3, 8))
    stacked = jax.tree.map(lambda a, b: jnp.stack([a, b]), _params(0), _params(1))
    want = RefEnsembleServer(rcfg, stacked).generate(jnp.asarray(prompts), max_new_tokens=8)
    ens = EnsembleServer(smoke_config(ARCH), [_model(0), _model(1)], device="cpu")
    np.testing.assert_array_equal(ens.generate(prompts, max_new_tokens=8), np.asarray(want))


def test_restore_reads_a_reference_hybrid_checkpoint(tmp_path):
    """The rounds leaves stacked twice and the epilogue's once come back in
    their shapes and serve the reference's logits."""
    params = _params(0)
    ref_store.save(str(tmp_path), 2, {"params": params}, extra={"arch": ARCH})
    state, extra = store.restore(str(tmp_path), device="cpu")
    assert extra == {"arch": ARCH}
    got_params = state["params"]
    assert tuple(got_params["rounds"]["mamba"]["conv"].shape) == (2, 2, 4, 160)
    assert tuple(got_params["epilogue"]["mamba"]["conv"].shape) == (1, 4, 160)
    np.testing.assert_array_equal(got_params["rounds"]["norm"]["scale"].numpy(),
                                  np.asarray(params["rounds"]["norm"]["scale"]))
    model = build_lm(smoke_config(ARCH), got_params, device="cpu")
    assert isinstance(model, HybridLM)
    toks = _tokens(6)
    want = jax.jit(ref_api.make_forward_fn(_ref_cfg()))(params, {"tokens": jnp.asarray(toks)})
    got, _, _ = forward_lm(model, torch.from_numpy(toks).long())
    _close(got, want)


def test_each_model_class_refuses_the_other_family():
    with pytest.raises(ValueError, match="HybridLM"):
        DenseLM(smoke_config(ARCH), device="cpu")
    with pytest.raises(ValueError, match="DenseLM"):
        HybridLM(smoke_config("llama3.2-1b"), device="cpu")
    assert isinstance(build_lm(smoke_config("llama3.2-1b"), device="cpu"), DenseLM)


def test_serve_launcher_runs_zamba2_on_the_host(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--device", "cpu", "--new-tokens", "3", "--batch", "2"])
    serve.main(["--arch", ARCH, "--device", "cpu", "--new-tokens", "2", "--batch", "2",
                "--ensemble", "2"])
    out = capsys.readouterr().out
    assert "single zamba2-7b on cpu" in out and "ensemble[2] zamba2-7b on cpu" in out
