"""The port's dense LM against the reference's, on the CPU at smoke size.

Weights are the reference's (``init_params`` from a JAX key), carried as
numpy arrays by the port's tree loader (``DenseLM(cfg, params=tree)``) or
through a checkpoint directory written by ``repro.checkpoint.store.save``
and read by the port's ``restore``.  The reference runs both with its
Pallas flash kernel (interpret mode) and with its default jnp path.

Tolerance: 2e-2 absolute and relative on bf16 activations and logits of
magnitude below 1.  Both sides compute every linear in bf16 and carry the
residual stream in bf16, but round at different places (XLA fuses
elementwise ops; PyTorch rounds each), so values differ by one or two bf16
ulps (2^-8 = 0.0039 between 0.5 and 1).  Greedy tokens must match exactly
(``test_torch_serve.py``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as ref_store
from repro.configs import smoke_config as ref_smoke_config
from repro.models import api as ref_api
from repro.models import attention as ref_attn
from repro.models import transformer as ref_tr
from repro.models.common import init_params as ref_init_params
from repro_torch.checkpoint import store
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import api, attention, transformer
from repro_torch.models.transformer import DenseLM, forward_lm

TOL = 2e-2
SMOKE_ARCHS = ["llama3.2-1b", "qwen2-0.5b", "qwen3-14b", "granite-20b"]


@pytest.fixture(scope="module", params=SMOKE_ARCHS)
def built(request):
    arch = request.param
    rcfg = ref_smoke_config(arch)
    params = ref_init_params(ref_api.model_specs(rcfg), jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    model = DenseLM(smoke_config(arch), params=tree, device="cpu")
    return rcfg, params, tree, model


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.to(torch.float32).numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _tokens(cfg, seed, shape=(2, 12)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape, np.int32)


def test_smoke_configs_match_the_reference():
    for arch in ARCHS:
        ours, ref = smoke_config(arch), ref_smoke_config(arch)
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(ref, f.name), (arch, f.name)
    assert set(ARCHS) == {"llama3.2-1b", "qwen2-0.5b", "qwen3-14b", "granite-20b",
                          "chameleon-34b", "zamba2-7b", "rwkv6-1.6b",
                          "granite-moe-3b-a800m", "qwen3-moe-30b-a3b", "hubert-xlarge"}


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
def test_attention_apply_prefill_then_decode(built, use_pallas):
    rcfg, params, tree, model = built
    acfg = rcfg.attention_config()
    lp = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    x = np.random.default_rng(2).normal(size=(2, 9, rcfg.d_model)).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    pacfg = smoke_config(rcfg.name).attention_config()
    layer = model.layers[0].attn

    ref_apply = jax.jit(functools.partial(ref_attn.attention_apply, cfg=acfg,
                                          use_pallas=use_pallas))

    # prefill of 8 positions into a float32 cache of 10, then one decode step
    rc = ref_attn.init_cache(acfg, 2, 10, jnp.float32)
    pc = attention.init_cache(pacfg, 2, 10, torch.float32, device="cpu")
    want, rc = ref_apply(lp, xj[:, :8], cache=rc)
    got, pc = attention.attention_apply(layer, xt[:, :8], pacfg, cache=pc)
    assert got.dtype == torch.bfloat16 and pc["length"] == int(rc["length"]) == 8
    _close(got, want)
    _close(pc["k"], rc["k"])
    _close(pc["v"], rc["v"])
    want, rc = ref_apply(lp, xj[:, 8:9], cache=rc)
    got, pc = attention.attention_apply(layer, xt[:, 8:9], pacfg, cache=pc)
    assert pc["length"] == 9
    _close(got, want)
    _close(pc["k"], rc["k"])

    # without a cache: the whole sequence through the flash path
    want, _ = ref_apply(lp, xj)
    got, none = attention.attention_apply(layer, xt, pacfg)
    assert none is None
    _close(got, want)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
def test_forward_lm_logits(built, use_pallas):
    rcfg, params, _, model = built
    toks = _tokens(rcfg, 1)
    fwd = jax.jit(ref_api.make_forward_fn(dataclasses.replace(rcfg, use_pallas=use_pallas)))
    want = fwd(params, {"tokens": jnp.asarray(toks)})
    got, caches, aux = forward_lm(model, torch.from_numpy(toks).long())
    assert caches is None and float(aux) == 0.0
    assert got.shape == (2, 12, rcfg.vocab_size) and got.dtype == torch.bfloat16
    _close(got, want)


def test_prefill_then_decode_matches(built):
    rcfg, params, _, model = built
    toks = _tokens(rcfg, 5, (2, 8))
    rc = ref_tr.init_caches(rcfg, 2, 16, dtype=jnp.float32)
    logits, rc = jax.jit(ref_api.make_prefill_fn(rcfg))(params, rc, {"tokens": jnp.asarray(toks[:, :7])})
    logits2, rc = jax.jit(ref_api.make_decode_fn(rcfg))(params, rc, {"tokens": jnp.asarray(toks[:, 7:8])})

    tt = torch.from_numpy(toks).long()
    pc = transformer.init_caches(model.cfg, 2, 16, dtype=torch.float32, device="cpu")
    got, pc = api.make_prefill_fn(model)(pc, {"tokens": tt[:, :7]})
    assert got.shape == (2, 1, rcfg.vocab_size)
    _close(got, logits)
    got2, pc = api.make_decode_fn(model)(pc, {"tokens": tt[:, 7:8]})
    _close(got2, logits2)
    assert pc["pos"] == int(rc["pos"]) == 8 and pc["layers"]["length"] == 8
    _close(pc["layers"]["k"], rc["layers"]["k"])
    _close(pc["layers"]["v"], rc["layers"]["v"])


def test_tree_loader_checks_every_leaf(built):
    rcfg, _, tree, model = built
    cfg = smoke_config(rcfg.name)
    want = np.array(tree["layers"]["attn"]["q"]["w"][1])
    assert torch.equal(model.layers[1].attn["q"]["w"], torch.from_numpy(want))
    assert all(p.dtype == torch.float32 and not p.requires_grad for p in model.parameters())
    bad = jax.tree.map(lambda a: a, tree)
    del bad["final_norm"]
    with pytest.raises(KeyError, match="final_norm"):
        DenseLM(cfg, params=bad, device="cpu")
    bad = dict(tree, extra={"w": np.zeros(3, np.float32)})
    with pytest.raises(KeyError, match="extra"):
        DenseLM(cfg, params=bad, device="cpu")
    bad = dict(tree, final_norm={"scale": np.ones(7, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        DenseLM(cfg, params=bad, device="cpu")


def test_restore_reads_a_reference_checkpoint(built, tmp_path):
    """A checkpoint written by the reference's ``save``, with one bf16 leaf,
    restores into the port's model and serves the reference's logits."""
    rcfg, params, _, _ = built
    params = jax.tree.map(lambda a: a, params)
    params["layers"]["attn"]["o"]["w"] = params["layers"]["attn"]["o"]["w"].astype(jnp.bfloat16)
    ref_store.save(str(tmp_path), 3, {"params": params}, extra={"arch": rcfg.name})
    assert store.all_steps(str(tmp_path)) == [3] and store.latest_step(str(tmp_path)) == 3
    state, extra = store.restore(str(tmp_path), device="cpu")
    assert extra == {"arch": rcfg.name}
    o = state["params"]["layers"]["attn"]["o"]["w"]
    assert o.dtype == torch.bfloat16
    np.testing.assert_array_equal(o.view(torch.int16).numpy(),
                                  np.asarray(params["layers"]["attn"]["o"]["w"]).view(np.int16))
    q = state["params"]["layers"]["attn"]["q"]["w"]
    assert q.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(params["layers"]["attn"]["q"]["w"]))

    model = DenseLM(smoke_config(rcfg.name), params=state["params"], device="cpu")
    toks = _tokens(rcfg, 6)
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32), params)
    rstate, _ = ref_store.restore(str(tmp_path), 3, {"params": like})
    want = jax.jit(ref_api.make_forward_fn(rcfg))(rstate["params"], {"tokens": jnp.asarray(toks)})
    got, _, _ = forward_lm(model, torch.from_numpy(toks).long())
    _close(got, want)


def test_checkpoint_keys_parse():
    assert store.parse_key("['params']['layers']['attn']['q']['w']") == (
        "params", "layers", "attn", "q", "w")
    for bad in ("params.layers", "['opt'][0]", "['a']x"):
        with pytest.raises(ValueError):
            store.parse_key(bad)


@pytest.mark.parametrize("family", ["moe", "hybrid", "rwkv", "encoder"])
def test_other_families_name_their_roadmap_item(family):
    cfg = dataclasses.replace(smoke_config("llama3.2-1b"), family=family)
    # every family is ported: DenseLM points at the family's own class
    with pytest.raises(ValueError, match={"moe": "MoELM", "hybrid": "HybridLM", "rwkv": "RWKVLM",
                                          "encoder": "EncoderModel"}[family]):
        DenseLM(cfg, device="cpu")


def test_full_width_specs_match_the_reference():
    """The five dense archs at their published widths: the same parameter
    tree, shapes and count as the reference (specs only, nothing allocated)."""
    from repro.configs import ARCHS as REF_ARCHS
    from repro.models.common import param_count as ref_param_count
    from repro_torch.models.common import iter_leaves, init_scale

    for arch, cfg in ARCHS.items():
        ref = ref_api.model_specs(REF_ARCHS[arch])
        flat = jax.tree_util.tree_flatten_with_path(ref, is_leaf=lambda x: hasattr(x, "axes"))[0]
        want = {tuple(k.key for k in path): leaf for path, leaf in flat}
        ours = dict(iter_leaves(api.model_specs(cfg)))
        assert set(ours) == set(want), arch
        for path, spec in ours.items():
            r = want[path]
            assert (spec.shape, spec.init, spec.scale) == (r.shape, r.init, r.scale), (arch, path)
        count = sum(int(np.prod(s.shape)) for s in ours.values())
        assert count == ref_param_count(ref)
        if arch == "llama3.2-1b":
            assert count == 1_235_814_400
            # a stacked leaf's fan-in counts the layer axis, as the reference's does
            assert init_scale(ours[("layers", "attn", "q", "w")]) == 1 / np.sqrt(16 * 2048)


def test_layernorm_matches_the_reference():
    from repro.models.common import layernorm as ref_layernorm
    from repro_torch.models.common import layernorm

    rng = np.random.default_rng(8)
    x = rng.normal(2.0, 3.0, size=(3, 5, 32)).astype(np.float32)
    p = {"scale": rng.normal(size=32).astype(np.float32), "bias": rng.normal(size=32).astype(np.float32)}
    want = ref_layernorm(p, jnp.asarray(x).astype(jnp.bfloat16))
    got = layernorm({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x).bfloat16())
    assert got.dtype == torch.bfloat16
    _close(got, want)
