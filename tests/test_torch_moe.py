"""The port's Mixture-of-Experts layer and MoE decoders against the
reference's, on the CPU at smoke size.

``moe_apply`` is held to the reference's in both dispatch modes (the
one-hot running count and ``sort_dispatch``), with dropping (capacity
factor 1.25, which drops assignments on these inputs) and dropless, in one
and in two token groups:

* the float32 router logits within 1e-6 and the chosen experts exactly
  (a near-tie flipped by one ulp would swap two experts; none occurs on
  these seeded inputs);
* the capacity positions exactly;
* the outputs bit for bit.  Both sides multiply the same bf16 operands
  (small enough here that the float32 accumulation order of a product
  does not show), and the combine adds each token's k outputs into a bf16
  zero row in assignment order, as the reference's scatter-add does on
  the host: a combine in another order would move an output by a bf16
  ulp and fail;
* the Switch aux loss within 1e-6 relative.

End to end the router reads activations that already differ by a bf16
ulp or two (attention's roundings, see ``test_torch_models.py``), so the
models' aux is held to 1e-3 relative (``AUX_RTOL``) and the logits to
``TOL``.

Both smoke configs then run end to end with the reference's weights
carried across by ``params_to_tensors``: the forward's logits, ``lm_loss``
(ce + the aux summed over the layers), and a prefill plus decode step
against the reference's ``decode_step``; greedy serving gives the
reference's tokens.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.models import api as ref_api
from repro.models import moe as ref_moe
from repro.models import transformer as ref_tr
from repro.models.common import init_params as ref_init_params
from repro.serve.engine import Server as RefServer
from repro_torch import kernels
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.models import api, moe, transformer
from repro_torch.models.transformer import DenseLM, MoELM, build_lm, forward_lm
from repro_torch.serve import Server

TOL = 2e-2
AUX_RTOL = 1e-3
MOE_ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b"]
D, F, E, K = 32, 16, 8, 2


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.to(torch.float32).numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def _layer_params(seed=0, d=D, f=F, e=E):
    rng = np.random.default_rng(seed)
    return {
        "router": {"w": (rng.normal(size=(d, e)) / np.sqrt(d)).astype(np.float32)},
        "gate": (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32),
        "up": (rng.normal(size=(e, d, f)) / np.sqrt(d)).astype(np.float32),
        "down": (rng.normal(size=(e, f, d)) / np.sqrt(f)).astype(np.float32),
    }


def _torch_params(p):
    return {"router": {"w": torch.from_numpy(p["router"]["w"])},
            **{n: torch.from_numpy(p[n]) for n in ("gate", "up", "down")}}


def _inputs(seed=1, shape=(2, 24, D)):
    """bf16 activations, the same values on both sides."""
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(torch.bfloat16)


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dropless", [False, True], ids=["capacity", "dropless"])
@pytest.mark.parametrize("sort_dispatch", [False, True], ids=["onehot", "sorted"])
def test_moe_apply_matches_the_reference(sort_dispatch, dropless, groups):
    p = _layer_params()
    xj, xt = _inputs()
    rcfg = ref_moe.MoEConfig(D, F, E, K, sort_dispatch=sort_dispatch)
    cfg = moe.MoEConfig(D, F, E, K, sort_dispatch=sort_dispatch)
    want, want_aux = ref_moe.moe_apply(jax.tree.map(jnp.asarray, p), xj, rcfg,
                                       moe_groups=groups, dropless=dropless)
    got, aux = moe.moe_apply(_torch_params(p), xt, cfg, moe_groups=groups, dropless=dropless)
    assert got.dtype == torch.bfloat16 and got.shape == xt.shape
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)

    # the router: logits to 1e-6, the chosen experts exactly
    T = xt.shape[0] * xt.shape[1]
    xg = xj.reshape(groups, T // groups, D).astype(jnp.float32)
    ref_logits = jnp.einsum("gtd,de->gte", xg, jnp.asarray(p["router"]["w"]))
    ref_idx = jax.lax.top_k(jax.nn.softmax(ref_logits, axis=-1), K)[1]
    logits, _, _, idx = moe.route(_torch_params(p), xt.reshape(groups, -1, D), cfg)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("dropless", [False, True], ids=["capacity", "dropless"])
def test_the_dispatch_gradient_is_index_selects(monkeypatch, dropless, groups):
    """The dispatch's backward (each token's kept slots gathered and added
    in assignment order) gives the gradient of a plain ``index_select``,
    dropped assignments included, in float32 to summation order."""
    p = _torch_params(_layer_params())
    for leaf in (p["router"]["w"], p["gate"], p["up"], p["down"]):
        leaf.requires_grad_()
    _, xt = _inputs()
    x = xt.to(torch.float32)
    dy = torch.from_numpy(np.random.default_rng(3).normal(size=x.shape).astype(np.float32))
    cfg = moe.MoEConfig(D, F, E, K)

    def grads():
        xg = x.clone().requires_grad_()
        out, aux = moe.moe_apply(p, xg, cfg, moe_groups=groups, dropless=dropless,
                                 compute_dtype=torch.float32)
        (out * dy).sum().add(aux).backward()
        got = [xg.grad] + [t.grad.clone() for t in (p["router"]["w"], p["gate"], p["up"],
                                                     p["down"])]
        for t in (p["router"]["w"], p["gate"], p["up"], p["down"]):
            t.grad = None
        return got

    got = grads()
    monkeypatch.setattr(moe._DispatchGather, "apply",
                        lambda x_pad, rows, slot, keep: x_pad.index_select(0, rows))
    want = grads()
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_capacity_drops_assignments_on_these_inputs():
    """At capacity factor 1.25 some assignments overflow, so the capacity
    case above tests dropping; dropless keeps all of them."""
    p = _layer_params()
    _, xt = _inputs()
    cfg = moe.MoEConfig(D, F, E, K)
    _, _, _, idx = moe.route(_torch_params(p), xt.reshape(1, -1, D), cfg)
    pos = moe._cumsum_positions(idx.reshape(1, -1), E)
    C = moe.moe_capacity(idx.shape[1], cfg)
    assert C == int(np.ceil(48 * K / E * 1.25)) == 15
    assert int((pos >= C).sum()) > 0
    dropped, _ = moe.moe_apply(_torch_params(p), xt, cfg)
    kept, _ = moe.moe_apply(_torch_params(p), xt, cfg, dropless=True)
    assert not torch.equal(dropped, kept)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_capacity_positions_match_the_reference(seed):
    flat = np.random.default_rng(seed).integers(0, E, size=(3, 40)).astype(np.int32)
    want = np.asarray(ref_moe._sorted_positions(jnp.asarray(flat), E))
    t = torch.from_numpy(flat).long()
    np.testing.assert_array_equal(moe._sorted_positions(t, E).numpy(), want)
    np.testing.assert_array_equal(moe._cumsum_positions(t, E).numpy(), want)


def test_moe_ref_matches_the_reference_and_the_dropless_layer():
    p = _layer_params(seed=3)
    x = np.random.default_rng(4).normal(size=(2, 10, D)).astype(np.float32)
    cfg = moe.MoEConfig(D, F, E, K)
    want = np.asarray(ref_moe.moe_ref(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                                      ref_moe.MoEConfig(D, F, E, K)))
    got = moe.moe_ref(_torch_params(p), torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # the dropless bf16 layer computes the same function, to bf16 rounding
    xb = torch.from_numpy(x).to(torch.bfloat16)
    out, _ = moe.moe_apply(_torch_params(p), xb, cfg, dropless=True)
    oracle = moe.moe_ref(_torch_params(p), xb.float(), cfg)
    _close(out, oracle.numpy(), tol=5e-2)


def test_moe_specs_match_the_reference():
    ours = moe.moe_specs(moe.MoEConfig(1536, 512, 40, 8))
    ref = ref_moe.moe_specs(ref_moe.MoEConfig(1536, 512, 40, 8))
    for name in ("gate", "up", "down"):
        assert (ours[name].shape, ours[name].init, ours[name].scale) == (
            ref[name].shape, ref[name].init, ref[name].scale)
    assert ours["router"]["w"].shape == ref["router"]["w"].shape == (1536, 40)


# ---------------------------------------------------------------------------
# the MoE decoders end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=MOE_ARCHS)
def built(request):
    arch = request.param
    rcfg = ref_smoke_config(arch)
    params = ref_init_params(ref_api.model_specs(rcfg), jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    model = build_lm(smoke_config(arch), tree, device="cpu")
    return rcfg, params, tree, model


def _tokens(cfg, seed, shape=(2, 12)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape, np.int32)


def test_moe_configs_and_smoke_shrink_match_the_reference():
    from repro.configs import ARCHS as REF_ARCHS

    for arch in MOE_ARCHS:
        for ours, ref in ((ARCHS[arch], REF_ARCHS[arch]),
                          (smoke_config(arch), ref_smoke_config(arch))):
            for f in dataclasses.fields(ours):
                assert getattr(ours, f.name) == getattr(ref, f.name), (arch, f.name)
            assert ours.moe_config() == moe.MoEConfig(**dataclasses.asdict(ref.moe_config()))
    s = smoke_config("granite-moe-3b-a800m")
    assert (s.num_experts, s.num_experts_per_token, s.d_ff, s.moe_capacity_factor) == (8, 2, 32, 8.0)


def test_the_tree_carries_the_moe_leaves(built):
    rcfg, _, tree, model = built
    assert isinstance(model, MoELM)
    layer = model.layers[1].moe
    np.testing.assert_array_equal(layer["router"]["w"].numpy(), tree["layers"]["moe"]["router"]["w"][1])
    np.testing.assert_array_equal(layer["down"].numpy(), tree["layers"]["moe"]["down"][1])
    assert tuple(layer["gate"].shape) == (rcfg.num_experts, rcfg.d_model, rcfg.d_ff)
    with pytest.raises(ValueError, match="MoELM"):
        DenseLM(smoke_config(rcfg.name), params=tree, device="cpu")


def test_forward_lm_logits_and_aux(built):
    rcfg, params, _, model = built
    toks = _tokens(rcfg, 1)
    want, _, want_aux = jax.jit(lambda p, t: ref_tr.forward_lm(rcfg, p, t))(params, jnp.asarray(toks))
    got, caches, aux = forward_lm(model, torch.from_numpy(toks).long())
    assert caches is None and got.dtype == torch.bfloat16
    _close(got, want)
    assert float(aux) > 0
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=AUX_RTOL)


def test_lm_loss_is_ce_plus_aux(built):
    rcfg, params, _, model = built
    toks = _tokens(rcfg, 2, (2, 13))
    want, wparts = jax.jit(ref_api.make_loss_fn(rcfg))(params, {"tokens": jnp.asarray(toks)})
    got, parts = api.make_loss_fn(model)({"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(float(parts["aux"]), float(wparts["aux"]), rtol=AUX_RTOL)
    np.testing.assert_allclose(float(parts["ce"]), float(wparts["ce"]), rtol=1e-3)
    np.testing.assert_allclose(float(got), float(parts["ce"]) + float(parts["aux"]), rtol=1e-6)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-3)


def test_prefill_then_decode_matches(built):
    rcfg, params, _, model = built
    toks = _tokens(rcfg, 5, (2, 8))
    rc = ref_tr.init_caches(rcfg, 2, 16, dtype=jnp.float32)
    logits, rc = jax.jit(ref_api.make_prefill_fn(rcfg))(params, rc, {"tokens": jnp.asarray(toks[:, :7])})
    logits2, rc = jax.jit(lambda p, c, t: ref_tr.decode_step(rcfg, p, c, t))(
        params, rc, jnp.asarray(toks[:, 7:8]))
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


def test_greedy_generate_gives_the_reference_tokens(built):
    rcfg, params, _, model = built
    prompts = np.random.default_rng(9).integers(0, rcfg.vocab_size, (3, 8), np.int32)
    want = RefServer(rcfg, params).generate(jnp.asarray(prompts), max_new_tokens=10)
    kernels.reset_launch_counts()
    got = Server(model.cfg, model, device="cpu").generate(prompts, max_new_tokens=10)
    assert kernels.launch_counts()["flash_attention"] == 0
    np.testing.assert_array_equal(got, np.asarray(want))


def test_serve_launcher_takes_the_moe_archs(capsys):
    from repro_torch.launch import serve

    for arch in MOE_ARCHS:
        serve.main(["--arch", arch, "--device", "cpu", "--batch", "2", "--prompt-len", "4",
                    "--new-tokens", "3"])
    out = capsys.readouterr().out
    assert all(f"single {arch} on cpu" in out for arch in MOE_ARCHS)


@pytest.mark.parametrize("entry", ["MoELM", "build_lm", "init_caches", "launch.serve"])
def test_moe_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CPU-only behaviour does not apply")
    cfg = smoke_config("granite-moe-3b-a800m")
    calls = {
        "MoELM": lambda: MoELM(cfg),
        "build_lm": lambda: build_lm(cfg),
        "init_caches": lambda: transformer.init_caches(cfg, 1, 8),
        "launch.serve": lambda: __import__("repro_torch.launch.serve", fromlist=["main"]).main(
            ["--arch", "granite-moe-3b-a800m"]),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_forward_lm_goes_through_the_module_call(built):
    """``forward_lm`` (and so the loss) calls the model as a module: a
    forward hook sees every position's logits first in its output."""
    rcfg, _, _, model = built
    seen = []
    handle = model.register_forward_hook(lambda m, args, out: seen.append(out[0]))
    try:
        logits, _, aux = forward_lm(model, torch.from_numpy(_tokens(rcfg, 3)).long())
        api.make_loss_fn(model)({"tokens": torch.from_numpy(_tokens(rcfg, 4, (2, 9))).long()})
    finally:
        handle.remove()
    assert len(seen) == 2 and seen[0] is logits and seen[1].shape == (2, 8, rcfg.vocab_size)
