"""The port's RWKV6 family against the reference's, on the CPU at smoke size
(2 layers, d_model 64, 4 heads of 16, lora rank 8).

Inputs are drawn with numpy from a seed and handed to both sides.  The
reference's WKV runs as its own tests run it: the Pallas kernel in
interpret mode (``wkv_ops.wkv6``) and the exact recurrence
(``wkv6_scan``); its model runs jitted, on its default path
(``use_pallas=False``, the scan) and on its Pallas path.  The port's side is
the plain chunked form (``wkv6(..., impl="torch")``, what the CUDA kernel
is held against on the card) and the step recurrence.  Weights are the
reference's (``init_params`` from a JAX key) with the two zero-initialised
low-rank factors (``lora_b``, ``w_lora_b``) drawn at 0.1, so that the
ddlerp and the data-dependent decay take part (at 0.3 some decays
underflow to 0, which the reference's Pallas path turns into NaN on the
host: see ``test_wkv6_matches_the_reference_kernel_and_scan``).

Tolerances: 2e-4 absolute and relative on the WKV, the reference's own
for its kernel (``tests/test_kernels.py``): float32 sums in another order.
The layers and the model: 2e-2 on bf16 values of magnitude below 1, as in
``test_torch_models.py``; the time and channel mixes must moreover agree
bit for bit on all but 1% of their bf16 outputs -- a rounding placed
elsewhere than the jitted reference's moves a bf16 ulp on most of them,
well inside 2e-2.  The loss: 1e-4 relative (a mean of float32 log-sum-exps
over logits that differ by a bf16 ulp on about 1% of positions).  Greedy
tokens must match exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_config as ref_smoke_config
from repro.kernels.rwkv6_wkv import ops as ref_wkv_ops
from repro.models import api as ref_api
from repro.models import rwkv6 as ref_rwkv6
from repro.models import transformer as ref_tr
from repro.models.common import init_params as ref_init_params
from repro.models.common import param_count as ref_param_count
from repro.serve.engine import EnsembleServer as RefEnsembleServer
from repro.serve.engine import Server as RefServer
from repro_torch import kernels
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.kernels.rwkv6_wkv import log_decay, wkv6, wkv6_chunked, wkv6_cuda, wkv6_scan
from repro_torch.models import api, rwkv6, transformer
from repro_torch.models.common import iter_leaves, token_nll
from repro_torch.models.transformer import RWKVLM, build_lm, forward_lm
from repro_torch.serve import EnsembleServer, Server

WKV_TOL = 2e-4
TOL = 2e-2
LOSS_RTOL = 1e-4
ARCH = "rwkv6-1.6b"
PATHS = {"jnp": False, "pallas": True}

# B, T, H, C, chunk: tests/test_kernels.py's sweep (the third pads T)
WKV_SHAPES = [(1, 32, 2, 8, 8), (2, 64, 1, 16, 16), (1, 20, 2, 8, 16), (1, 16, 4, 4, 4)]


def _wkv_inputs(seed, B, T, H, C, decay="sigmoid"):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, T, H, C)).astype(np.float32) for _ in range(3))
    if decay == "sigmoid":      # tests/test_kernels.py's draw
        w = 1 / (1 + np.exp(-rng.normal(size=(B, T, H, C))))
    elif decay == "strong":     # tests/test_kernels.py's w = 1e-6
        w = np.full((B, T, H, C), 1e-6)
    elif decay == "underflow":  # w = 1e-6, a quarter underflowed to 0 (log clamped)
        w = np.where(rng.random((B, T, H, C)) < 0.25, 0.0, 1e-6)
    else:                       # weak: the state carries across every chunk
        w = rng.uniform(0.999, 1.0, size=(B, T, H, C))
        k = k / np.sqrt(T)
    u = np.linspace(0.1, 0.9, H * C).reshape(H, C)
    return r, k, v, w.astype(np.float32), u.astype(np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.to(torch.float32)), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


CASES = [(shape, "sigmoid") for shape in WKV_SHAPES] + [
    ((1, 32, 1, 8, 8), "strong"),      # tests/test_kernels.py's w = 1e-6
    ((1, 32, 2, 8, 8), "underflow"),   # and a quarter of w = 0
    ((2, 96, 3, 8, 16), "weak"),       # w in [0.999, 1) over 6 chunks
]


@pytest.mark.parametrize("shape,decay", CASES, ids=lambda c: str(c))
def test_wkv6_matches_the_reference_kernel_and_scan(shape, decay):
    B, T, H, C, chunk = shape
    arrays = _wkv_inputs(T + H, B, T, H, C, decay)
    pallas = ref_wkv_ops.wkv6(*map(jnp.asarray, arrays), chunk=chunk)
    if decay == "underflow":
        assert bool(jnp.isnan(pallas[0]).any())
    oracle = ref_rwkv6.wkv6_scan(*map(jnp.asarray, arrays))
    r, k, v, w, u = map(torch.from_numpy, arrays)
    kernels.reset_launch_counts()
    y, h = wkv6_chunked(r, k, v, log_decay(w), u, chunk=chunk)
    y16, h16 = wkv6(r, k, v, w, u)                 # auto on the host: the plain form, Q = 16
    assert kernels.launch_counts()["rwkv6_wkv"] == 0
    assert y.shape == (B, T, H, C) and h.shape == (B, H, C, C) and y.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    # w = 0's clamp (1e-38) is a float32 subnormal, which XLA flushes to 0
    # on the host: the reference's Pallas path then takes log 0 = -inf and
    # gives NaN; its scan, like the port, runs at the clamped log
    for want_y, want_h in (pallas, oracle) if decay != "underflow" else (oracle,):
        for got_y, got_h in ((y, h), (y16, h16)):
            _close(got_y, want_y, WKV_TOL)
            _close(got_h, want_h, WKV_TOL)
    # the port's step recurrence is the reference's oracle
    y2, h2 = wkv6_scan(r, k, v, w, u)
    _close(y2, oracle[0], WKV_TOL)
    _close(h2, oracle[1], WKV_TOL)


def test_weak_decay_carries_the_state_across_chunks():
    """With w near 1 the inter-chunk term is most of y: dropping it (each
    chunk from a zero state) must be far outside the tolerance."""
    B, T, H, C = 1, 64, 2, 8
    r, k, v, w, u = map(torch.from_numpy, _wkv_inputs(5, B, T, H, C, "weak"))
    y, _ = wkv6(r, k, v, w, u)
    split = [a.reshape(B * T // 16, 16, H, C) for a in (r, k, v, w)]
    y_cut, _ = wkv6(*split, u)
    assert float((y - y_cut.reshape(y.shape)).abs().max()) > 100 * WKV_TOL


@pytest.mark.parametrize("T", [40, 7], ids=["T40", "T7"])
def test_wkv6_from_h0_and_a_split_sequence(T):
    B, H, C = 2, 3, 8
    r, k, v, w, u = _wkv_inputs(11, B, T, H, C)
    h0 = np.random.default_rng(12).normal(size=(B, H, C, C)).astype(np.float32)
    want_y, want_h = ref_rwkv6.wkv6_scan(*map(jnp.asarray, (r, k, v, w, u)), h0=jnp.asarray(h0))
    t = [torch.from_numpy(a) for a in (r, k, v, w)]
    uu, hh = torch.from_numpy(u), torch.from_numpy(h0)
    y, h = wkv6(*t, uu, h0=hh, impl="torch")
    _close(y, want_y, WKV_TOL)
    _close(h, want_h, WKV_TOL)
    # the first steps, then the rest from their final state
    cut = T // 2
    y1, h1 = wkv6(*(a[:, :cut] for a in t), uu, h0=hh)
    y2, h2 = wkv6(*(a[:, cut:] for a in t), uu, h0=h1)
    _close(torch.cat([y1, y2], dim=1), want_y, WKV_TOL)
    _close(h2, want_h, WKV_TOL)


def test_wkv_dispatch_and_the_kernels_checks():
    r, k, v, w, u = map(torch.from_numpy, _wkv_inputs(1, 1, 32, 2, 64))
    logw = log_decay(w)
    with pytest.raises(ValueError, match="unknown impl"):
        wkv6(r, k, v, w, u, impl="pallas")
    with pytest.raises(ValueError, match="CUDA tensor"):
        wkv6(r, k, v, w, u, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        wkv6_cuda(r, k, v, logw, u)
    with pytest.raises(ValueError, match="logw must be"):
        wkv6_cuda(r, k, v, logw[:, :16], u)
    with pytest.raises(ValueError, match="u must be"):
        wkv6_cuda(r, k, v, logw, u[:1])
    with pytest.raises(ValueError, match="h0 must be"):
        wkv6_cuda(r, k, v, logw, u, h0=torch.zeros(1, 2, 64, 32))
    meta = [a.to("meta") for a in (k, v, logw)]
    with pytest.raises(ValueError, match="but the block is on cpu"):
        wkv6_cuda(r, *meta, u)
    # the decay's log is the reference wrapper's: clamped at 1e-38 (-87.5)
    lw = log_decay(torch.tensor([0.0, 1e-40, 0.5, 1.0]))
    np.testing.assert_allclose(lw.numpy(), np.log(np.maximum(
        np.array([0.0, 1e-40, 0.5, 1.0], np.float32), np.float32(1e-38))), rtol=1e-6)


# ---------------------------------------------------------------------------
# The layers and the model
# ---------------------------------------------------------------------------

def _ref_cfg(use_pallas=False):
    return dataclasses.replace(ref_smoke_config(ARCH), use_pallas=use_pallas)


def _draw_lora(tree, seed):
    """The zero-initialised low-rank factors drawn at 0.1 (numpy), so that
    the ddlerp's and the decay's low-rank terms are not 0."""
    rng = np.random.default_rng(seed)
    for name in ("lora_b", "w_lora_b"):
        leaf = tree[name]
        tree[name] = (0.1 * rng.normal(size=leaf.shape)).astype(np.float32)
    return tree


@functools.lru_cache(maxsize=None)
def _params(seed):
    tree = jax.tree.map(np.asarray, ref_init_params(ref_api.model_specs(_ref_cfg()),
                                                    jax.random.PRNGKey(seed)))
    _draw_lora(tree["layers"]["time"], seed + 100)
    return tree


def _model(seed=0):
    return RWKVLM(smoke_config(ARCH), params=_params(seed), device="cpu")


def _tokens(seed, shape=(2, 12)):
    return np.random.default_rng(seed).integers(0, 256, shape, np.int32)


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.from_numpy(np.array(v))
            for k, v in tree.items()}


def _bitwise_share(got, want) -> float:
    """The share of bf16 values that differ from the reference's."""
    return float(np.mean(got.to(torch.float32).numpy() != np.asarray(want, np.float32)))


def test_smoke_and_layer_configs_match_the_reference():
    cfg, rcfg = smoke_config(ARCH), _ref_cfg()
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(rcfg, f.name), f.name
    assert dataclasses.asdict(cfg.rwkv_config()) == dataclasses.asdict(rcfg.rwkv_config())
    assert cfg.rwkv_config().num_heads == 4
    for ours, ref in ((rwkv6.rwkv6_timemix_specs, ref_rwkv6.rwkv6_timemix_specs),
                      (rwkv6.rwkv6_channelmix_specs, ref_rwkv6.rwkv6_channelmix_specs)):
        flat = jax.tree_util.tree_flatten_with_path(ref(rcfg.rwkv_config()),
                                                    is_leaf=lambda x: hasattr(x, "axes"))[0]
        want = {tuple(k.key for k in path): (s.shape, s.init, s.scale) for path, s in flat}
        got = {path: (s.shape, s.init, s.scale)
               for path, s in iter_leaves(ours(cfg.rwkv_config()))}
        assert got == want


def test_full_width_specs_and_count_match_the_reference():
    cfg = ARCHS[ARCH]
    ref = ref_api.model_specs(REF_ARCHS[ARCH])
    flat = jax.tree_util.tree_flatten_with_path(ref, is_leaf=lambda x: hasattr(x, "axes"))[0]
    want = {tuple(k.key for k in path): (s.shape, s.init, s.scale) for path, s in flat}
    got = {path: (s.shape, s.init, s.scale) for path, s in iter_leaves(api.model_specs(cfg))}
    assert got == want
    count = sum(int(np.prod(s[0])) for s in got.values())
    assert count == ref_param_count(ref) == 1_590_288_384
    assert got[("layers", "time", "lora_b")][0] == (24, 5, 32, 2048)
    assert got[("unembed", "table")][0] == (65536, 2048)
    assert cfg.rwkv_config().num_heads == 32


@pytest.mark.parametrize("with_state", [False, True], ids=["stateless", "float32_state"])
def test_time_and_channel_mix_match_the_jitted_reference(with_state):
    rcfg = _ref_cfg().rwkv_config()
    cfg = smoke_config(ARCH).rwkv_config()
    tree = _params(0)["layers"]
    tp = jax.tree.map(lambda a: a[0], tree["time"])
    cp = jax.tree.map(lambda a: a[0], tree["channel"])
    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 13, rcfg.d_model)).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()
    tm = jax.jit(lambda p, x, s: ref_rwkv6.rwkv6_timemix_apply(p, x, rcfg, state=s))
    cm = jax.jit(lambda p, x, s: ref_rwkv6.rwkv6_channelmix_apply(p, x, rcfg, state=s))
    rs = ps = {"time": None, "channel": None}
    if with_state:
        rs = ref_rwkv6.init_rwkv_state(rcfg, 2, jnp.float32)
        ps = rwkv6.init_rwkv_state(cfg, 2, torch.float32, device="cpu")
        prev = np.asarray(jnp.asarray(0.7 * x[:, :1]).astype(jnp.bfloat16).astype(jnp.float32))
        rs["time"]["shift"] = rs["channel"]["shift"] = jnp.asarray(prev)
        ps["time"]["shift"] = ps["channel"]["shift"] = torch.from_numpy(prev.copy())

    want, rst = tm(tp, xj, rs["time"])
    got, pst, (y, h_final) = rwkv6.rwkv6_timemix_apply(_to_torch(tp), xt, cfg, state=ps["time"])
    assert got.dtype == torch.bfloat16 and got.shape == (2, 13, rcfg.d_model)
    assert y.dtype == h_final.dtype == torch.float32 and y.shape == (2, 13, cfg.num_heads,
                                                                     cfg.head_dim)
    _close(got, want, TOL)
    assert _bitwise_share(got, want) <= 0.01
    want_c, rsc = cm(cp, xj, rs["channel"])
    got_c, psc = rwkv6.rwkv6_channelmix_apply(_to_torch(cp), xt, cfg, state=ps["channel"])
    _close(got_c, want_c, TOL)
    assert _bitwise_share(got_c, want_c) <= 0.01
    if not with_state:
        assert pst is None and psc is None
        return
    # the new states: the time shift in the cache's dtype, the channel
    # shift in the activations', the WKV state float32
    assert pst["shift"].dtype == torch.float32 and psc["shift"].dtype == torch.bfloat16
    assert str(rst["shift"].dtype) == "float32" and str(rsc["shift"].dtype) == "bfloat16"
    _close(pst["wkv"], rst["wkv"], WKV_TOL)
    # one decode step from them
    want, _ = tm(tp, xj[:, :1], rst)
    got, _, _ = rwkv6.rwkv6_timemix_apply(_to_torch(tp), xt[:, :1], cfg, state=pst)
    _close(got, want, TOL)
    want_c, _ = cm(cp, xj[:, :1], rsc)
    got_c, _ = rwkv6.rwkv6_channelmix_apply(_to_torch(cp), xt[:, :1], cfg, state=psc)
    _close(got_c, want_c, TOL)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_forward_logits_match_the_reference(path):
    rcfg = _ref_cfg(PATHS[path])
    toks = _tokens(1, (2, 24))
    want = jax.jit(ref_api.make_forward_fn(rcfg))(_params(0), {"tokens": jnp.asarray(toks)})
    kernels.reset_launch_counts()
    got = api.make_forward_fn(_model())({"tokens": torch.from_numpy(toks).long()})
    assert kernels.launch_counts()["rwkv6_wkv"] == 0
    assert got.shape == (2, 24, 256) and got.dtype == torch.bfloat16
    _close(got, want, TOL)
    logits, caches, aux = forward_lm(_model(), torch.from_numpy(toks).long())
    assert caches is None and float(aux) == 0.0 and torch.equal(logits, got)
    model = _model()
    h, _ = model.hidden(torch.from_numpy(toks).long(), wkv_impl="torch")
    assert torch.equal(model.logits(h), got)


@pytest.mark.parametrize("path", sorted(PATHS))
def test_loss_matches_the_reference(path):
    rcfg = _ref_cfg(PATHS[path])
    toks = _tokens(2, (3, 17))
    want, want_parts = jax.jit(ref_api.make_loss_fn(rcfg))(_params(0),
                                                          {"tokens": jnp.asarray(toks)})
    got, parts = api.make_loss_fn(_model())({"tokens": torch.from_numpy(toks).long()})
    assert got.dtype == torch.float32 and got.ndim == 0 and float(parts["aux"]) == 0.0
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(parts["ce"]), float(want_parts["ce"]), rtol=LOSS_RTOL)
    # the same as the cross entropy of the forward's logits, position by position
    logits = api.make_forward_fn(_model())({"tokens": torch.from_numpy(toks[:, :-1]).long()})
    gold = torch.from_numpy(toks[:, 1:]).long()
    nll = -torch.log_softmax(logits.float(), -1).gather(-1, gold[..., None])[..., 0]
    torch.testing.assert_close(token_nll(logits, gold), nll, rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(float(got), float(nll.mean()), rtol=1e-6)


def test_prefill_then_decode_matches_the_reference():
    rcfg = _ref_cfg()
    params = _params(0)
    toks = _tokens(5, (2, 10))
    rc = ref_tr.init_caches(rcfg, 2, 16, dtype=jnp.float32)
    logits, rc = jax.jit(ref_api.make_prefill_fn(rcfg))(params, rc,
                                                        {"tokens": jnp.asarray(toks[:, :9])})
    logits2, rc = jax.jit(ref_api.make_decode_fn(rcfg))(params, rc,
                                                         {"tokens": jnp.asarray(toks[:, 9:])})

    model = _model()
    tt = torch.from_numpy(toks).long()
    pc = transformer.init_caches(model.cfg, 2, 16, dtype=torch.float32, device="cpu")
    layers = pc["layers"]
    assert layers["time"]["shift"].shape == (2, 2, 1, 64)
    assert layers["time"]["wkv"].shape == (2, 2, 4, 16, 16)
    assert layers["channel"]["shift"].shape == (2, 2, 1, 64)
    assert all(t.dtype == torch.float32 for t in (layers["time"]["shift"],
                                                  layers["time"]["wkv"],
                                                  layers["channel"]["shift"]))
    wkv = layers["time"]["wkv"]
    got, pc = api.make_prefill_fn(model)(pc, {"tokens": tt[:, :9]})
    _close(got, logits, TOL)
    got2, pc = api.make_decode_fn(model)(pc, {"tokens": tt[:, 9:]})
    _close(got2, logits2, TOL)
    assert pc["layers"]["time"]["wkv"] is wkv          # updated in place
    assert pc["pos"] == int(rc["pos"]) == 10
    ref_layers = rc["layers"]
    for part, name in (("time", "shift"), ("time", "wkv"), ("channel", "shift")):
        got_t, want_t = pc["layers"][part][name], ref_layers[part][name]
        assert str(got_t.dtype).split(".")[1] == str(want_t.dtype), (part, name)
        _close(got_t, want_t, TOL)


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
    _close(torch.cat(steps, dim=1), full[:, 8:13].float().numpy(), TOL)


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


def test_parameters_carry_across_from_the_reference_tree():
    tree = _params(0)
    model = _model()
    assert isinstance(build_lm(smoke_config(ARCH), tree, device="cpu"), RWKVLM)
    assert len(model.layers) == 2 and model.unembed is not None
    np.testing.assert_array_equal(model.layers[1].time["lora_b"].numpy(),
                                  tree["layers"]["time"]["lora_b"][1])
    np.testing.assert_array_equal(model.layers[0].channel["key"]["w"].numpy(),
                                  tree["layers"]["channel"]["key"]["w"][0])
    np.testing.assert_array_equal(model.ln_in.bias.numpy(), tree["ln_in"]["bias"])
    np.testing.assert_array_equal(model.unembed.table.numpy(), tree["unembed"]["table"])
    n = sum(p.numel() for p in model.parameters())
    assert n == ref_param_count(ref_api.model_specs(_ref_cfg()))
    broken = dict(tree, layers=dict(tree["layers"], ln2={"scale": tree["layers"]["ln2"]["scale"]}))
    with pytest.raises(KeyError, match="layers/ln2/bias"):
        RWKVLM(smoke_config(ARCH), params=broken, device="cpu")


def test_serve_launcher_runs_rwkv_on_the_host(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--device", "cpu", "--new-tokens", "3", "--batch", "2"])
    serve.main(["--arch", ARCH, "--device", "cpu", "--new-tokens", "2", "--batch", "2",
                "--ensemble", "2"])
    out = capsys.readouterr().out
    assert "single rwkv6-1.6b on cpu" in out and "ensemble[2] rwkv6-1.6b on cpu" in out
