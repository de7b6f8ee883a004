"""The port's training against the reference's, on the CPU at smoke size.

The same parameters (the reference's ``init_params`` from a JAX key,
carried as numpy arrays into the port's ``init_state(params=...)``) and the
same numpy-seeded batches go through both packages; both train on the
bf16 copies of the float32 master weights.

Tolerances, each from what bf16 training allows:

* loss: 1e-3 absolute.  Both sides sum float32 cross entropies of bf16
  logits; the logits differ by bf16 ulps where the two frameworks round
  activations at different places (observed: under 2e-4).
* gradients, leaf by leaf: relative L2 error under 3e-2, and every entry
  within 5e-2 of the leaf's largest magnitude.  The gradients are bf16
  (2^-8 relative a value) and accumulate over layers in another order
  (observed: at most 1.5e-2 on both measures, every config).  The
  known-wrong control (flash's backward without the Dvec term) puts the
  attention weights' gradients 0.25-0.6 away.  The MoE, hybrid and RWKV6
  configs are held the same way: the MoE at the smoke config's ample
  capacity and, with ``moe_groups=2``, at a capacity factor of 1.0 that
  drops assignments; the hybrid's and RWKV6's scans through their plain
  backwards (``kernels/*/ref.py``), which ``tests/test_torch_ssd_bwd.py``
  and ``tests/test_torch_wkv_bwd.py`` hold to ``jax.grad``.
* three train steps: the master weights' updates within 5e-2 relative L2
  (observed: 1.6e-2), the losses within 1e-3, the gradient norms within
  1e-2 relative.  AdamW's first steps move each weight by about ``lr``
  times the sign of its gradient, so a gradient near zero that differs in
  sign between the packages moves its weight the other way: the update's
  error is that of a few such entries, not of the gradients' values.

zamba2 and rwkv6 are chaotic in bf16 under AdamW at this rate: the
reference's own eager and jitted runs part by 2.05 against 2.73 in the
first step's gradient norm and by up to 0.91 (relative L2) in a leaf's
update after three steps, and an untied embedding whose few used rows
take sign-like updates turns the share of near-zero gradients that flip
sign (0.18% for rwkv6, against llama's 0.02%) into an update error of
twice its square root.  So their three steps each start from the
reference's state (teacher-forced: the packages cannot drift apart), and
the optimizer's moments m and v, smooth in the gradients, are held to
UPDATE_REL_L2 in place of the sign-like updates; the losses, gradient
norms and rates as for llama.  zamba2's gradient leaves are held at the
reference's parameters from seed 1: at seed 0 the float32 dt projection's
sums (another order than XLA's) differ in the last bit at 92 of 256
entries of the second Mamba2 layer, one bf16 value of that layer's output
rounds the other way, the shared block's attention spreads it, and the
epilogue's C projection, whose gradient is the smallest, lands 3.8e-2
from the reference's (seeds 1 to 5: at most 1.9e-2 on any leaf).
"""

import dataclasses
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.configs.shapes import ShapeCell as RefShapeCell
from repro.models import api as ref_api
from repro.models.common import init_params as ref_init_params
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import adamw_init as ref_adamw_init
from repro.train import TrainConfig as RefTrainConfig
from repro.train import make_train_step as ref_make_train_step
from repro_torch.checkpoint import store
from repro_torch.configs import smoke_config
from repro_torch.configs.shapes import ShapeCell
from repro_torch.core import RSPSpec, two_stage_partition_np
from repro_torch.data import BlockSource, RSPLoader, make_token_corpus
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mamba2_ssd import ssd
from repro_torch.kernels.rwkv6_wkv import wkv6
from repro_torch.models import api
from repro_torch.models.common import (
    iter_leaves,
    seq_chunked_cross_entropy,
    set_leaf,
    softmax_cross_entropy,
)
from repro_torch.models.transformer import build_lm, loss_fn
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, Trainer, init_state, make_train_step, param_grads

LOSS_TOL = 1e-3
GRAD_REL_L2 = 3e-2
GRAD_MAX = 5e-2
UPDATE_REL_L2 = 5e-2

CONFIGS = {
    "llama grouped": ("llama3.2-1b", {}),
    "llama flat, seq-chunked CE": ("llama3.2-1b", {"flat_attention": True,
                                                   "loss_seq_chunks": 4}),
    "qwen2": ("qwen2-0.5b", {}),
    "hubert": ("hubert-xlarge", {}),
    "granite-moe": ("granite-moe-3b-a800m", {}),
    "granite-moe dropping, 2 groups": ("granite-moe-3b-a800m", {"moe_capacity_factor": 1.0}),
    "zamba2": ("zamba2-7b", {}),
    "rwkv6": ("rwkv6-1.6b", {}),
}
# the MoE layers' dispatch groups of a config (the reference's moe_groups)
MOE_GROUPS = {"granite-moe dropping, 2 groups": 2}
# the reference parameters' seed of a config, 0 unless named (see above)
PARAM_SEEDS = {"zamba2": 1}


def _configs(arch, over):
    return (dataclasses.replace(ref_smoke_config(arch), **over),
            dataclasses.replace(smoke_config(arch), **over))


def _ref_params(rcfg, seed=0):
    return ref_init_params(ref_api.model_specs(rcfg), jax.random.PRNGKey(seed))


def _batch(rcfg, seed=1):
    """The same batch for both packages: (reference dict, port dict)."""
    if rcfg.family == "encoder":
        ref = ref_api.concrete_inputs(rcfg, RefShapeCell("t", "train", 24, 2), seed=seed)
        ours = api.concrete_inputs(smoke_config(rcfg.name), ShapeCell("t", "train", 24, 2),
                                   seed=seed, device="cpu")
        return ref, ours
    toks = np.random.default_rng(seed).integers(0, rcfg.vocab_size, (2, 17), dtype=np.int32)
    return {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}


def _ref_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {tuple(k.key for k in path): np.asarray(v, np.float32) for path, v in flat}


def _grads_close(got, want):
    for path, leaf in iter_leaves(got):
        a, b = leaf.float().numpy(), want[path]
        rel = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
        worst = np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
        assert rel < GRAD_REL_L2 and worst < GRAD_MAX, (path, rel, worst)


def _port_grads(cfg, params, batch, moe_groups=1):
    state = init_state(cfg, params=jax.tree.map(np.asarray, params), device="cpu")
    model = build_lm(cfg, state["params"], device="cpu", trainable=True)
    loss, metrics = loss_fn(model, batch, moe_groups=moe_groups)
    loss.backward()
    return loss.detach(), param_grads(model, state["params"])


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def reference_grads(request):
    arch, over = CONFIGS[request.param]
    groups = MOE_GROUPS.get(request.param, 1)
    rcfg, cfg = _configs(arch, over)
    params = _ref_params(rcfg, seed=PARAM_SEEDS.get(request.param, 0))
    rbatch, batch = _batch(rcfg)
    pbf = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        ref_api.make_loss_fn(rcfg, moe_groups=groups), has_aux=True))(pbf, rbatch)
    return cfg, params, batch, float(loss), _ref_leaves(grads), groups


def test_loss_and_every_gradient_leaf_match_the_reference(reference_grads):
    cfg, params, batch, want_loss, want, groups = reference_grads
    loss, grads = _port_grads(cfg, params, batch, moe_groups=groups)
    assert abs(float(loss) - want_loss) < LOSS_TOL
    assert {p for p, _ in iter_leaves(grads)} == set(want)
    _grads_close(grads, want)


def test_a_backward_without_dvec_is_refused(reference_grads, monkeypatch):
    # the known-wrong control: flash's plain backward given a zero output,
    # so Dvec = rowsum(dout * out) drops out of dS
    cfg, params, batch, _, want, groups = reference_grads
    if cfg.family == "rwkv":
        pytest.skip("rwkv6 has no attention")
    real = fa_ops.flash_attention_bwd_plain
    monkeypatch.setattr(fa_ops, "flash_attention_bwd_plain",
                        lambda q, k, v, out, dout, m, l, **kw: real(
                            q, k, v, torch.zeros_like(out), dout, m, l, **kw))
    _, grads = _port_grads(cfg, params, batch, moe_groups=groups)
    with pytest.raises(AssertionError):
        _grads_close(grads, want)


# leaves the reference initialises to zero, whose gradient is zero too at
# the first step: the low-rank products' second factors (rwkv6's lora_b and
# w_lora_b) keep the first factors' gradients at zero
ZERO_AT_INIT = {"lora_a", "w_lora_a", "lora_b", "w_lora_b"}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_every_parameter_leaf_gets_a_nonzero_gradient(name):
    arch, over = CONFIGS[name]
    rcfg, cfg = _configs(arch, over)
    _, grads = _port_grads(cfg, _ref_params(rcfg, seed=3), _batch(rcfg, seed=4)[1],
                           moe_groups=MOE_GROUPS.get(name, 1))
    for path, g in iter_leaves(grads):
        if ZERO_AT_INIT & set(path):
            continue
        if path[0] in ("layers", "rounds", "epilogue"):   # every layer of a stacked leaf
            assert all(bool(gi.abs().sum() > 0) for gi in g.flatten(0, 1 if path[0] == "rounds"
                                                                      else 0)), path
        else:
            assert bool(g.abs().sum() > 0), path


def test_trainable_parameters_share_the_state_and_require_grad():
    cfg = smoke_config("llama3.2-1b")
    state = init_state(cfg, seed=0, device="cpu")
    model = build_lm(cfg, state["params"], device="cpu", trainable=True)
    q = state["params"]["layers"]["attn"]["q"]["w"]
    assert model.layers[1].attn["q"]["w"].data_ptr() == q[1].data_ptr()
    assert all(p.requires_grad and p.dtype == torch.bfloat16 for p in model.parameters())
    assert not any(p.requires_grad for p in build_lm(cfg, device="cpu").parameters())


def test_remat_changes_no_gradient():
    cfg = smoke_config("llama3.2-1b")
    rcfg = ref_smoke_config("llama3.2-1b")
    params, batch = _ref_params(rcfg), _batch(rcfg)[1]
    on = _port_grads(cfg, params, batch)[1]
    off = _port_grads(dataclasses.replace(cfg, remat=False), params, batch)[1]
    for (path, a), (_, b) in zip(iter_leaves(on), iter_leaves(off)):
        assert torch.equal(a, b), path


def test_seq_chunked_cross_entropy_is_the_full_one():
    g = torch.Generator().manual_seed(0)
    h = torch.randn((2, 12, 16), generator=g)
    table = torch.randn((40, 16), generator=g)
    labels = torch.randint(0, 40, (2, 12), generator=g)
    full = softmax_cross_entropy(h.bfloat16() @ table.bfloat16().T, labels)
    for chunks in (1, 3, 4, 5):       # 5 does not divide 12: the full CE
        got = seq_chunked_cross_entropy(h, table, labels, chunks=chunks)
        torch.testing.assert_close(got, full, rtol=1e-6, atol=1e-6)


STEP_CASES = {
    # name: arch, microbatch, moe_groups, config overrides, teacher-forced
    "llama": ("llama3.2-1b", 0, 1, {}, False),
    "llama, 2 microbatches": ("llama3.2-1b", 2, 1, {}, False),
    "granite-moe dropping, 2 groups": ("granite-moe-3b-a800m", 0, 2,
                                       {"moe_capacity_factor": 1.0}, False),
    "zamba2": ("zamba2-7b", 0, 1, {}, True),
    "rwkv6": ("rwkv6-1.6b", 0, 1, {}, True),
}


def _port_state(rstate):
    """The reference's training state as the port's tree (bf16 params,
    float32 master, m and v, int32 step)."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(rstate)[0]:
        t = torch.from_numpy(np.array(leaf.astype(jnp.float32) if leaf.dtype == jnp.bfloat16
                                      else leaf))
        set_leaf(out, tuple(k.key for k in path),
                 t.bfloat16() if leaf.dtype == jnp.bfloat16 else t)
    return out


def _moments_close(state, rstate):
    for part in ("m", "v"):
        want = _ref_leaves(rstate["opt"][part])
        for path, leaf in iter_leaves(state["opt"][part]):
            got, ref = leaf.numpy(), want[path]
            if not np.any(ref):          # a leaf with no gradient yet (rwkv6's lora_a)
                assert not np.any(got), (part, path)
            else:
                assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < UPDATE_REL_L2, (
                    part, path)


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_three_train_steps_match_the_reference(name):
    arch, microbatch, groups, over, forced = STEP_CASES[name]
    rcfg, cfg = _configs(arch, over)
    params = _ref_params(rcfg)
    rstate = {"params": jax.tree.map(lambda a: a.astype(jnp.bfloat16), params),
              "opt": ref_adamw_init(params)}
    state = init_state(cfg, params=jax.tree.map(np.asarray, params), device="cpu")
    before = {p: t.clone() for p, t in iter_leaves(state["opt"]["master"])}
    ref_step = jax.jit(ref_make_train_step(rcfg, RefAdamWConfig(lr=1e-2), RefTrainConfig(
        total_steps=3, warmup_steps=1, microbatch=microbatch, moe_groups=groups)))
    step = make_train_step(cfg, AdamWConfig(lr=1e-2), TrainConfig(
        total_steps=3, warmup_steps=1, microbatch=microbatch, moe_groups=groups))
    rng = np.random.default_rng(5)
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab_size, (4, 17), dtype=np.int32)
        if forced:
            state = _port_state(rstate)
        rstate, rm = ref_step(rstate, {"tokens": jnp.asarray(toks)})
        state, m = step(state, {"tokens": torch.from_numpy(toks)})
        assert abs(float(m["loss"]) - float(rm["loss"])) < LOSS_TOL
        assert float(m["grad_norm"]) == pytest.approx(float(rm["grad_norm"]), rel=1e-2)
        assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        if forced:
            _moments_close(state, rstate)
    assert int(state["opt"]["step"]) == int(rstate["opt"]["step"]) == 3
    want = _ref_leaves(rstate["opt"]["master"])
    for path, leaf in iter_leaves(state["opt"]["master"]) if not forced else ():
        got, ref = (leaf - before[path]).numpy(), want[path] - before[path].numpy()
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < UPDATE_REL_L2, path
    # the compute parameters are the master weights in bf16
    for (path, p), (_, w) in zip(iter_leaves(state["params"]), iter_leaves(state["opt"]["master"])):
        assert p.dtype == torch.bfloat16 and torch.equal(p, w.bfloat16()), path


# ---------------------------------------------------------------------------
# the Trainer: an LM trained from an RSP corpus, killed and resumed
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def rsp_token_loader_factory():
    corpus = make_token_corpus(256, 17, vocab_size=256, seed=0)   # records = sequences
    spec = RSPSpec(num_records=256, num_blocks=16, num_original_blocks=16, seed=1)
    blocks = two_stage_partition_np(corpus, spec)

    def make(seed=3):
        return RSPLoader(BlockSource(blocks=blocks, device="cpu"), batch_size=8, seed=seed)

    return make


def _trainer(path, loader, total_steps, ckpt_every=5, arch="llama3.2-1b"):
    tc = TrainConfig(total_steps=total_steps, warmup_steps=2, checkpoint_every=ckpt_every,
                     log_every=2, seed=0)
    return Trainer(smoke_config(arch), AdamWConfig(lr=1e-2), tc, loader, str(path / "ckpt"),
                   device="cpu", batch_transform=lambda b: {"tokens": b.to(torch.int32)})


def test_training_reduces_loss(tmp_path, rsp_token_loader_factory):
    trainer = _trainer(tmp_path, rsp_token_loader_factory(), total_steps=20)
    trainer.run()
    losses = [h["loss"] for h in trainer.history]
    assert losses[-1] < losses[0] - 0.1, losses
    assert store.all_steps(str(tmp_path / "ckpt")) == [10, 15, 20]   # keep_last 3


def test_restart_resumes_bit_exactly(tmp_path, rsp_token_loader_factory):
    """Preempted at 5 and resumed, the run reproduces the uninterrupted one
    bit for bit (same schedule horizon, same data order, exact restore)."""
    ref = _trainer(tmp_path / "ref", rsp_token_loader_factory(), 10, ckpt_every=100).run()
    _trainer(tmp_path / "resume", rsp_token_loader_factory(), 10, ckpt_every=100).run(
        stop_after_steps=5)
    assert store.latest_step(str(tmp_path / "resume" / "ckpt")) == 5
    got = _trainer(tmp_path / "resume", rsp_token_loader_factory(), 10, ckpt_every=100).run()
    for (path, a), (_, b) in zip(iter_leaves(ref["opt"]), iter_leaves(got["opt"])):
        assert torch.equal(a, b), path
    assert int(got["opt"]["step"]) == 10


def test_schedule_horizon_mismatch_is_detectable(tmp_path, rsp_token_loader_factory):
    """A run checkpointed under another total_steps (schedule horizon)
    diverges: the horizon is part of the train config."""
    short = _trainer(tmp_path / "short", rsp_token_loader_factory(), 5, ckpt_every=5).run()
    long = _trainer(tmp_path / "long", rsp_token_loader_factory(), 10, ckpt_every=100).run(
        stop_after_steps=5)
    diffs = [float((a - b).abs().max()) for (_, a), (_, b)
             in zip(iter_leaves(short["opt"]["master"]), iter_leaves(long["opt"]["master"]))]
    assert max(diffs) > 0.0


def test_microbatch_accumulation_matches_full_batch(rsp_token_loader_factory):
    cfg = smoke_config("qwen2-0.5b")
    batch = {"tokens": rsp_token_loader_factory().next_batch().to(torch.int32)}
    opt = AdamWConfig(lr=1e-2)
    s1, _ = make_train_step(cfg, opt, TrainConfig(total_steps=1, warmup_steps=0))(
        init_state(cfg, seed=0, device="cpu"), batch)
    s2, _ = make_train_step(cfg, opt, TrainConfig(total_steps=1, warmup_steps=0, microbatch=4))(
        init_state(cfg, seed=0, device="cpu"), batch)
    for (path, a), (_, b) in zip(iter_leaves(s1["opt"]["master"]),
                                 iter_leaves(s2["opt"]["master"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-3, atol=5e-4, err_msg=str(path))


def test_sigterm_ends_the_run_with_a_checkpoint(tmp_path, rsp_token_loader_factory):
    trainer = _trainer(tmp_path, rsp_token_loader_factory(), total_steps=10, ckpt_every=100)
    real = trainer.step_fn

    def step_then_signal(state, batch):
        out = real(state, batch)
        if int(out[0]["opt"]["step"]) == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    trainer.step_fn = step_then_signal
    state = trainer.run()
    assert int(state["opt"]["step"]) == 3
    assert store.latest_step(str(tmp_path / "ckpt")) == 3


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "zamba2-7b", "rwkv6-1.6b"])
def test_every_family_trains_through_the_trainer(arch, tmp_path, rsp_token_loader_factory):
    trainer = _trainer(tmp_path, rsp_token_loader_factory(), total_steps=6, ckpt_every=100,
                       arch=arch)
    state = trainer.run()
    assert int(state["opt"]["step"]) == 6
    losses = [h["loss"] for h in trainer.history]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    model = build_lm(smoke_config(arch), state["params"], device="cpu", trainable=True)
    assert all(p.requires_grad and p.dtype == torch.bfloat16 for p in model.parameters())


def test_a_state_that_requires_grad_is_refused_by_both_scans():
    g = torch.Generator().manual_seed(0)
    xbar = torch.randn((1, 16, 2, 8), generator=g, requires_grad=True)
    dA = -torch.rand((1, 16, 2), generator=g)
    Bm, Cm = torch.randn((1, 16, 4), generator=g), torch.randn((1, 16, 4), generator=g)
    with pytest.raises(NotImplementedError, match="initial state"):
        ssd(xbar, dA, Bm, Cm, chunk=8, h0=torch.zeros((1, 2, 8, 4), requires_grad=True))
    r, k, v = (torch.randn((1, 20, 2, 8), generator=g, requires_grad=True) for _ in range(3))
    w = torch.rand((1, 20, 2, 8), generator=g) * 0.5 + 0.4
    u = torch.randn((2, 8), generator=g)
    with pytest.raises(NotImplementedError, match="initial state"):
        wkv6(r, k, v, w, u, h0=torch.zeros((1, 2, 8, 8), requires_grad=True))
    with torch.no_grad():     # no graph: the state is only read
        wkv6(r, k, v, w, u, h0=torch.zeros((1, 2, 8, 8), requires_grad=True))


def test_plain_ssd_and_wkv_still_differentiate():
    # on the host the scans' functions carry the gradient through the plain
    # backwards, the final states' gradients included
    g = torch.Generator().manual_seed(0)
    xbar = torch.randn((1, 16, 2, 8), generator=g, requires_grad=True)
    dA = -torch.rand((1, 16, 2), generator=g)
    Bm, Cm = torch.randn((1, 16, 4), generator=g), torch.randn((1, 16, 4), generator=g)
    y, h = ssd(xbar, dA, Bm, Cm, chunk=8)
    (y.sum() + h.sum()).backward()
    assert xbar.grad is not None and bool(xbar.grad.abs().sum() > 0)
    r, k, v = (torch.randn((1, 20, 2, 8), generator=g, requires_grad=True) for _ in range(3))
    w = torch.rand((1, 20, 2, 8), generator=g) * 0.5 + 0.4
    u = torch.randn((2, 8), generator=g, requires_grad=True)
    y, h = wkv6(r, k, v, w, u)
    (y.sum() + h.sum()).backward()
    for t in (r, k, v, u):
        assert t.grad is not None and bool(t.grad.abs().sum() > 0)


def test_launch_train_on_the_cpu(tmp_path):
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "llama3.2-1b",
           "--device", "cpu", "--steps", "4", "--seq", "16", "--sequences", "64", "--blocks", "8",
           "--ckpt-dir", str(tmp_path / "ckpt")]
    out = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert '"loss"' in out.stdout
    assert store.latest_step(str(tmp_path / "ckpt")) == 4
    enc = subprocess.run(cmd[:4] + ["hubert-xlarge", "--device", "cpu"], capture_output=True,
                         text=True, env=env, timeout=300)
    assert enc.returncode != 0 and "masked-prediction" in enc.stderr
