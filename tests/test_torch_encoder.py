"""The port's hubert encoder against the reference's, on the CPU at smoke
size.

Weights are the reference's (``init_params`` from a JAX key) carried as
numpy arrays (``EncoderModel(cfg, params=tree)``, float32 as served, or
their bf16 copies as trained); the frames, targets and mask come from
``concrete_inputs`` of both packages with one seed.  The reference runs its
default jnp attention and its Pallas flash kernel (interpret mode).

Tolerance: 2e-2 absolute and relative on the bf16 logits (magnitudes below
about 3), as ``tests/test_torch_models.py`` holds the decoders: both sides
compute every linear in bf16 and carry the residual stream in bf16 but
round at different places, so logits differ by a bf16 ulp or two.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import smoke_config as ref_smoke_config
from repro.configs.shapes import SHAPES as REF_SHAPES
from repro.models import api as ref_api
from repro.models.common import init_params as ref_init_params
from repro_torch.configs import ARCHS, SHAPES, smoke_config
from repro_torch.models import api
from repro_torch.models.transformer import EncoderModel, build_lm, init_caches
from repro_torch.serve import Server

TOL = 2e-2
ARCH = "hubert-xlarge"


@pytest.fixture(scope="module")
def built():
    rcfg = ref_smoke_config(ARCH)
    params = ref_init_params(ref_api.model_specs(rcfg), jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    return rcfg, params, tree, EncoderModel(smoke_config(ARCH), params=tree, device="cpu")


def _frames(cfg, seed, B=2, T=40):
    return np.random.default_rng(seed).normal(size=(B, T, cfg.d_model)).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


def test_the_config_is_the_reference_s():
    ours, ref = ARCHS[ARCH], REF_ARCHS[ARCH]
    for f in dataclasses.fields(ours):
        assert getattr(ours, f.name) == getattr(ref, f.name), f.name
    assert (ours.family, ours.causal, ours.rope, ours.resolved_head_dim) == (
        "encoder", False, False, 80)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
def test_forward_encoder_matches_the_reference(built, use_pallas):
    rcfg, params, _, model = built
    frames = _frames(rcfg, 1)
    fwd = jax.jit(ref_api.make_forward_fn(dataclasses.replace(rcfg, use_pallas=use_pallas)))
    want = fwd(params, {"frames": jnp.asarray(frames).astype(jnp.bfloat16)})
    with torch.no_grad():
        got = api.make_forward_fn(model)({"frames": torch.from_numpy(frames).bfloat16()})
    assert got.shape == want.shape == (2, 40, rcfg.vocab_size) and got.dtype == torch.bfloat16
    _close(got, want)


def test_forward_encoder_on_bf16_training_weights(built):
    # the trained forward reads the bf16 copies, as the reference's init_state
    rcfg, params, _, _ = built
    pbf = jax.tree.map(lambda a: a.astype(jnp.bfloat16), params)
    frames = _frames(rcfg, 2, T=33)
    want = jax.jit(ref_api.make_forward_fn(rcfg))(pbf, {"frames": jnp.asarray(frames).astype(
        jnp.bfloat16)})
    tree = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16(), pbf)
    model = build_lm(smoke_config(ARCH), tree, device="cpu", trainable=True)
    assert model.pos_conv.dtype == torch.bfloat16
    got = model(torch.from_numpy(frames).bfloat16())
    assert got.grad_fn is not None
    _close(got.detach(), want)


def test_positional_conv_reads_every_16th_tap(built):
    # one tap's weight changes the output only when it is one the reference takes
    # (T = 130: with the taps centred on 64, a tap i reads only padding when
    # T <= |i - 64|)
    _, _, tree, model = built
    h = torch.from_numpy(_frames(smoke_config(ARCH), 3, T=130)).bfloat16()
    base = model.positional(h)
    for tap, read in ((16, True), (17, False), (112, True), (127, False)):
        with torch.no_grad():
            saved = model.pos_conv[tap].clone()
            model.pos_conv[tap] += 1.0
            moved = not torch.equal(model.positional(h), base)
            model.pos_conv[tap] = saved
        assert moved == read, tap


def test_inputs_and_specs_match_the_reference():
    cfg, rcfg = smoke_config(ARCH), ref_smoke_config(ARCH)
    for shape in ("train_4k", "prefill_32k"):
        ours, ref = api.input_specs(cfg, SHAPES[shape]), ref_api.input_specs(rcfg, REF_SHAPES[shape])
        assert list(ours) == list(ref)
        for k in ours:
            assert ours[k].shape == ref[k].shape and str(ours[k].dtype).split(".")[1] == str(
                ref[k].dtype), k
    with pytest.raises(ValueError, match="no decode"):
        api.input_specs(cfg, SHAPES["decode_32k"])
    cell = dataclasses.replace(SHAPES["train_4k"], seq_len=24, global_batch=2)
    ours = api.concrete_inputs(cfg, cell, seed=4, device="cpu")
    ref = ref_api.concrete_inputs(rcfg, dataclasses.replace(REF_SHAPES["train_4k"], seq_len=24,
                                                            global_batch=2), seed=4)
    for k in ("frames", "targets", "mask"):
        np.testing.assert_array_equal(ours[k].float().numpy(), np.asarray(ref[k], np.float32))
    assert ours["mask"].dtype == torch.bool and ours["targets"].dtype == torch.int32


def test_encoder_loss_and_prefill(built):
    rcfg, params, _, model = built
    cell = dataclasses.replace(REF_SHAPES["train_4k"], seq_len=24, global_batch=2)
    rbatch = ref_api.concrete_inputs(rcfg, cell, seed=5)
    batch = api.concrete_inputs(smoke_config(ARCH), dataclasses.replace(
        SHAPES["train_4k"], seq_len=24, global_batch=2), seed=5, device="cpu")
    want, wm = jax.jit(ref_api.make_loss_fn(rcfg))(params, rbatch)
    with torch.no_grad():
        got, gm = api.make_loss_fn(model)(batch)
        logits, caches = api.make_prefill_fn(model)({"frames": batch["frames"]})
    assert abs(float(got) - float(want)) < 1e-3 and float(gm["aux"]) == 0.0
    assert caches is None and logits.shape == (2, 24, rcfg.vocab_size)


def test_the_encoder_has_no_decode(built):
    cfg = smoke_config(ARCH)
    with pytest.raises(ValueError, match="no decode caches"):
        init_caches(cfg, 2, 16, device="cpu")
    with pytest.raises(ValueError, match="do not decode"):
        Server(cfg, built[3], device="cpu")
