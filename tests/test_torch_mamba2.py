"""The port's Mamba2 layer and SSD scan against the reference's, on the CPU.

Inputs are drawn with numpy from a seed and handed to both sides.  The
reference's SSD runs as its own tests run it: the Pallas kernel in
interpret mode (``ssd_ops.ssd``) and the jnp oracles (``ssd_chunked``,
``ssd_reference``).  The port's side is the plain chunked form
(``ssd(..., impl="torch")``) and the step recurrence; the CUDA kernel runs
only on a card (``test_torch_cuda.py``).

Tolerances: 2e-4 absolute and relative on the scan, the reference's own
for its kernel (``tests/test_kernels.py``): float32 sums in another order.
The causal conv is bf16 tap by tap on both sides, so it must agree bit for
bit.  The layer: 2e-2 on bf16 outputs of magnitude below 1, as in
``test_torch_models.py`` (one or two bf16 ulps where the two frameworks
round at different places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as ref_smoke_config
from repro.kernels.mamba2_ssd import ops as ref_ssd_ops
from repro.models import mamba2 as ref_mamba2
from repro.models.common import init_params as ref_init_params
from repro_torch import kernels
from repro_torch.configs import smoke_config
from repro_torch.kernels.mamba2_ssd import head_tile, ssd, ssd_cuda, ssd_recurrence
from repro_torch.models import mamba2

SSD_TOL = 2e-4
LAYER_TOL = 2e-2

# B, L, H, P, N, chunk: tests/test_kernels.py's sweep (the third pads L)
SSD_SHAPES = [
    (1, 32, 2, 8, 4, 8),
    (2, 64, 4, 16, 16, 16),
    (1, 24, 2, 8, 8, 16),
    (1, 16, 8, 4, 4, 16),
]


def _ssd_inputs(seed, B, L, H, P, N, decay="softplus"):
    rng = np.random.default_rng(seed)
    xbar = rng.normal(size=(B, L, H, P)).astype(np.float32)
    if decay == "softplus":
        dA = -np.log1p(np.exp(rng.normal(size=(B, L, H)))).astype(np.float32)
    elif decay == "strong":
        dA = np.full((B, L, H), -30.0, np.float32)
    else:  # weak: the state carries across every chunk
        dA = rng.uniform(-1e-3, 0.0, size=(B, L, H)).astype(np.float32)
    Bm = rng.normal(size=(B, L, N)).astype(np.float32)
    Cm = rng.normal(size=(B, L, N)).astype(np.float32)
    return xbar, dA, Bm, Cm


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got.to(torch.float32)), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


CASES = [(shape, "softplus") for shape in SSD_SHAPES] + [
    ((1, 64, 2, 4, 4, 16), "strong"),      # tests/test_kernels.py's dA = -30
    ((2, 96, 3, 8, 8, 16), "weak"),        # dA in [-1e-3, 0] over 6 chunks
]


@pytest.mark.parametrize("shape,decay", CASES, ids=lambda c: str(c))
def test_ssd_matches_the_reference_kernel_and_oracle(shape, decay):
    B, L, H, P, N, chunk = shape
    arrays = _ssd_inputs(L + H, B, L, H, P, N, decay)
    pallas = ref_ssd_ops.ssd(*map(jnp.asarray, arrays), chunk=chunk, head_tile=2)
    oracle = ref_mamba2.ssd_reference(*map(jnp.asarray, arrays))
    kernels.reset_launch_counts()
    y, h = ssd(*map(torch.from_numpy, arrays), chunk=chunk)
    assert kernels.launch_counts()["mamba2_ssd"] == 0
    assert y.shape == (B, L, H, P) and h.shape == (B, H, P, N) and y.dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    for want_y, want_h in (pallas, oracle):
        _close(y, want_y, SSD_TOL)
        _close(h, want_h, SSD_TOL)
    # the port's step recurrence is the reference's oracle
    y2, h2 = ssd_recurrence(*map(torch.from_numpy, arrays))
    _close(y2, oracle[0], SSD_TOL)
    _close(h2, oracle[1], SSD_TOL)


def test_weak_decay_carries_the_state_across_chunks():
    """With dA near 0 the inter-chunk term is most of y: dropping it (each
    chunk from a zero state) must be far outside the tolerance."""
    B, L, H, P, N, chunk = 1, 64, 2, 4, 4, 8
    arrays = [torch.from_numpy(a) for a in _ssd_inputs(5, B, L, H, P, N, "weak")]
    y, _ = ssd(*arrays, chunk=chunk)
    split = [a.reshape(B * L // chunk, chunk, *a.shape[2:]) for a in arrays]
    y_cut, _ = ssd(*split, chunk=chunk)
    gap = (y - y_cut.reshape(y.shape)).abs().max()
    assert float(gap) > 100 * SSD_TOL


def test_ssd_chunked_with_h0_and_a_split_sequence():
    B, L, H, P, N, chunk = 2, 40, 3, 8, 4, 8
    xbar, dA, Bm, Cm = _ssd_inputs(11, B, L, H, P, N)
    h0 = np.random.default_rng(12).normal(size=(B, H, P, N)).astype(np.float32)
    want_y, want_h = ref_mamba2.ssd_chunked(*map(jnp.asarray, (xbar, dA, Bm, Cm)), chunk=chunk,
                                            h0=jnp.asarray(h0))
    t = [torch.from_numpy(a) for a in (xbar, dA, Bm, Cm)]
    y, h = ssd(*t, chunk=chunk, h0=torch.from_numpy(h0), impl="torch")
    _close(y, want_y, SSD_TOL)
    _close(h, want_h, SSD_TOL)
    # the first 20 steps, then the rest from their final state
    y1, h1 = ssd(*(a[:, :20] for a in t), chunk=chunk, h0=torch.from_numpy(h0))
    y2, h2 = ssd(*(a[:, 20:] for a in t), chunk=chunk, h0=h1)
    _close(torch.cat([y1, y2], dim=1), want_y, SSD_TOL)
    _close(h2, want_h, SSD_TOL)


@pytest.mark.parametrize("with_state", [False, True], ids=["prefill", "from_state"])
def test_causal_conv_is_bit_for_bit(with_state):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 9, 24)).astype(np.float32)
    k = (0.5 * rng.normal(size=(4, 24))).astype(np.float32)
    st = rng.normal(size=(2, 3, 24)).astype(np.float32) if with_state else None
    conv = jax.jit(ref_mamba2._causal_conv)
    bf16 = jnp.bfloat16
    want, want_state = conv(jnp.asarray(x).astype(bf16), jnp.asarray(k).astype(bf16),
                            None if st is None else jnp.asarray(st))
    got, got_state = mamba2._causal_conv(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(k).bfloat16(),
        None if st is None else torch.from_numpy(st))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    np.testing.assert_array_equal(got_state.view(torch.int16).numpy(),
                                  np.asarray(want_state).view(np.int16))


@pytest.fixture(scope="module")
def layer():
    rcfg = ref_smoke_config("zamba2-7b")
    mcfg = rcfg.mamba_config()
    params = ref_init_params(ref_mamba2.mamba2_specs(mcfg), jax.random.PRNGKey(4))
    ours = {k: torch.from_numpy(np.array(v)) for k, v in params.items() if not isinstance(v, dict)}
    ours.update({k: {kk: torch.from_numpy(np.array(vv)) for kk, vv in v.items()}
                 for k, v in params.items() if isinstance(v, dict)})
    return mcfg, params, ours, smoke_config("zamba2-7b").mamba_config()


def test_mamba_config_matches_the_reference(layer):
    rcfg, _, _, cfg = layer
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert (cfg.d_inner, cfg.num_heads) == (rcfg.d_inner, rcfg.num_heads)
    ref_specs = jax.tree_util.tree_flatten_with_path(
        ref_mamba2.mamba2_specs(rcfg), is_leaf=lambda x: hasattr(x, "axes"))[0]
    want = {tuple(k.key for k in path): (s.shape, s.init, s.scale) for path, s in ref_specs}
    from repro_torch.models.common import iter_leaves

    got = {path: (s.shape, s.init, s.scale) for path, s in iter_leaves(mamba2.mamba2_specs(cfg))}
    assert got == want


@pytest.mark.parametrize("use_pallas", [False, True], ids=["jnp", "pallas"])
def test_mamba2_apply_matches_the_reference(layer, use_pallas):
    rcfg, params, ours, cfg = layer
    x = np.random.default_rng(6).normal(size=(2, 13, rcfg.d_model)).astype(np.float32)
    xj, xt = jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).bfloat16()
    apply = jax.jit(lambda p, x, s: ref_mamba2.mamba2_apply(p, x, rcfg, state=s,
                                                            use_pallas=use_pallas))

    # without a state: the whole sequence through the scan
    want, _ = apply(params, xj, None)
    got, none = mamba2.mamba2_apply(ours, xt, cfg)
    assert none is None and got.dtype == torch.bfloat16 and got.shape == (2, 13, rcfg.d_model)
    _close(got, want, LAYER_TOL)

    # a prefill of 12 steps into a float32 state, then one decode step
    rs = ref_mamba2.init_mamba_state(rcfg, 2, jnp.float32)
    ps = mamba2.init_mamba_state(cfg, 2, torch.float32, device="cpu")
    want, rs = apply(params, xj[:, :12], rs)
    got, ps = mamba2.mamba2_apply(ours, xt[:, :12], cfg, state=ps)
    _close(got, want, LAYER_TOL)
    assert ps["conv"].dtype == torch.float32 and ps["ssm"].dtype == torch.float32
    _close(ps["conv"], rs["conv"], LAYER_TOL)
    _close(ps["ssm"], rs["ssm"], LAYER_TOL)
    want, rs = apply(params, xj[:, 12:], rs)
    got, ps = mamba2.mamba2_apply(ours, xt[:, 12:], cfg, state=ps)
    _close(got, want, LAYER_TOL)
    _close(ps["ssm"], rs["ssm"], LAYER_TOL)


def test_ssd_dispatch_and_the_kernels_checks():
    arrays = [torch.from_numpy(a) for a in _ssd_inputs(1, 1, 128, 2, 64, 64)]
    with pytest.raises(ValueError, match="unknown impl"):
        ssd(*arrays, chunk=128, impl="pallas")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd(*arrays, chunk=128, impl="cuda")
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd_cuda(*arrays)
    with pytest.raises(ValueError, match="dA must be"):
        ssd_cuda(arrays[0], arrays[1][:, :64], *arrays[2:])
    with pytest.raises(ValueError, match="h0 must be"):
        ssd_cuda(*arrays, h0=torch.zeros(1, 2, 64, 32))
    meta = [a.to("meta") for a in arrays]
    with pytest.raises(ValueError, match="but the block is on cpu"):
        ssd_cuda(arrays[0], *meta[1:])


def test_head_tile_fills_the_card():
    # zamba2-7b: 112 heads; 132 SMs on an H100
    assert head_tile(8, 112, 132) == 7          # 128 CTAs in one wave
    assert head_tile(1, 112, 132) == 1          # 112 CTAs
    for batch in (1, 2, 3, 8, 16):
        ht = head_tile(batch, 112, 132)
        assert 112 % ht == 0
