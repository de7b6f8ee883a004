"""The port's AdamW and learning-rate schedules against the reference's.

The same numpy-seeded master weights, moments and gradients (float32 and
bf16 leaves) go through both ``adamw_update``s.  Tolerance: 1e-6 relative
(and 1e-9 absolute) on the new master weights, moments, compute
parameters and stats: both compute each leaf's update in float32 with the
same operations, and differ only where XLA fuses (a multiply-add in one
rounding) and in the last bit of ``b ** t``.  The schedules are held
within 1e-6 at every step from 0 to the horizon for the same reason.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim import SCHEDULES as REF_SCHEDULES
from repro.optim import adamw_init as ref_adamw_init
from repro.optim import adamw_update as ref_adamw_update
from repro.optim import global_norm as ref_global_norm
from repro_torch.models.common import iter_leaves
from repro_torch.optim import (
    SCHEDULES,
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
    warmup_cosine,
)

RTOL, ATOL = 1e-6, 1e-9


def _tree(rng, scale=1.0):
    return {"a": {"w": (rng.normal(size=(5, 3)) * scale).astype(np.float32)},
            "b": (rng.normal(size=(7,)) * scale).astype(np.float32),
            "layers": {"x": (rng.normal(size=(2, 4, 4)) * scale).astype(np.float32)}}


def _state(rng):
    master = _tree(rng)
    m, v = _tree(rng, 0.01), jax.tree.map(np.abs, _tree(rng, 1e-4))
    return master, m, v


def _close(got: torch.Tensor, want, tol=RTOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=ATOL)


@pytest.mark.parametrize("grad_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step,lr_scale,clip", [(0, 1.0, 1.0), (6, 0.37, 1.0), (41, 0.9, 100.0)])
def test_adamw_update_matches_the_reference(grad_dtype, step, lr_scale, clip):
    rng = np.random.default_rng(step)
    master, m, v = _state(rng)
    grads = _tree(rng, 0.5)
    cfg = dict(lr=3e-3, weight_decay=0.1, grad_clip=clip)
    rstate = {"master": jax.tree.map(jnp.asarray, master), "m": jax.tree.map(jnp.asarray, m),
              "v": jax.tree.map(jnp.asarray, v), "step": jnp.asarray(step, jnp.int32)}
    rgrads = jax.tree.map(lambda g: jnp.asarray(g).astype(grad_dtype), grads)
    want_state, want_params, want_stats = ref_adamw_update(
        rstate, rgrads, RefAdamWConfig(**cfg), lr_scale=jnp.float32(lr_scale))

    def t(tree):
        return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)

    state = {"master": t(master), "m": t(m), "v": t(v),
             "step": torch.tensor(step, dtype=torch.int32)}
    tgrads = jax.tree.map(lambda g: torch.from_numpy(g).to(getattr(torch, grad_dtype)), grads)
    masters = [leaf for _, leaf in iter_leaves(state["master"])]
    new_state, new_params, stats = adamw_update(
        state, tgrads, AdamWConfig(**cfg), lr_scale=torch.tensor(lr_scale))
    # the state's tensors are updated in place
    assert [leaf for _, leaf in iter_leaves(new_state["master"])] == masters
    assert new_state["step"].dtype == torch.int32 and int(new_state["step"]) == step + 1
    for part in ("master", "m", "v"):
        want = {tuple(k.key for k in p): a
                for p, a in jax.tree_util.tree_flatten_with_path(want_state[part])[0]}
        for path, leaf in iter_leaves(new_state[part]):
            _close(leaf, want[path])
    want = {tuple(k.key for k in p): a
            for p, a in jax.tree_util.tree_flatten_with_path(want_params)[0]}
    for path, leaf in iter_leaves(new_params):
        assert leaf.dtype == torch.bfloat16
        # one bf16 ulp where the float32 masters round differently
        _close(leaf, np.asarray(want[path], np.float32), tol=2 ** -8)
    _close(stats["grad_norm"], want_stats["grad_norm"])
    _close(stats["lr"], want_stats["lr"])


def params_leaf(tree, path):
    for name in path:
        tree = tree[name]
    return tree


def test_adamw_init_and_global_norm_match_the_reference():
    rng = np.random.default_rng(0)
    params = _tree(rng)
    ref = ref_adamw_init(jax.tree.map(jnp.asarray, params))
    ours = adamw_init(jax.tree.map(torch.from_numpy, params))
    assert ours["step"].dtype == torch.int32 and ours["step"].shape == ()
    for (path, a), b in zip(iter_leaves(ours["master"]), jax.tree.leaves(ref["master"])):
        assert a.dtype == torch.float32 and np.array_equal(a.numpy(), np.asarray(b))
        assert a.data_ptr() != params_leaf(params, path).ctypes.data   # a copy
    assert all(float(x.abs().sum()) == 0 for _, x in iter_leaves(ours["m"]))
    _close(global_norm(jax.tree.map(torch.from_numpy, params)),
           ref_global_norm(jax.tree.map(jnp.asarray, params)))


def test_adamw_decreases_quadratic():
    w = torch.tensor([3.0, -2.0])
    state = adamw_init({"w": w})
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    p = {"w": w}
    for _ in range(200):
        state, p, _ = adamw_update(state, {"w": 2 * p["w"]}, cfg, compute_dtype=torch.float32)
    assert float((p["w"] ** 2).sum()) < 1e-3


def test_adamw_grad_clip_applies():
    state = adamw_init({"w": torch.ones(4)})
    huge = {"w": torch.full((4,), 1e6)}
    _, _, stats = adamw_update(state, huge, AdamWConfig(lr=1e-3, grad_clip=1.0))
    assert float(stats["grad_norm"]) == pytest.approx(2e6, rel=1e-3)
    clipped, norm = clip_by_global_norm(huge, 1.0)
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-6)
    assert float(norm) == pytest.approx(2e6, rel=1e-3)


@pytest.mark.parametrize("name", sorted(SCHEDULES))
@pytest.mark.parametrize("warmup,total", [(0, 10), (2, 20), (10, 100), (7, 7)])
def test_schedules_match_the_reference_at_every_step(name, warmup, total):
    for step in range(total + 1):
        want = float(REF_SCHEDULES[name](step, warmup_steps=warmup, total_steps=total))
        got = SCHEDULES[name](torch.tensor(step, dtype=torch.int32), warmup_steps=warmup,
                              total_steps=total)
        assert got.dtype == torch.float32 and got.shape == ()
        assert abs(float(got) - want) <= 1e-6, (step, float(got), want)


def test_schedule_shapes():
    s0 = float(warmup_cosine(0, warmup_steps=10, total_steps=100))
    s10 = float(warmup_cosine(10, warmup_steps=10, total_steps=100))
    s100 = float(warmup_cosine(100, warmup_steps=10, total_steps=100))
    assert s0 == 0.0 and s10 == pytest.approx(1.0) and s100 == pytest.approx(0.1)
