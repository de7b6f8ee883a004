"""The port's WKV6 backward (``kernels/rwkv6_wkv/ref.py::wkv6_chunked_bwd``,
the algebra the CUDA backward kernel computes) against ``jax.grad`` of the
reference's recurrence (``repro/models/rwkv6.py::wkv6_scan``), on the CPU.

The same inputs, drawn from a numpy seed, go through both.  The loss is
``sum(y * dy) + sum(h_final * dh)`` with dh zero (training) or not.  The
port's log-decay gradient is held to ``w * dL/dw`` of the reference.

Tolerance: relative L2 1e-5 for every gradient, at float32 (observed: at
most 3e-7; both sides sum float32 terms in another order).  Lengths that
are not a multiple of the chunk (padded with identity steps), shorter than
the chunk, and decays near the reference wrapper's 1e-38 floor are among
the cases.  Through ``ops.wkv6`` (the ``WKV6`` function), the gradient by
the decay's pre-activation ``x`` in ``w = exp(-exp(x))`` is held to the
reference's where w underflows to 0 too: both are 0 there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rwkv6 import wkv6_scan as ref_wkv6_scan
from repro_torch.kernels.rwkv6_wkv import (
    BWD_GROUP,
    WKV6,
    bwd_groups,
    log_decay,
    wkv6,
    wkv6_chunked,
    wkv6_chunked_bwd,
)

REL_L2 = 1e-5

CASES = {
    # name: B, T, H, C, chunk, decay
    "ragged length": (2, 37, 3, 8, 16, "model"),
    "shorter than the chunk": (1, 9, 2, 8, 16, "model"),
    "two full chunks": (2, 32, 2, 16, 16, "model"),
    "chunk 8": (1, 40, 2, 8, 8, "model"),
    "weak decay": (1, 64, 2, 8, 16, "weak"),
    "near the floor": (2, 48, 3, 8, 16, "floor"),
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _inputs(B, T, H, C, decay, seed):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, T, H, C)).astype(np.float32) for _ in range(3))
    if decay == "weak":
        w = rng.uniform(0.999, 1.0, size=(B, T, H, C))
    elif decay == "floor":      # 30% between 10^-37.5 and 10^-30, normal floats
        w = np.where(rng.random((B, T, H, C)) < 0.3,
                     10.0 ** rng.uniform(-37.5, -30.0, size=(B, T, H, C)),
                     np.exp(-np.exp(0.5 * rng.normal(size=(B, T, H, C)))))
    else:                       # the model's exp(-exp(w0 + lora)), w0 ~ N(0, 0.5)
        w = np.exp(-np.exp(0.5 * rng.normal(size=(B, T, H, C))))
    u = rng.normal(size=(H, C)).astype(np.float32)
    dy = rng.normal(size=(B, T, H, C)).astype(np.float32)
    dh = rng.normal(size=(B, H, C, C)).astype(np.float32)
    return r, k, v, w.astype(np.float32), u, dy, dh


def _reference_grads(r, k, v, w, u, dy, dh):
    def loss(r, k, v, w, u):
        y, h = ref_wkv6_scan(r, k, v, w, u)
        return jnp.sum(y * dy) + jnp.sum(h * dh)

    grads = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2, 3, 4))(r, k, v, w, u)]
    grads[3] = grads[3] * w          # dL/dlogw = w dL/dw
    return grads


def _plain_grads(r, k, v, w, u, dy, dh, chunk):
    r, k, v, u, dy = (torch.from_numpy(a) for a in (r, k, v, u, dy))
    logw = log_decay(torch.from_numpy(w))
    _, _, hs = wkv6_chunked(r, k, v, logw, u, chunk=chunk, states=True)
    return wkv6_chunked_bwd(r, k, v, logw, u, hs, dy, chunk=chunk,
                            dh_final=None if dh is None else torch.from_numpy(dh))


@pytest.mark.parametrize("final", [False, True], ids=["dh 0", "dh"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_grad_of_the_reference(name, final):
    B, T, H, C, chunk, decay = CASES[name]
    r, k, v, w, u, dy, dh = _inputs(B, T, H, C, decay, seed=T + C)
    if not final:
        dh = np.zeros_like(dh)
    want = _reference_grads(r, k, v, w, u, dy, dh)
    got = _plain_grads(r, k, v, w, u, dy, dh if final else None, chunk)
    for i, (g, wnt) in enumerate(zip(got, want)):
        assert g.shape == wnt.shape, i
        assert _rel(g.numpy(), wnt) < REL_L2, (i, _rel(g.numpy(), wnt))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_autograd_through_the_plain_forward(name):
    B, T, H, C, chunk, decay = CASES[name]
    r, k, v, w, u, dy, dh = _inputs(B, T, H, C, decay, seed=T + 2 * C)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (r, k, v)]
    logw = log_decay(torch.from_numpy(w)).requires_grad_()
    uu = torch.from_numpy(u).requires_grad_()
    y, h = wkv6_chunked(*leaves, logw, uu, chunk=chunk)
    ((y * torch.from_numpy(dy)).sum() + (h * torch.from_numpy(dh)).sum()).backward()
    got = _plain_grads(r, k, v, w, u, dy, dh, chunk)
    for i, (g, t) in enumerate(zip(got, [*leaves, logw, uu])):
        assert _rel(g.numpy(), t.grad.numpy()) < REL_L2, i


@pytest.mark.parametrize("T", [37, 16])
def test_the_function_matches_the_reference_through_the_decay_and_its_underflow(T):
    # w = exp(-exp(x)): x = 5 underflows w to 0 in float32 (exp(-148)); the
    # clamp's gradient and the reference's are then both 0
    B, H, C = 2, 2, 8
    rng = np.random.default_rng(T)
    r, k, v = (rng.normal(size=(B, T, H, C)).astype(np.float32) for _ in range(3))
    x = np.where(rng.random((B, T, H, C)) < 0.25, 5.0,
                 0.5 * rng.normal(size=(B, T, H, C))).astype(np.float32)
    u = rng.normal(size=(H, C)).astype(np.float32)
    dy = rng.normal(size=(B, T, H, C)).astype(np.float32)

    def loss(r, k, v, x, u):
        return jnp.sum(ref_wkv6_scan(r, k, v, jnp.exp(-jnp.exp(x)), u)[0] * dy)

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(r, k, v, x, u)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (r, k, v, x, u)]
    rr, kk, vv, xx, uu = leaves
    y, _ = wkv6(rr, kk, vv, torch.exp(-torch.exp(xx)), uu, impl="torch")
    assert y.grad_fn is not None and type(y.grad_fn).__name__ == "WKV6Backward"
    (y * torch.from_numpy(dy)).sum().backward()
    for i, (t, wnt) in enumerate(zip(leaves, want)):
        assert _rel(t.grad.numpy(), wnt) < REL_L2, i
    under = x == 5.0
    assert np.all(np.asarray(want[3])[under] == 0) and np.all(xx.grad.numpy()[under] == 0)


def test_the_function_saves_no_more_than_its_inputs_and_states():
    r, k, v, w, u, _, _ = _inputs(1, 32, 2, 8, "model", seed=0)
    args = [torch.from_numpy(a) for a in (r, k, v)]
    logw = log_decay(torch.from_numpy(w)).requires_grad_()
    y, h = WKV6.apply(*args, logw, torch.from_numpy(u), None, "torch")
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 6 and tuple(saved[-1].shape) == (1, 2, 2, 8, 8)


@pytest.mark.parametrize("T,want", [(2048, 16), (1024, 8), (144, 2), (128, 1), (16, 1)])
def test_the_backward_chunk_groups_cover_every_chunk_once(T, want):
    # wkv6_bwd_chunk's grid: a CTA per (batch row, group of BWD_GROUP
    # chunks, head), the last group ragged; du comes back a share a group
    groups = bwd_groups(T)
    assert groups == want
    chunks = T // 16
    assert (groups - 1) * BWD_GROUP < chunks <= groups * BWD_GROUP
