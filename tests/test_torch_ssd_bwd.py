"""The port's Mamba2 SSD backward (``kernels/mamba2_ssd/ref.py::
ssd_chunked_bwd``, the algebra the CUDA backward kernels compute) against
``jax.grad`` of the reference's chunked form (``repro/models/mamba2.py::
ssd_chunked``), on the CPU.

The same inputs, drawn from a numpy seed, go through both.  The loss is
``sum(y * dy) + sum(h_final * dh)`` with dh zero (training) or not.

Tolerance: relative L2 1e-5 for every gradient, at float32 (observed: at
most 5e-7).  Lengths that are not a multiple of the chunk (padded with
zero steps), shorter than the chunk, and weak and strong decays are among
the cases.  The reference's float32 ddA loses bits to cancellation at
strong decays (its gradient through ``exp(cum_t - cum_s)`` adds and
subtracts the undecayed diagonal terms: 1.1e-5 from a float64 recurrence
at -3 to -5 a step, where the port's is 8e-8), and at -30 a step it is NaN
(the masked ``exp`` overflows above the diagonal, and ``where``'s gradient
multiplies the overflow by 0).  There ddA is held to a float64 recurrence
through torch's autograd, the other three gradients to the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.mamba2 import ssd_chunked as ref_ssd_chunked
from repro_torch.kernels.mamba2_ssd import SSDScan, ssd, ssd_chunked, ssd_chunked_bwd

REL_L2 = 1e-5

CASES = {
    # name: B, L, H, P, N, chunk, decay
    "ragged length": (2, 37, 3, 8, 4, 16, "softplus"),
    "shorter than the chunk": (1, 9, 2, 8, 4, 16, "softplus"),
    "two full chunks": (2, 32, 2, 16, 8, 16, "softplus"),
    "chunk 8": (1, 40, 2, 8, 4, 8, "softplus"),
    "weak decay": (1, 64, 2, 8, 4, 16, "weak"),
    "strong decay": (2, 48, 3, 8, 4, 16, "strong"),
}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _inputs(B, L, H, P, N, decay, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    if decay == "weak":
        dA = rng.uniform(-1e-3, 0.0, size=(B, L, H))
    elif decay == "strong":
        dA = rng.uniform(-5.0, -3.0, size=(B, L, H))
    elif decay == "very strong":
        dA = np.full((B, L, H), -30.0)
    else:                     # the model's dt * a: softplus of a normal times -1
        dA = -np.log1p(np.exp(rng.normal(size=(B, L, H))))
    Bm, Cm = (rng.normal(size=(B, L, N)).astype(np.float32) for _ in range(2))
    dy = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dh = rng.normal(size=(B, H, P, N)).astype(np.float32)
    return x, dA.astype(np.float32), Bm, Cm, dy, dh


def _plain_grads(x, dA, Bm, Cm, dy, dh, chunk):
    args = [torch.from_numpy(a) for a in (x, dA, Bm, Cm)]
    _, _, hs = ssd_chunked(*args, chunk=chunk, states=True)
    return ssd_chunked_bwd(*args, hs, torch.from_numpy(dy), chunk=chunk,
                           dh_final=None if dh is None else torch.from_numpy(dh))


@pytest.mark.parametrize("final", [False, True], ids=["dh 0", "dh"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_jax_grad_of_the_reference(name, final):
    B, L, H, P, N, chunk, decay = CASES[name]
    x, dA, Bm, Cm, dy, dh = _inputs(B, L, H, P, N, decay, seed=L + P)
    if not final:
        dh = np.zeros_like(dh)

    def loss(x, dA, Bm, Cm):
        y, h = ref_ssd_chunked(x, dA, Bm, Cm, chunk=chunk)
        return jnp.sum(y * dy) + jnp.sum(h * dh)

    want = list(jax.grad(loss, argnums=(0, 1, 2, 3))(x, dA, Bm, Cm))
    if decay == "strong":     # the reference's ddA loses bits there (see above)
        want[1] = _recurrence64_grads(x, dA, Bm, Cm, dy, dh)[1]
    got = _plain_grads(x, dA, Bm, Cm, dy, dh if final else None, chunk)
    for i, (g, wnt) in enumerate(zip(got, want)):
        assert g.shape == wnt.shape, i
        assert _rel(g.numpy(), wnt) < REL_L2, (i, _rel(g.numpy(), wnt))


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_backward_matches_autograd_through_the_plain_forward(name):
    B, L, H, P, N, chunk, decay = CASES[name]
    x, dA, Bm, Cm, dy, dh = _inputs(B, L, H, P, N, decay, seed=L + 2 * P)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, dA, Bm, Cm)]
    y, h = ssd_chunked(*leaves, chunk=chunk)
    ((y * torch.from_numpy(dy)).sum() + (h * torch.from_numpy(dh)).sum()).backward()
    got = _plain_grads(x, dA, Bm, Cm, dy, dh, chunk)
    for i, (g, t) in enumerate(zip(got, leaves)):
        assert _rel(g.numpy(), t.grad.numpy()) < REL_L2, i


def _recurrence64_grads(x, dA, Bm, Cm, dy, dh):
    leaves = [torch.from_numpy(a).double().requires_grad_() for a in (x, dA, Bm, Cm)]
    xx, aa, bb, cc = leaves
    B, L, H, P = x.shape
    h = torch.zeros((B, H, P, Bm.shape[-1]), dtype=torch.float64)
    ys = []
    for t in range(L):
        h = h * torch.exp(aa[:, t])[:, :, None, None] + torch.einsum("bhp,bn->bhpn", xx[:, t],
                                                                     bb[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", h, cc[:, t]))
    loss = (torch.stack(ys, 1) * torch.from_numpy(dy).double()).sum() \
        + (h * torch.from_numpy(dh).double()).sum()
    loss.backward()
    return [t.grad.numpy() for t in leaves]


def test_a_very_strong_decay_against_a_float64_recurrence():
    x, dA, Bm, Cm, dy, dh = _inputs(2, 48, 3, 8, 4, "very strong", seed=7)

    def loss(x, dA, Bm, Cm):
        y, h = ref_ssd_chunked(x, dA, Bm, Cm, chunk=16)
        return jnp.sum(y * dy) + jnp.sum(h * dh)

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(x, dA, Bm, Cm)
    assert not np.isfinite(np.asarray(ref[1])).all()     # the reference's ddA
    want = _recurrence64_grads(x, dA, Bm, Cm, dy, dh)
    got = _plain_grads(x, dA, Bm, Cm, dy, dh, 16)
    for i, g in enumerate(got):
        assert _rel(g.numpy(), want[i]) < REL_L2, i
        if i != 1:
            assert _rel(g.numpy(), ref[i]) < REL_L2, i


@pytest.mark.parametrize("L", [37, 16])
def test_the_function_matches_the_reference_through_ops_ssd(L):
    x, dA, Bm, Cm, dy, dh = _inputs(2, L, 2, 8, 4, "softplus", seed=L)

    def loss(x, dA, Bm, Cm):
        y, h = ref_ssd_chunked(x, dA, Bm, Cm, chunk=16)
        return jnp.sum(y * dy) + jnp.sum(h * dh)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(x, dA, Bm, Cm)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, dA, Bm, Cm)]
    y, h = ssd(*leaves, chunk=16, impl="torch")
    assert type(y.grad_fn).__name__ == "SSDScanBackward"
    ((y * torch.from_numpy(dy)).sum() + (h * torch.from_numpy(dh)).sum()).backward()
    for i, (t, wnt) in enumerate(zip(leaves, want)):
        assert _rel(t.grad.numpy(), wnt) < REL_L2, i


def test_the_function_saves_no_more_than_its_inputs_and_states():
    x, dA, Bm, Cm, _, _ = _inputs(1, 32, 2, 8, 4, "softplus", seed=0)
    args = [torch.from_numpy(a) for a in (x, dA, Bm, Cm)]
    args[0].requires_grad_()
    y, h = SSDScan.apply(*args, None, 16, "torch")
    saved = y.grad_fn.saved_tensors
    assert len(saved) == 5 and tuple(saved[-1].shape) == (1, 2, 2, 8, 4)
