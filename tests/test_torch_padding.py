"""The padding that lets ``impl="auto"`` take the smoke configs' widths to the
card's kernels, checked on the CPU with the plain versions in the kernels'
place.

On a CUDA tensor ``auto`` zero-pads flash's head dim D up to the next width
the kernel takes (64, 80, 112, 128), the SSD's P and N up to 64, and the WKV's
C up to 64, runs the kernel and cuts the result back.  Here each public
padding helper (``ops.run_padded``) is handed the plain version instead of
the kernel, on seeded numpy inputs: the result must equal the unpadded
plain version within 1e-6 (float32 sums over the same terms, the padded
ones exact zeros), and the padded rows and columns of the state and the
output must be exactly zero.  The SSD also runs at the kernel's chunk of
128 where the smoke config asks for 8, against the plain version at 8
within the kernel's own 2e-4 (1 + |b|): the chunk only blocks the sums.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.mamba2_ssd import CHUNK as SSD_CHUNK
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
from repro_torch.kernels.mamba2_ssd import ssd_plain
from repro_torch.kernels.rwkv6_wkv import log_decay, wkv6_plain
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops

PAD_TOL = 1e-6
SSD_TOL = 2e-4


def _close(got, want, tol):
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


class Capture:
    """A plain version in a kernel's place that keeps what it returned
    before the wrapper cut it back."""

    def __init__(self, fn, **kw):
        self.fn, self.kw, self.out = fn, kw, None

    def __call__(self, *args, **kw):
        self.out = self.fn(*args, **self.kw, **kw)
        return self.out


@pytest.mark.parametrize("D,Dp", [(16, 64), (80, 80), (120, 128), (64, 64), (72, 80),
                                  (96, 112)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_padding_is_exact(D, Dp, causal):
    assert fa_ops.padded_head_dim(D) == Dp
    rng = np.random.default_rng(D)
    B, H, Hkv, S = 2, 4, 2, 37
    q, k, v = (torch.from_numpy(rng.normal(size=(B, h, S, D)).astype(np.float32))
               for h in (H, Hkv, Hkv))
    run = Capture(flash_attention_plain)
    got = fa_ops.run_padded(run, q, k, v, causal=causal)
    want = flash_attention_plain(q, k, v, causal=causal)
    assert got.shape == want.shape == (B, H, S, D)
    assert run.out.shape == (B, H, S, Dp)
    _close(got, want, PAD_TOL)
    assert bool((run.out[..., D:] == 0).all())


def test_flash_padding_leaves_the_widest_width_to_the_kernel():
    # above 128 there is nothing to pad to: the kernel sees D as it is
    assert fa_ops.padded_head_dim(160) == 160
    assert fa_ops.padded_head_dim(128) == 128


def _ssd_arrays(seed, B, L, H, P, N, with_h0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dA = -np.log1p(np.exp(rng.normal(size=(B, L, H)))).astype(np.float32)
    Bm, Cm = (rng.normal(size=(B, L, N)).astype(np.float32) for _ in range(2))
    h0 = rng.normal(size=(B, H, P, N)).astype(np.float32) if with_h0 else None
    return [torch.from_numpy(a) for a in (x, dA, Bm, Cm)], (
        None if h0 is None else torch.from_numpy(h0))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("P,N,L", [(16, 16, 40), (16, 16, 8), (32, 8, 130)])
def test_ssd_padding_is_exact(P, N, L, with_h0):
    arrays, h0 = _ssd_arrays(P + N + L, 2, L, 3, P, N, with_h0)
    run = Capture(ssd_plain, chunk=8)     # the smoke config's chunk
    y, h = ssd_ops.run_padded(run, *arrays, h0=h0)
    want_y, want_h = ssd_plain(*arrays, chunk=8, h0=h0)
    assert y.shape == want_y.shape and h.shape == want_h.shape
    _close(y, want_y, PAD_TOL)
    _close(h, want_h, PAD_TOL)
    py, ph = run.out
    assert py.shape[-1] == 64 and ph.shape[-2:] == (64, 64)
    assert py.shape[1] % SSD_CHUNK == 0
    assert bool((py[..., P:] == 0).all())
    assert bool((ph[..., P:, :] == 0).all()) and bool((ph[..., :, N:] == 0).all())


@pytest.mark.parametrize("L", [40, 300])
def test_ssd_auto_chunk_is_the_kernels(L):
    # on the card, auto runs the kernel at its chunk of 128 whatever the
    # config's chunk: the plain version at 128 stands in for the kernel
    arrays, h0 = _ssd_arrays(L, 2, L, 3, 16, 16, True)
    y, h = ssd_ops.run_padded(Capture(ssd_plain, chunk=SSD_CHUNK), *arrays, h0=h0)
    want_y, want_h = ssd_plain(*arrays, chunk=8, h0=h0)
    for got, want in ((y, want_y), (h, want_h)):
        diff = (got - want).abs()
        assert not bool((diff > SSD_TOL * (1 + want.abs())).any()), float(diff.max())


def test_ssd_explicit_cuda_keeps_the_kernels_chunk():
    arrays, _ = _ssd_arrays(0, 1, 128, 2, 64, 64, False)
    with pytest.raises(ValueError, match="chunk 128"):
        ssd_ops.ssd(*arrays, chunk=64, impl="cuda")


def _wkv_arrays(seed, B, T, H, C, with_h0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(B, T, H, C)).astype(np.float32) for _ in range(3))
    w0 = 0.5 * rng.normal(size=(H, C))
    w = np.exp(-np.exp(w0 + 0.3 * rng.normal(size=(B, T, H, C)))).astype(np.float32)
    u = (0.5 * rng.normal(size=(H, C))).astype(np.float32)
    h0 = rng.normal(size=(B, H, C, C)).astype(np.float32) if with_h0 else None
    return [torch.from_numpy(a) for a in (r, k, v, w, u)], (
        None if h0 is None else torch.from_numpy(h0))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("C,T", [(16, 40), (16, 16), (8, 5)])
def test_wkv_padding_is_exact(C, T, with_h0):
    (r, k, v, w, u), h0 = _wkv_arrays(C + T, 2, T, 3, C, with_h0)
    logw = log_decay(w)
    run = Capture(wkv6_plain)
    y, h = wkv_ops.run_padded(run, r, k, v, logw, u, h0=h0)
    want_y, want_h = wkv6_plain(r, k, v, logw, u, h0=h0)
    assert y.shape == want_y.shape and h.shape == want_h.shape
    _close(y, want_y, PAD_TOL)
    _close(h, want_h, PAD_TOL)
    py, ph = run.out
    assert py.shape[-1] == 64 and ph.shape[-2:] == (64, 64)
    assert bool((py[..., C:] == 0).all())
    assert bool((ph[..., C:, :] == 0).all()) and bool((ph[..., :, C:] == 0).all())
