"""The port's flash-attention gradient against the reference's, op by op,
and the head dims the kernels' sources take.

``FlashAttention`` with ``impl="torch"`` (the plain forward with the
reference's statistics and ``flash_attention_bwd_plain``, the yardstick
the card's backward kernel is held to) is differentiated on the CPU and
held against ``jax.vjp`` of the reference's ``flash_flat_cvjp``
(``src/repro/models/attention.py``), whose backward is the custom VJP
``_flash_flat_cvjp_bwd``.  Both take the same numpy-seeded float32 q, k, v
and dout.  Grouped-query heads go to the reference as ``jnp.repeat`` of k
and v, so its vjp sums dk and dv over each group, as the port does.  Both
sides sum float32 terms in blocks of the same keys, in another order:
every gradient is held within FLOAT_TOL (1 + |b|).

The CUDA sources are read as text: the head dims ``HEAD_DIMS`` lists must
be the ones the forward's and the backward's launchers check, dispatch and
size shared memory for, and the backward's scratch must cover its kernels'
padded rows.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import flash_flat_cvjp
from repro_torch.kernels.flash_attention import HEAD_DIMS, FlashAttention

FLOAT_TOL = 2e-5
CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"


def _inputs(B, H, Hkv, S, D, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, h, S, D)).astype(np.float32) for h in (H, Hkv, Hkv))
    dout = rng.normal(size=(B, H, S, D)).astype(np.float32)
    return q, k, v, dout


def _reference(q, k, v, dout, causal, k_block):
    G = q.shape[1] // k.shape[1]

    def f(q, k, v):
        return flash_flat_cvjp(q, jnp.repeat(k, G, axis=1), jnp.repeat(v, G, axis=1), causal,
                               k_block)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(g) for g in vjp(jnp.asarray(dout))]


def _port(q, k, v, dout, causal, k_block):
    ins = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = FlashAttention.apply(*ins, causal, None, "torch", k_block)
    out.backward(torch.from_numpy(dout))
    return out.detach().numpy(), [t.grad.numpy() for t in ins]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(2, 4, 4, 48, 64), (1, 4, 4, 48, 80), (2, 6, 2, 32, 80),
                                   (1, 8, 2, 48, 64)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plain_backward_matches_the_reference_custom_vjp(shape, causal):
    B, H, Hkv, S, D = shape
    q, k, v, dout = _inputs(*shape, seed=S + D + H)
    k_block = 16
    want_out, want = _reference(q, k, v, dout, causal, k_block)
    got_out, got = _port(q, k, v, dout, causal, k_block)
    np.testing.assert_allclose(got_out, want_out, rtol=FLOAT_TOL, atol=FLOAT_TOL)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == b.shape, name
        bad = np.abs(a - b) > FLOAT_TOL * (1 + np.abs(b))
        assert not bad.any(), f"{name}: {int(bad.sum())} values beyond {FLOAT_TOL} (1 + |b|)," \
                              f" largest {np.abs(a - b).max():.3g}"


def test_a_backward_without_dvec_is_refused_by_the_tolerance():
    # the known-wrong control: the port's plain backward handed a zero
    # output, so Dvec = rowsum(dout * out) drops out of dS
    from repro_torch.kernels.flash_attention import flash_attention_bwd_plain, flash_attention_stats

    q, k, v, dout = _inputs(1, 4, 4, 48, 80, seed=9)
    _, want = _reference(q, k, v, dout, True, 16)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, dout))
    out, (m, l) = flash_attention_stats(tq, tk, tv, causal=True)
    got = flash_attention_bwd_plain(tq, tk, tv, torch.zeros_like(out), tg, m, l, causal=True,
                                    k_block=16)
    bad = np.abs(got[0].numpy() - want[0]) > FLOAT_TOL * (1 + np.abs(want[0]))
    assert bad.any()


def _function(src: str, name: str) -> str:
    start = src.index(f"int {name}(")
    return src[start:src.index("\n}\n", start)]


@pytest.mark.parametrize("source,launch,smem,templates", [
    ("flash_attention.cu", "flash_attention_launch", "flash_attention_smem_bytes",
     ("run_wgmma", "fa_fwd_f32")),
    ("flash_attention_bwd.cu", "flash_attention_bwd_launch", "flash_attention_bwd_smem_bytes",
     ("run_bwd",)),
])
def test_head_dims_agree_with_the_launchers(source, launch, smem, templates):
    src = (CSRC / source).read_text()
    body = _function(src, launch)
    checked = {int(d) for d in re.findall(r"D != (\d+)", body)}
    assert checked == set(HEAD_DIMS), (launch, checked)
    for name in templates:
        dispatched = {int(d) for d in re.findall(rf"{name}<(\d+)>", body)}
        assert dispatched == set(HEAD_DIMS), (name, dispatched)
    sized = _function(src, smem)
    for struct in set(re.findall(r"(\w+)<\d+>::kBytes", sized)):
        widths = {int(d) for d in re.findall(rf"{struct}<(\d+)>::kBytes", sized)}
        assert widths == set(HEAD_DIMS), (struct, widths)


def test_the_backward_scratch_covers_the_kernels_padded_rows():
    # the wrapper allocates the statistics the dQ kernel writes and the dK/dV
    # kernel reads, S rounded up to the kernel's kPadRows, a whole number of
    # both kernels' tiles
    from repro_torch.kernels.flash_attention import kernel

    src = (CSRC / "flash_attention_bwd.cu").read_text()
    pad = int(re.search(r"constexpr int kPadRows = (\d+);", src)[1])
    assert kernel.BWD_PAD_ROWS == pad
    # each kStep's rows (the values after ? and :), and a dQ CTA's 128
    steps = {128}
    for expr in re.findall(r"kStep = ([^;]*);", src):
        steps |= {int(n) for n in re.findall(r"(?:^|[?:] )(\d+)", expr)}
    assert steps >= {32, 48, 64, 128} and all(pad % n == 0 for n in steps), steps
