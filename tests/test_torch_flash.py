"""The port's flash attention (its plain version, on the CPU) against the
reference's Pallas kernel in interpret mode and its jnp oracle, on the same
numpy inputs.

Tolerances are the reference's own for its kernel (``tests/test_kernels.py``):
2e-5 in float32 (both sides sum in float32, in another order) and 2e-2 in
bfloat16 (the output is rounded to bf16 once, on both sides; a value may
land on the other side of a rounding edge).  The CUDA kernel runs only on a
card: its tests are in ``test_torch_cuda.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as ref_ops
from repro.kernels.flash_attention.ref import flash_attention_ref as ref_oracle
from repro_torch import kernels
from repro_torch.kernels.flash_attention import (
    flash_attention,
    flash_attention_plain,
    flash_attention_ref,
)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, q_shape, kv_shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=q_shape).astype(np.float32),
            rng.normal(size=kv_shape).astype(np.float32),
            rng.normal(size=kv_shape).astype(np.float32))


def _both(arrays, dtype):
    jd, td, _ = DTYPES[dtype]
    return ([jnp.asarray(a).astype(jd) for a in arrays],
            [torch.from_numpy(a).to(td) for a in arrays])


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.to(torch.float32).numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


# the reference's sweep (tests/test_kernels.py::test_flash_sweep)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize(
    "B,H,Hkv,S,D,bq,bk",
    [
        (1, 4, 2, 64, 16, 16, 16),
        (2, 2, 2, 32, 32, 8, 16),   # MHA, uneven blocks
        (1, 8, 1, 48, 8, 16, 16),   # MQA, S not power of two
        (1, 2, 2, 128, 64, 128, 128),  # single block pair
    ],
)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_sweep_matches_pallas_and_oracle(dtype, B, H, Hkv, S, D, bq, bk, causal):
    arrays = _inputs(B * 1000 + S, (B, H, S, D), (B, Hkv, S, D))
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, dtype)
    tol = DTYPES[dtype][2]
    got = flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == (B, H, S, D)
    pallas = ref_ops.flash_attention(jq, jk, jv, causal=causal, block_q=bq, block_k=bk)
    _close(got, pallas, tol)
    _close(got, ref_oracle(jq, jk, jv, causal=causal), tol)


def test_flash_grouped_layout_matches_pallas():
    """The model's [B, Hkv, G, S, D] layout, as the reference's wrapper takes it."""
    B, Hkv, G, S, D = 1, 2, 3, 32, 16
    arrays = _inputs(1, (B, Hkv, G, S, D), (B, Hkv, S, D))
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "float32")
    got = flash_attention(tq, tk, tv, causal=True)
    assert got.shape == (B, Hkv, G, S, D)
    _close(got, ref_ops.flash_attention(jq, jk, jv, causal=True, block_q=8, block_k=8), 2e-5)
    flat = flash_attention(tq.reshape(B, Hkv * G, S, D), tk, tv, causal=True)
    assert torch.equal(got.reshape(B, Hkv * G, S, D), flat)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,Hkv", [(14, 2), (48, 1)])
def test_flash_ragged_sequence_and_wide_groups(H, Hkv, causal):
    """Any S (the port masks the ragged edge; the reference's wrapper needs a
    block that divides S) and the G of qwen2-0.5b (7) and granite-20b (48):
    against the reference's oracle."""
    S, D = 37, 16
    arrays = _inputs(H + S, (1, H, S, D), (1, Hkv, S, D))
    (jq, jk, jv), (tq, tk, tv) = _both(arrays, "float32")
    _close(flash_attention(tq, tk, tv, causal=causal), ref_oracle(jq, jk, jv, causal=causal),
           2e-5)


def test_flash_plain_version_is_the_ref_and_counts_nothing():
    arrays = _inputs(3, (2, 4, 20, 16), (2, 2, 20, 16))
    tq, tk, tv = (torch.from_numpy(a) for a in arrays)
    kernels.reset_launch_counts()
    got = flash_attention(tq, tk, tv, causal=True, impl="torch")
    assert flash_attention_plain is flash_attention_ref
    assert torch.equal(got, flash_attention_ref(tq, tk, tv, causal=True))
    assert torch.equal(got, flash_attention(tq, tk, tv, causal=True))   # auto on the host
    assert kernels.launch_counts()["flash_attention"] == 0
    with pytest.raises(ValueError, match="unknown impl"):
        flash_attention(tq, tk, tv, impl="pallas")
