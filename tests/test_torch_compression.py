"""The port's int8 gradient compression against the reference's
``repro.distributed.compression``, on the CPU.

The quantizers are held bit for bit (padded tails, all-zero blocks, tiny and
large magnitudes included); ``compressed_psum`` over gloo groups of 2 and 4
processes is held bit for bit to the reference run under
``jax.vmap(..., axis_name="pod")``, whose ``pmax``/``psum`` reduce over the
mapped axis.  Both divide in float32 and round half to even, in the same
order.  The reference's own compression tests are ported.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import compression as ref
from repro_torch.distributed import serve_store
from repro_torch.distributed.compression import (
    compressed_psum,
    compression_ratio,
    dequantize_int8,
    error_feedback_compress,
    init_residual,
    quantize_int8,
    quantize_roundtrip,
)
from test_torch_mesh import assert_ok, gloo_init, marked, run_children


def _inputs(case: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    if case == "padded tail":
        return (rng.standard_normal(1000) * 5.0).astype(np.float32)
    if case == "zero blocks":
        x = rng.standard_normal((6, 256)).astype(np.float32)
        x[1] = 0.0
        x[4, :100] = 0.0
        return x
    if case == "magnitudes":
        x = rng.standard_normal((3, 300)).astype(np.float32)
        return x * np.array([1e-30, 1.0, 1e30], np.float32)[:, None]
    if case == "halves":
        # exact halves of the step: round half to even decides them
        x = np.arange(-127, 128, dtype=np.float32)[None].repeat(4, 0) * 0.5
        return x.reshape(-1)
    raise KeyError(case)


CASES = ["padded tail", "zero blocks", "magnitudes", "halves"]


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("case", CASES)
def test_quantizers_are_the_references_bits(case):
    x = _inputs(case)
    rq, rs, rpad = ref.quantize_int8(jnp.asarray(x))
    q, s, pad = quantize_int8(torch.from_numpy(x))
    assert pad == rpad
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(rq))
    assert np.array_equal(_bits(s.numpy()), _bits(rs))
    back = dequantize_int8(q, s, pad, x.shape)
    rback = ref.dequantize_int8(rq, rs, rpad, x.shape)
    assert np.array_equal(_bits(back.numpy()), _bits(rback))
    rt = quantize_roundtrip(torch.from_numpy(x))
    assert rt.shape == x.shape
    assert np.array_equal(_bits(rt.numpy()), _bits(ref.quantize_roundtrip(jnp.asarray(x))))


def test_error_feedback_is_the_references_bits():
    rng = np.random.default_rng(3)
    g = {"a": rng.standard_normal((4, 300)).astype(np.float32),
         "b": {"c": rng.standard_normal(77).astype(np.float32)}}
    r_ref = ref.init_residual(jax.tree.map(jnp.asarray, g))
    r = init_residual({"a": torch.zeros(4, 300), "b": {"c": torch.zeros(77)}})
    for i in range(3):
        gi = jax.tree.map(lambda a: a * (i + 1), g)
        comp_ref, r_ref = ref.error_feedback_compress(jax.tree.map(jnp.asarray, gi), r_ref)
        comp, r = error_feedback_compress(jax.tree.map(torch.from_numpy, gi), r)
        for got, want in ((comp["a"], comp_ref["a"]), (comp["b"]["c"], comp_ref["b"]["c"]),
                          (r["a"], r_ref["a"]), (r["b"]["c"], r_ref["b"]["c"])):
            assert np.array_equal(_bits(got.numpy()), _bits(want))


# the reference's tests/test_distributed.py, ported

def test_quantize_roundtrip_error_bounded():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0)) * 5.0
    y = quantize_roundtrip(x)
    err = (x - y).abs().max()
    assert float(err) <= float(x.abs().max()) / 127.0 + 1e-6


def test_error_feedback_is_unbiased_over_time():
    """With error feedback, the *accumulated* compressed signal tracks the
    accumulated true signal (residual stays bounded)."""
    gen = torch.Generator().manual_seed(1)
    g = {"w": torch.randn(512, generator=gen)}
    r = init_residual(g)
    total_true = torch.zeros(512)
    total_sent = torch.zeros(512)
    for _ in range(20):
        gi = {"w": torch.randn(512, generator=gen)}
        comp, r = error_feedback_compress(gi, r)
        total_true += gi["w"]
        total_sent += comp["w"]
    drift = (total_true - total_sent).abs().max()
    assert float(drift) <= float(total_true.abs().max()) / 100.0 + 0.1


def test_compression_ratio():
    assert compression_ratio(torch.float32) < 0.26
    assert compression_ratio(torch.bfloat16) < 0.52
    assert compression_ratio(torch.float32) == ref.compression_ratio(jnp.float32)
    assert compression_ratio(torch.bfloat16) == ref.compression_ratio(jnp.bfloat16)


# ---------------------------------------------------------------------------
# compressed_psum over gloo groups
# ---------------------------------------------------------------------------

PSUM_CHILD = r"""
import json, os
import numpy as np
import torch
import torch.distributed as dist
%(GLOO_INIT)s
from repro_torch.distributed.compression import compressed_psum

rank = dist.get_rank()
x = np.load(os.path.join(os.environ["RSP_OUT"], "x.npy"))[rank]
y = compressed_psum(torch.from_numpy(x))
np.save(os.path.join(os.environ["RSP_OUT"], f"y{rank}.npy"), y.numpy())
# a subgroup of ranks 0 and 1 reduces over itself alone
sub = dist.new_group([0, 1])
if rank < 2:
    z = compressed_psum(torch.from_numpy(x), sub)
    np.save(os.path.join(os.environ["RSP_OUT"], f"z{rank}.npy"), z.numpy())
print("RESULT " + json.dumps({"shape": list(y.shape), "dtype": str(y.dtype)}), flush=True)
dist.destroy_process_group()
print("PSUM_OK", flush=True)
""" % {"GLOO_INIT": gloo_init()}


def _ref_psum(x: np.ndarray) -> np.ndarray:
    return np.asarray(jax.vmap(lambda v: ref.compressed_psum(v, "pod"), axis_name="pod")(
        jnp.asarray(x)))


@pytest.mark.parametrize("ranks", [2, 4])
def test_compressed_psum_is_the_references_bits(ranks, tmp_path):
    rng = np.random.default_rng(ranks)
    x = (rng.standard_normal((ranks, 3, 700)) * np.array([1.0, 1e-3, 50.0])[:, None]
         ).astype(np.float32)
    x[:, 1, :256] = 0.0                      # a block that is zero on every rank
    np.save(tmp_path / "x.npy", x)
    server = serve_store()
    children = run_children(PSUM_CHILD, ranks, env={"RSP_STORE": f"127.0.0.1:{server.port}",
                                                    "RSP_OUT": str(tmp_path)})
    assert_ok(children, "PSUM_OK")
    assert all(marked(c, "RESULT ") == {"shape": [3, 700], "dtype": "torch.float32"}
               for c in children)
    want = _ref_psum(x)
    want_sub = _ref_psum(x[:2])
    for rank in range(ranks):
        got = np.load(tmp_path / f"y{rank}.npy")
        assert np.array_equal(_bits(got), _bits(want[rank])), rank
    for rank in range(2):
        assert np.array_equal(_bits(np.load(tmp_path / f"z{rank}.npy")), _bits(want_sub[rank]))
    # the mean it approximates
    mean = x.mean(axis=0)
    assert np.abs(want[0] - mean).max() <= np.abs(x).max() / 127.0 * ranks


def test_compressed_psum_of_one_rank_is_the_roundtrip(tmp_path):
    """A one-rank group: the mean of one is the quantize round trip."""
    import torch.distributed as dist

    x = torch.from_numpy(_inputs("padded tail"))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        y = compressed_psum(x)
    finally:
        dist.destroy_process_group()
    assert np.array_equal(_bits(y.numpy()), _bits(quantize_roundtrip(x).numpy()))
    assert json.dumps(list(y.shape)) == json.dumps(list(x.shape))
