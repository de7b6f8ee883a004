"""Algorithm 1 as one collective (``distributed_rsp_partition`` and the
``collective`` partition backend) over gloo groups of 2 and 4 CPU
processes.

Rank k's RSP block must equal block k of the ``cuda`` backend's partition
(its plain version on the CPU) bit for bit, through the function and
through ``rsp.partition(..., mesh=)`` with a ``ProcessGroup`` and a
``DeviceMesh``; the blocks must partition the corpus (Definition 2); and
the refusals hold: P != K != D, N not divisible by D^2, a group that is not
gloo.  The reference's ``shard_map`` partition of the same corpus on a
forced 4-device CPU mesh draws other permutations (threefry), so the two
are held to Definition 2 and Lemma 1 side by side: every block of each is
a partition member whose label share and column-0 distribution match the
class-sorted corpus's.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch import rsp
from repro_torch.core import is_partition
from repro_torch.core.similarity import max_label_divergence
from repro_torch.distributed import serve_store
from test_torch_mesh import assert_ok, gloo_init, marked, run_children

N, F, SEED = 6400, 29, 7

CHILD = r"""
import hashlib, json, os
import numpy as np
import torch
import torch.distributed as dist
from repro_torch import rsp
from repro_torch.core import distributed_rsp_partition
from repro_torch.data import make_nonrandom_higgs_like
from repro_torch.rsp.backends import PartitionRequest, backend_eligibility

N, SEED = %(N)d, %(SEED)d
rank, d = int(os.environ["RSP_PROCESS_ID"]), int(os.environ["RSP_NUM_PROCESSES"])
%(GLOO_INIT)s
x, y = make_nonrandom_higgs_like(N, seed=1)
data = np.concatenate([x, y[:, None].astype(np.float32)], axis=1)
want = rsp.partition(data, blocks=d, original_blocks=d, backend="cuda", seed=SEED,
                     summaries=False, device="cpu").stacked()
n = N // d
mine = distributed_rsp_partition(torch.from_numpy(data[rank * n:(rank + 1) * n].copy()), SEED)
assert torch.equal(mine, want[rank]), "rank %%d's block differs from the cuda backend's" %% rank
np.save(os.path.join(os.environ["RSP_OUT"], "block_%%d.npy" %% rank), mine.numpy())

by_group = rsp.partition(data, blocks=d, seed=SEED, mesh=dist.group.WORLD, summaries=False,
                         device="cpu")
assert by_group.backend == "collective" and torch.equal(by_group.stacked(), want)
from torch.distributed.device_mesh import init_device_mesh
mesh = init_device_mesh("cpu", (d,), mesh_dim_names=("data",))
by_mesh = rsp.partition(data, blocks=d, seed=SEED, mesh=mesh, mesh_axis="data",
                        backend="collective", device="cpu")
assert by_mesh.backend == "collective" and torch.equal(by_mesh.stacked(), want)
assert by_mesh.has_summaries and len(by_mesh.summaries) == d

refusals = {}
try:
    rsp.partition(data, blocks=2 * d, seed=SEED, mesh=mesh, backend="collective", device="cpu")
except ValueError as e:
    refusals["p_k_d"] = str(e)
try:
    distributed_rsp_partition(torch.zeros((n + 1, 29)), SEED)
except ValueError as e:
    refusals["n_d2"] = str(e)
try:
    rsp.partition(data, blocks=d, seed=SEED, mesh=mesh, mesh_axis="model", backend="collective",
                  device="cpu")
except ValueError as e:
    refusals["axis"] = str(e)
real_get_backend = dist.get_backend
dist.get_backend = lambda group=None: "nccl"
try:
    distributed_rsp_partition(torch.from_numpy(data[:n].copy()), SEED)
except ValueError as e:
    refusals["nccl"] = str(e)
req = PartitionRequest(data=data, spec=by_mesh.spec,
                       device=torch.device("cpu"), mesh=mesh)
refusals["nccl_backend"] = backend_eligibility(req)["collective"]
dist.get_backend = real_get_backend
print("RESULT " + json.dumps({"sha": hashlib.sha256(mine.numpy().tobytes()).hexdigest(),
                              "refusals": refusals}), flush=True)
dist.barrier()
dist.destroy_process_group()
print("PARTITION_OK", flush=True)
""" % {"N": N, "SEED": SEED, "GLOO_INIT": gloo_init()}

REFERENCE = r"""
import os
import jax, jax.numpy as jnp, numpy as np
from repro.core import distributed_rsp_partition
from repro.data import make_nonrandom_higgs_like

mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(4), ("data",))
x, y = make_nonrandom_higgs_like(%(N)d, seed=1)
data = np.concatenate([x, y[:, None].astype(np.float32)], axis=1)
out = np.asarray(distributed_rsp_partition(jnp.asarray(data), jax.random.PRNGKey(%(SEED)d), mesh,
                                           axis="data"))
np.save(os.path.join(os.environ["RSP_OUT"], "reference.npy"), out)
print("REFERENCE_OK", flush=True)
""" % {"N": N, "SEED": SEED}


def _corpus():
    from repro_torch.data import make_nonrandom_higgs_like

    x, y = make_nonrandom_higgs_like(N, seed=1)
    return np.concatenate([x, y[:, None].astype(np.float32)], axis=1)


def _collective(d: int, out: str):
    server = serve_store()
    children = run_children(CHILD, d, env={"RSP_STORE": f"127.0.0.1:{server.port}",
                                           "RSP_OUT": out})
    assert_ok(children, "PARTITION_OK")
    return [marked(c, "RESULT ") for c in children]


@pytest.mark.parametrize("d", [2, 4])
def test_collective_partition_equals_the_cuda_backend(tmp_path, d):
    results = _collective(d, str(tmp_path))
    data = _corpus()
    want = rsp.partition(data, blocks=d, original_blocks=d, backend="cuda", seed=SEED,
                         summaries=False, device="cpu").stacked().numpy()
    got = np.stack([np.load(tmp_path / f"block_{k}.npy") for k in range(d)])
    np.testing.assert_array_equal(got, want)
    assert is_partition(got, data)
    assert len({r["sha"] for r in results}) == d
    for r in results:
        ref = r["refusals"]
        assert "P = K = mesh size" in ref["p_k_d"]
        assert f"divisible by D^2={d * d}" in ref["n_d2"]
        assert "no dimension 'model'" in ref["axis"]
        assert "gloo" in ref["nccl"] and "'nccl'" in ref["nccl"]
        assert "gloo" in ref["nccl_backend"]


def _ks(a: np.ndarray, b: np.ndarray) -> float:
    grid = np.sort(b)
    fa = np.searchsorted(np.sort(a), grid, side="right") / a.size
    fb = np.arange(1, b.size + 1) / b.size
    return float(np.max(np.abs(fa - fb)))


def test_reference_shard_map_and_port_agree_by_definition_2_and_lemma_1(tmp_path):
    ref_run = run_children(REFERENCE, 1, env={
        "RSP_OUT": str(tmp_path), "JAX_PLATFORMS": "cpu",
        "XLA_FLAGS": "--xla_force_host_platform_device_count=4"}, timeout=120.0)
    assert_ok(ref_run, "REFERENCE_OK")
    _collective(4, str(tmp_path))
    data = _corpus()
    ref = np.load(tmp_path / "reference.npy")
    port = np.stack([np.load(tmp_path / f"block_{k}.npy") for k in range(4)])
    assert ref.shape == port.shape == (4, N // 4, F)
    assert is_partition(ref, data) and is_partition(port, data)
    assert not np.array_equal(ref, port)  # other streams, same statistical object
    # Lemma 1: each block is a random sample of the class-sorted corpus.
    # DKW at 1e-6: P(sup |F_n - F| > eps) <= 2 exp(-2 n eps^2)
    eps = float(np.sqrt(np.log(2 / 1e-6) / (2 * (N // 4))))
    for blocks in (ref, port):
        for k in range(4):
            assert max_label_divergence(blocks[k][:, -1], data[:, -1], 2) < 0.06
            assert _ks(blocks[k][:, 0], data[:, 0]) < eps


def test_collective_backend_refuses_without_a_mesh():
    data = _corpus()
    with pytest.raises(ValueError, match="requires a device mesh"):
        rsp.partition(data, blocks=4, backend="collective", device="cpu")
    reasons = rsp.backend_eligibility(rsp.PartitionRequest(
        data=data, spec=rsp.RSPSpec(N, 4, 4, (F,)), device=torch.device("cpu")))
    assert "requires a device mesh" in reasons["collective"]
    assert rsp.partition(data, blocks=4, seed=SEED, device="cpu").backend == "np"
