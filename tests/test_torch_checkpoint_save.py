"""The port's checkpoint writer against the reference's store, both ways.

A training state (the smoke llama's and the smoke hubert's, from the
reference's parameters) written by the port's ``save`` opens in the
reference's ``restore`` against the reference's ``init_state`` tree, and
one written by the reference's ``save`` opens in the port's ``restore``:
every leaf equal bit for bit, bf16 leaves included (stored as uint16 with
the dtype ``"bfloat16"``), the keys and their numbering (``arr_<i>``) the
same as jax's flatten order, ``step`` a 0-d int32.
"""

import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as ref_store
from repro.configs import smoke_config as ref_smoke_config
from repro.models import api as ref_api
from repro.models.common import init_params as ref_init_params
from repro.train import init_state as ref_init_state
from repro_torch.checkpoint import store
from repro_torch.configs import smoke_config
from repro_torch.models.common import iter_leaves
from repro_torch.train import init_state


def _states(arch):
    rcfg = ref_smoke_config(arch)
    params = ref_init_params(ref_api.model_specs(rcfg), jax.random.PRNGKey(0))
    ours = init_state(smoke_config(arch), params=jax.tree.map(np.asarray, params), device="cpu")
    ours["opt"]["step"].fill_(7)
    for _, leaf in iter_leaves(ours["opt"]["m"]):
        leaf.normal_(generator=torch.Generator().manual_seed(1))
    return rcfg, ours


def _manifest(path, step):
    with open(os.path.join(path, f"step_{step:08d}", "manifest.json")) as f:
        return json.load(f)


def _as_numpy(t):
    return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()


@pytest.mark.parametrize("arch", ["llama3.2-1b", "hubert-xlarge"])
def test_a_port_checkpoint_opens_in_the_reference(arch, tmp_path):
    rcfg, ours = _states(arch)
    store.save(str(tmp_path), 7, ours, extra={"loader": {"seed": 3}})
    like = jax.eval_shape(lambda: ref_init_state(rcfg, 0))
    got, extra = ref_store.restore(str(tmp_path), 7, like)
    assert extra == {"loader": {"seed": 3}}
    flat = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [jax.tree_util.keystr(p) for p, _ in flat] == [store.keystr(p) for p, _ in
                                                          iter_leaves(ours)]
    for (_, a), (path, b) in zip(flat, iter_leaves(ours)):
        assert a.dtype == {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
                           torch.int32: jnp.int32}[b.dtype], path
        np.testing.assert_array_equal(np.asarray(a, np.float32), _as_numpy(b).astype(np.float32))
    assert got["opt"]["step"].shape == () and int(got["opt"]["step"]) == 7
    # the leaves are numbered in jax's flatten order, bf16 as uint16
    entries = _manifest(str(tmp_path), 7)["keys"]
    assert [e["file"] for e in entries] == [f"arr_{i}.npy" for i in range(len(entries))]
    bf16 = [e for e in entries if e["dtype"] == "bfloat16"]
    assert bf16 and all(np.load(tmp_path / "step_00000007" / e["file"]).dtype == np.uint16
                        for e in bf16)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "hubert-xlarge"])
def test_a_reference_checkpoint_opens_in_the_port(arch, tmp_path):
    rcfg, ours = _states(arch)
    ref_state = jax.tree.map(
        lambda t: jnp.asarray(_as_numpy(t)).astype({torch.bfloat16: jnp.bfloat16,
                                                     torch.float32: jnp.float32,
                                                     torch.int32: jnp.int32}[t.dtype]), ours)
    ref_store.save(str(tmp_path / "ref"), 7, ref_state, extra={"loader": {"seed": 3}})
    store.save(str(tmp_path / "port"), 7, ours, extra={"loader": {"seed": 3}})
    # both packages write the same manifest
    assert _manifest(str(tmp_path / "ref"), 7) == _manifest(str(tmp_path / "port"), 7)
    got, extra = store.restore(str(tmp_path / "ref"), device="cpu")
    assert extra == {"loader": {"seed": 3}}
    for (pa, a), (pb, b) in zip(iter_leaves(got), iter_leaves(ours)):
        assert pa == pb and a.dtype == b.dtype and torch.equal(a, b), pa


def _toy_state():
    return {"params": {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3)},
            "opt": {"m": torch.zeros((2, 3)), "step": torch.tensor(7, dtype=torch.int32)}}


def test_save_is_atomic_and_keeps_the_last(tmp_path):
    for s in (1, 2, 3, 4):
        store.save(str(tmp_path), s, _toy_state(), keep_last=2)
    assert store.all_steps(str(tmp_path)) == [3, 4]
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]
    # a half-written step (its .tmp left by a crash) is never read
    os.makedirs(tmp_path / "step_00000009.tmp")
    assert store.latest_step(str(tmp_path)) == 4
    state, _ = store.restore(str(tmp_path), device="cpu")
    assert torch.equal(state["params"]["a"], _toy_state()["params"]["a"])


def test_async_checkpointer_snapshots_then_writes(tmp_path):
    state = _toy_state()
    acp = store.AsyncCheckpointer(str(tmp_path), keep_last=2)
    acp.save(5, state, extra={"x": 1})
    state["params"]["a"].add_(100)      # the step goes on in place: the snapshot holds
    acp.wait()
    got, extra = store.restore(str(tmp_path), 5, device="cpu")
    assert torch.equal(got["params"]["a"], _toy_state()["params"]["a"]) and extra == {"x": 1}


def test_async_checkpointer_raises_a_failed_write_at_wait(tmp_path, monkeypatch):
    acp = store.AsyncCheckpointer(str(tmp_path))
    gate = threading.Event()

    def broken(*a, **k):
        gate.set()
        raise OSError("disk full")

    monkeypatch.setattr(store, "save", broken)
    acp.save(1, _toy_state())
    gate.wait(10)
    with pytest.raises(OSError, match="disk full"):
        acp.wait()
    acp.wait()          # raised once
