"""Elastic restore of model state onto any mesh, sharded checkpoints, and
the training launcher under ``torch.distributed``, on gloo children.

The reference's multi-device script (``tests/test_distributed.py``'s
``MULTI_DEV_SCRIPT``) saves a single-process state and restores it onto a
(4, 2) and a (1, 2) mesh with ``restore_for_mesh``.  Here a single-process
checkpoint of the port (and one the reference wrote) restores onto (4, 1),
(2, 2) and (1, 2) gloo meshes: the leaves the rules shard are sharded, and
every gathered leaf is the saved bits.  A checkpoint a 2 x 2 run writes
(each leaf gathered, rank 0 writing) opens in the reference's
``ckpt.restore`` and in a single process with the run's bits, and a
Trainer under rules resumes from it exactly as the unbroken run went on.
When only one rank of a mesh is signalled, every rank saves the same step
and stops there.  ``launch/train.py --distributed --device cpu`` runs as
two gloo ranks, without rules, as the reference's launcher does: each rank
trains on its own, into its own checkpoint directory.  Each child has a
60 s timeout.
"""

from __future__ import annotations

import json
import os
import re

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import store as ref_store
from repro.configs import smoke_config as ref_smoke_config
from repro.train.loop import init_state as ref_init_state
from repro_torch.checkpoint import store
from repro_torch.configs import smoke_config
from repro_torch.distributed import serve_store
from repro_torch.models import api
from repro_torch.models.common import iter_leaves
from repro_torch.train import init_state
from test_torch_mesh import assert_ok, gloo_init, marked, run_children

RESTORE_CHILD = r"""
import json, os
import torch
import torch.distributed as dist
%(GLOO_INIT)s
from repro_torch.checkpoint import store
from repro_torch.configs import smoke_config
from repro_torch.distributed.elastic import restore_for_mesh
from repro_torch.distributed.sharding import default_rules, gather, is_dtensor
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.common import iter_leaves
from repro_torch.train import init_state

cfg = smoke_config("llama3.2-1b")
shape = tuple(json.loads(os.environ["MESH"]))
rules = default_rules(make_host_mesh(shape, ("data", "model"), device_type="cpu"), cfg=cfg)
root = os.environ["CKPT"]
like = init_state(cfg, 0, device="cpu")
restored, extra = restore_for_mesh(root, 3, cfg, rules, like=like)
saved, _ = store.restore(root, 3, device="cpu")
flat = dict(iter_leaves(saved))
sharded, differ, plain = [], [], []
for path, leaf in iter_leaves(restored):
    if not is_dtensor(leaf):
        plain.append("/".join(path))
        continue
    if leaf.to_local().numel() < leaf.numel():
        sharded.append("/".join(path))
    full = gather(leaf)
    if full.dtype != flat[path].dtype or not torch.equal(full, flat[path]):
        differ.append("/".join(path))
print("RESULT " + json.dumps({"sharded": sharded, "differ": differ, "plain": plain,
                              "extra": extra, "leaves": len(flat)}), flush=True)
dist.destroy_process_group()
print("RESTORE_OK", flush=True)
""" % {"GLOO_INIT": gloo_init()}


def _saved_by(tmp_path, source: str) -> str:
    root = str(tmp_path / "ckpt")
    if source == "port":
        store.save(root, 3, init_state(smoke_config("llama3.2-1b"), 0, device="cpu"),
                   extra={"note": "one process"})
    else:
        ref_store.save(root, 3, ref_init_state(ref_smoke_config("llama3.2-1b"), seed=0),
                       extra={"note": "one process"})
    return root


@pytest.mark.parametrize("case", ["4x1", "2x2", "1x2", "2x2 from the reference"])
def test_a_single_process_checkpoint_restores_onto_any_mesh(case, tmp_path):
    shape = [int(n) for n in case.split()[0].split("x")]
    root = _saved_by(tmp_path, "reference" if "reference" in case else "port")
    server = serve_store()
    children = run_children(RESTORE_CHILD, shape[0] * shape[1],
                            env={"RSP_STORE": f"127.0.0.1:{server.port}",
                                 "MESH": json.dumps(shape), "CKPT": root})
    assert_ok(children, "RESTORE_OK")
    leaves = 4 * len(list(iter_leaves(api.model_specs(smoke_config("llama3.2-1b"))))) + 1
    for child in children:
        got = marked(child, "RESULT ")
        assert got["differ"] == [] and got["plain"] == [] and got["leaves"] == leaves
        assert got["extra"] == {"note": "one process"}
        # the leaves the rules shard are sharded (the reference's check leaf)
        assert "opt/master/layers/mlp/gate/w" in got["sharded"]
        if shape[1] > 1:
            assert "params/layers/mlp/gate/w" in got["sharded"]
        if shape[0] > 1:     # ZeRO: the optimizer's embedding over "data"
            assert "opt/m/embed/table" in got["sharded"]


TRAINER_CHILD = r"""
import json, os
import numpy as np
import torch
import torch.distributed as dist
%(GLOO_INIT)s
from repro_torch.configs import smoke_config
from repro_torch.core import RSPSpec, two_stage_partition_np
from repro_torch.data import BlockSource, RSPLoader, make_token_corpus
from repro_torch.distributed.sharding import default_rules, gather
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models.common import iter_leaves
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, Trainer

cfg = smoke_config("llama3.2-1b")
rules = default_rules(make_host_mesh((2, 2), ("data", "model"), device_type="cpu"), cfg=cfg)
corpus = make_token_corpus(256, 17, vocab_size=256, seed=0)
blocks = two_stage_partition_np(corpus, RSPSpec(num_records=256, num_blocks=16,
                                                num_original_blocks=16, seed=1))
tc = TrainConfig(total_steps=4, warmup_steps=1, checkpoint_every=2, log_every=1)
out = os.environ["RSP_OUT"]

def trainer(ckpt):
    loader = RSPLoader(BlockSource(blocks=blocks, device="cpu"), batch_size=8, seed=3)
    return Trainer(cfg, AdamWConfig(lr=1e-2), tc, loader, os.path.join(out, ckpt),
                   device="cpu", rules=rules,
                   batch_transform=lambda b: {"tokens": b.to(torch.int32)})

def host(state):
    return {"/".join(p): gather(t).float().numpy() for p, t in iter_leaves(state)}

whole = host(trainer("whole").run())
part = trainer("resumed")
at2 = host(part.run(stop_after_steps=2))
resumed = host(trainer("resumed").run())
if dist.get_rank() == 0:
    np.savez(os.path.join(out, "at2.npz"), **at2)
differ = [k for k in whole if not np.array_equal(whole[k], resumed[k])]
print("RESULT " + json.dumps({"differ": differ, "step": int(resumed["opt/step"]),
                              "files": sorted(os.listdir(os.path.join(out, "resumed")))}),
      flush=True)
dist.destroy_process_group()
print("TRAINER_OK", flush=True)
""" % {"GLOO_INIT": gloo_init()}


def test_a_sharded_checkpoint_opens_anywhere_and_resumes_exactly(tmp_path):
    server = serve_store()
    children = run_children(TRAINER_CHILD, 4, env={"RSP_STORE": f"127.0.0.1:{server.port}",
                                                   "RSP_OUT": str(tmp_path)})
    assert_ok(children, "TRAINER_OK")
    for child in children:
        got = marked(child, "RESULT ")
        assert got["differ"] == [] and got["step"] == 4
        assert got["files"] == ["step_00000002", "step_00000004"]
    at2 = dict(np.load(tmp_path / "at2.npz"))
    root = str(tmp_path / "resumed")
    # one process of the port reads rank 0's files with the run's bits
    mine, extra = store.restore(root, 2, device="cpu")
    assert "loader" in extra
    flat = {"/".join(p): t for p, t in iter_leaves(mine)}
    assert flat.keys() == at2.keys()
    for key, leaf in flat.items():
        assert np.array_equal(leaf.float().numpy(), at2[key]), key
    assert flat["params/embed/table"].dtype == torch.bfloat16
    # ... and so does the reference
    like = jax.eval_shape(lambda: ref_init_state(ref_smoke_config("llama3.2-1b"), 0))
    theirs, _ = ref_store.restore(root, 2, like)
    for path, leaf in jax.tree_util.tree_flatten_with_path(theirs)[0]:
        key = "/".join(k.key for k in path)
        assert np.array_equal(np.asarray(leaf, np.float32), at2[key]), key


SIGNAL_CHILD = r"""
import json, os, signal
import torch
import torch.distributed as dist
%(GLOO_INIT)s
from repro_torch.configs import smoke_config
from repro_torch.core import RSPSpec, two_stage_partition_np
from repro_torch.data import BlockSource, RSPLoader, make_token_corpus
from repro_torch.distributed.sharding import default_rules, gather
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, Trainer

cfg = smoke_config("llama3.2-1b")
rules = default_rules(make_host_mesh((2, 1), ("data", "model"), device_type="cpu"), cfg=cfg)
corpus = make_token_corpus(256, 17, vocab_size=256, seed=0)
blocks = two_stage_partition_np(corpus, RSPSpec(num_records=256, num_blocks=16,
                                                num_original_blocks=16, seed=1))
loader = RSPLoader(BlockSource(blocks=blocks, device="cpu"), batch_size=8, seed=3)
batches = []

def transform(b):
    batches.append(1)
    if dist.get_rank() == 0 and len(batches) == 2:     # only rank 0 is preempted
        os.kill(os.getpid(), signal.SIGTERM)
    return {"tokens": b.to(torch.int32)}

tc = TrainConfig(total_steps=6, warmup_steps=1, checkpoint_every=100, log_every=1)
trainer = Trainer(cfg, AdamWConfig(lr=1e-2), tc, loader, os.environ["CKPT"], device="cpu",
                  rules=rules, batch_transform=transform)
state = trainer.run()
print("RESULT " + json.dumps({"step": int(gather(state["opt"]["step"])),
                              "signalled": trainer._preempted,
                              "files": sorted(os.listdir(os.environ["CKPT"]))}), flush=True)
dist.destroy_process_group()
print("SIGNAL_OK", flush=True)
""" % {"GLOO_INIT": gloo_init()}


def test_a_signal_on_one_rank_stops_every_rank_at_the_same_step(tmp_path):
    """A checkpoint save under rules is a collective: when only rank 0 is
    signalled, both ranks save the same step and stop there."""
    server = serve_store()
    children = run_children(SIGNAL_CHILD, 2, env={"RSP_STORE": f"127.0.0.1:{server.port}",
                                                  "CKPT": str(tmp_path / "ckpt")})
    assert_ok(children, "SIGNAL_OK")
    for child in children:
        got = marked(child, "RESULT ")
        assert got["signalled"] == (child.rank == 0)
        assert got["step"] == 2 and got["files"] == ["step_00000002"]


LAUNCH_CHILD = r"""
import os
rank = os.environ["RSP_PROCESS_ID"]
os.environ.update(RANK=rank, LOCAL_RANK=rank, WORLD_SIZE=os.environ["RSP_NUM_PROCESSES"],
                  TORCHELASTIC_USE_AGENT_STORE="True")
from repro_torch.launch.train import main

main(["--arch", "llama3.2-1b", "--device", "cpu", "--distributed", "--steps", "4",
      "--seq", "16", "--sequences", "256", "--blocks", "16", "--ckpt-dir", os.environ["CKPT"]])
print("LAUNCH_OK", flush=True)
"""


def test_the_launcher_trains_under_torch_distributed(tmp_path):
    server = serve_store()
    children = run_children(LAUNCH_CHILD, 2, env={"MASTER_ADDR": "127.0.0.1",
                                                  "MASTER_PORT": str(server.port),
                                                  "CKPT": str(tmp_path / "ckpt")})
    assert_ok(children, "LAUNCH_OK")
    histories = []
    for child in children:
        assert re.search(rf"trained 4 steps on cpu \(host\) \(rank {child.rank} of 2\)",
                         child.stdout), child.describe()
        body = child.stdout.split("\n", 1)[1].rsplit("LAUNCH_OK", 1)[0]
        histories.append([{k: v for k, v in h.items() if k != "sec_per_step"}
                          for h in json.loads(body[body.index("["):])])
    assert histories[0] == histories[1] and histories[0][-1]["step"] == 4
    ckpt = tmp_path / "ckpt"
    assert sorted(os.listdir(ckpt)) == ["rank0", "rank1"]
    assert all(store.latest_step(str(ckpt / r)) == 4 for r in ("rank0", "rank1"))
