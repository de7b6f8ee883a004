"""Dry run: trace one rank's program of every (architecture x input-shape)
cell on a fake 256- or 512-rank world, with shapes and no data, and record
its memory, FLOPs, bytes, collectives and kernel launches for the roofline
(``launch/roofline.py``) and the report (``launch/report.py``).

    python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k
    python -m repro_torch.launch.dryrun --all --out results/dryrun_torch   # subprocess per cell
    python -m repro_torch.launch.dryrun --all --multi-pod
    python -m repro_torch.launch.dryrun --arch rsp-partition

The reference lowers and compiles every cell for 512 placeholder XLA
devices.  The port has no compiler between the program and the card, so
its dry run is the program itself: ``main`` starts a world of 256 (or 512)
ranks in this one process on PyTorch's ``"fake"`` process-group backend
(rank 0; a collective moves nothing), builds the production mesh on
``"cuda"``, and runs rank 0's step on fake tensors (shapes and dtypes, no
data, no memory) under :class:`~repro_torch.launch.roofline.DryRunRecorder`.
Every rank runs the same program on its own shards (the port's tensor
parallelism is written out where GSPMD partitions the reference's), so
one rank's is the cell's.  The hand-written kernels take their shape-only
path on fake tensors (``kernels._cuda``): no kernel is built or launched,
and no card is needed, though a training cell's backward on a CUDA build
wants one visible (its autograd engine checks the device's context; nothing
is allocated on it).

A cell is what the port runs, scaled to look like nothing else:

* train -- ``make_train_step(..., rules=default_rules(mesh, ...))`` on the
  state as DTensors at the ZeRO and parameter shardings and the batch as
  DTensors at ``batch_shardings``: each rank computes its own heads, ff
  columns, vocab rows and experts on its data shard from its own
  parameter chunks (``distributed.tensor_parallel``), with the reductions
  GSPMD inserts;
* prefill, decode, encoder -- the serving step of the same compute: each
  rank's chunk of the parameters, of the batch and of the caches
  (``batch_shardings``, ``cache_shardings``; the caches' "model" shards
  stay the rank's, a shard over the data ranks of another dimension than
  the batch is gathered for the compute and its new value cut back to the
  cache's placement), and ``api.make_prefill_fn``, ``make_decode_fn`` or
  ``make_forward_fn`` under ``activation_sharding(rules)`` and
  ``tensor_parallel``;
* rsp-partition -- ``core.partition.distributed_rsp_partition`` over the D
  = 16 "data" ranks holding rank 0 (within its pod), each with ``records /
  D`` rows of 4,097 int32.

A result has the reference's keys: ``memory`` (the local bytes of every
input, of every output, and the recorder's peak of live bytes less the
inputs'), ``cost`` (``flops``, ``bytes accessed``), ``collectives_unscaled``
and ``analysis`` (``roofline.analyze``), ``lower_s`` (the trace's seconds)
and ``compile_s``, which is 0.0: nothing is compiled.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.overrides import TorchFunctionMode
from torch.utils._pytree import tree_flatten

from repro_torch.configs import ARCHS, SHAPES, cell_applicable, cells
from repro_torch.kernels import _cuda
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.roofline import DryRunRecorder, analyze, local_bytes

RSP_SEQ = 4097           # the train_4k record: 4,096 tokens and the next


def init_fake_world(world: int) -> None:
    """This process as rank 0 of a ``world``-rank group on PyTorch's
    ``"fake"`` backend (a collective returns at once and moves nothing)."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:     # a private module: say what is missing
        raise RuntimeError("the dry run needs torch.testing._internal.distributed.fake_pg"
                           " (PyTorch's fake process group), which this PyTorch lacks") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def _dtensor(meta, device: str):
    """A fake DTensor of a ``ShardedMeta`` leaf: this rank's chunk at its
    sharding."""
    sh = meta.sharding
    local = torch.empty(sh.shard_shape(meta.shape), dtype=meta.dtype, device=device)
    return DTensor.from_local(local, sh.mesh, sh.placements(), run_check=False,
                              shape=torch.Size(meta.shape), stride=meta.meta.stride())


def _placed(tree, device: str):
    from repro_torch.models.common import iter_leaves, set_leaf

    out: dict = {}
    for path, leaf in iter_leaves(tree):
        set_leaf(out, path, _dtensor(leaf, device))
    return out


def _model_and_data(placements, dim: int, data_axes: tuple[int, ...], model_axis: int | None):
    """``placements`` with the shards over "model" kept, and over the data
    mesh dimensions only those of dimension ``dim`` (the batch); the rest
    replicated."""
    def keep(k, p):
        if not isinstance(p, Shard):
            return False
        return k == model_axis or (p.dim == dim and k in data_axes)

    return tuple(p if keep(k, p) else Replicate() for k, p in enumerate(placements))


def _serve_fn(cfg, cell, rules):
    """The sharded serving step (see the module's notes): ``(params,
    caches, batch) -> (logits, caches)``, the encoder's ``(params, batch)
    -> logits``."""
    from repro_torch.distributed import tensor_parallel as tpl
    from repro_torch.distributed.sharding import activation_sharding, mesh_shape
    from repro_torch.models import api
    from repro_torch.models.common import iter_leaves, set_leaf
    from repro_torch.models.transformer import build_lm
    from repro_torch.optim.adamw import leaves, tree_map

    mesh = rules.mesh
    names = list(mesh_shape(mesh))
    data_axes = tuple(names.index(a) for a in ("pod", "data") if a in names)
    model_axis = names.index("model") if "model" in names else None
    tp = tpl.from_rules(rules)

    def model_of(params):
        # this rank's chunk of every bf16 compute parameter, as it rests
        # (trainable keeps the leaves), under tensor-parallel compute
        local = tree_map(lambda p: p.to_local() if isinstance(p, DTensor) else p, params)
        return build_lm(cfg, local, device=leaves(local)[0].device, trainable=True)

    def mine(batch):
        return {k: v.to_local() for k, v in batch.items()}

    if cfg.family == "encoder":
        def enc_fn(params, batch):
            with torch.no_grad(), activation_sharding(rules), tpl.tensor_parallel(tp):
                return api.make_forward_fn(model_of(params))(mine(batch))

        return enc_fn

    step = api.make_prefill_fn if cell.kind == "prefill" else api.make_decode_fn

    def fn(params, caches, batch):
        work, placement = {}, {}
        for path, leaf in iter_leaves(caches):
            if isinstance(leaf, DTensor):
                # the batch (dimension 1) stays cut over the data ranks and
                # every "model" shard stays the rank's; a shard of another
                # dimension over the data ranks (long-context kv_seq) is
                # gathered for the compute
                keep = _model_and_data(leaf.placements, 1, data_axes, model_axis)
                placement[path] = (leaf.placements, keep)
                leaf = leaf.redistribute(mesh, keep).to_local()
            set_leaf(work, path, leaf)
        with torch.no_grad(), activation_sharding(rules), tpl.tensor_parallel(tp):
            logits, new = step(model_of(params))(work, mine(batch))
        out: dict = {}
        for path, leaf in iter_leaves(new):
            if path in placement:       # back to the cache's own placement
                cache_p, keep = placement[path]
                leaf = DTensor.from_local(leaf, mesh, keep, run_check=False).redistribute(
                    mesh, cache_p)
            set_leaf(out, path, leaf)
        return logits, out

    return fn


def build_cell(arch: str, shape: str, *, multi_pod: bool = False, optimized: bool = False,
               mesh=None, cfg=None, cell=None, train_cfg=None):
    """Returns ``(fn, args)``: one rank's step and its fake inputs, placed
    at the reference's shardings.  Call it under a ``FakeTensorMode``.

    ``optimized=True`` applies the beyond-paper flags (flat-head attention,
    seq-chunked CE, sorted MoE dispatch), as the reference's does.  ``mesh``
    defaults to the production mesh of the world (``make_production_mesh``);
    ``cfg``, ``cell`` and ``train_cfg`` replace ``ARCHS[arch]``,
    ``SHAPES[shape]`` and the reference's ``TrainConfig``."""
    from repro_torch.distributed.sharding import (
        ShardedMeta,
        abstract_compute_params,
        abstract_state,
        attach_shardings,
        batch_shardings,
        cache_shardings,
        default_rules,
    )
    from repro_torch.models import api
    from repro_torch.models.common import iter_leaves, set_leaf
    from repro_torch.models.transformer import init_caches
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import TrainConfig, make_train_step

    cfg = cfg or ARCHS[arch]
    if optimized:
        cfg = dataclasses.replace(
            cfg, flat_attention=True, loss_seq_chunks=16, moe_sort_dispatch=True
        )
    cell = cell or SHAPES[shape]
    mesh = mesh if mesh is not None else mesh_lib.make_production_mesh(multi_pod=multi_pod)
    device = mesh.device_type
    rules = default_rules(mesh, cfg=cfg, shard_kv_seq=(cell.name == "long_500k"))
    specs = api.model_specs(cfg)
    batch_abs = api.input_specs(cfg, cell)
    batch = _placed(attach_shardings(batch_abs, batch_shardings(batch_abs, rules)), device)
    params = _placed(abstract_compute_params(specs, rules), device)

    if cell.kind == "train":
        # the reference dispatches the global batch in one group a data
        # rank (``moe_groups = dp``); a rank's shard here is one such group
        train_cfg = train_cfg or TrainConfig(total_steps=1000, warmup_steps=10, moe_groups=1)
        step = make_train_step(cfg, AdamWConfig(), train_cfg, rules=rules)
        state = {"params": params, "opt": _placed(abstract_state(specs, rules), device)}
        return step, (state, batch)

    fn = _serve_fn(cfg, cell, rules)
    if cfg.family == "encoder":
        return fn, (params, batch)
    # the caches' structure and shapes; their tensors are fake, so the
    # global ones cost nothing and only each rank's chunk is an argument
    full = init_caches(cfg, cell.global_batch, cell.seq_len, device=device)
    shardings = dict(iter_leaves(cache_shardings(full, rules)))
    caches: dict = {}
    for path, leaf in iter_leaves(full):
        if isinstance(leaf, torch.Tensor):
            leaf = _dtensor(ShardedMeta(leaf, shardings[path]), device)
        set_leaf(caches, path, leaf)
    return fn, (params, caches, batch)


def _trace(fn, args) -> tuple[dict, dict, float]:
    """Run ``fn(*args)`` under a :class:`DryRunRecorder`: (memory,
    analysis, seconds)."""
    t0 = time.perf_counter()
    rec = DryRunRecorder()
    rec.track_arguments(args)
    with rec:
        out = fn(*args)
    memory = {"argument_size_in_bytes": rec.arguments,
              "output_size_in_bytes": local_bytes(out),
              "temp_size_in_bytes": rec.temp}
    analysis = analyze(rec)
    del out
    return memory, analysis, time.perf_counter() - t0


class _HostGuards(TorchFunctionMode):
    """On a PyTorch built without CUDA, a few Python bindings of a tensor
    (indexing, ``~``, ``contiguous``, ``copy_``, ``new_tensor``) build a CUDA
    device guard the build lacks, though the op itself runs on shapes.
    Under this mode such a call runs with its fake CUDA tensors' device set
    to the host, and its new fake tensors are marked with the first fake
    CUDA tensor's device again: the same shapes, dtypes and aten ops.  A
    build with CUDA needs none of it.  Autograd cannot be helped this way
    (its nodes ask the guard for a stream), so a training cell runs only on
    a build with CUDA."""

    GUARDED = {torch.Tensor.__getitem__, torch.Tensor.__setitem__, torch.Tensor.__invert__,
               torch.Tensor.contiguous, torch.Tensor.copy_, torch.Tensor.new_tensor}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        moved = _fake_cuda((args, kwargs)) if func in self.GUARDED else []
        if not moved:
            return func(*args, **kwargs)
        device = moved[0].device
        for t in moved:
            t.fake_device = torch.device("cpu")
        try:
            out = func(*args, **kwargs)
        finally:
            for t in moved:
                t.fake_device = device
        for t in _fake_cuda(out, host=True):
            t.fake_device = device
        return out


def _fake_cuda(tree, host: bool = False) -> list:
    """The fake tensors in ``tree`` on a CUDA device (``host``: on the
    CPU)."""
    want = "cpu" if host else "cuda"
    return [t for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor) and _cuda.is_fake(t) and t.fake_device.type == want]


@contextlib.contextmanager
def _fake_mode():
    """A ``FakeTensorMode`` (real inputs are taken as fake), with
    :class:`_HostGuards` on a PyTorch built without CUDA."""
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        if torch.cuda._is_compiled():
            yield mode
        else:
            with _HostGuards():
                yield mode


def dryrun_cell(arch: str, shape: str, *, multi_pod: bool = False, optimized: bool = False,
                mesh=None, cfg=None, cell=None, train_cfg=None) -> dict:
    """Trace one cell (``build_cell``'s arguments) and return its result
    (see the module's notes); an inapplicable cell gives ``skipped``."""
    if cfg is None and cell is None:
        ok, why = cell_applicable(arch, shape)
        if not ok:
            return {"arch": arch, "shape": shape, "multi_pod": multi_pod, "skipped": why}
    with _fake_mode():
        fn, args = build_cell(arch, shape, multi_pod=multi_pod, optimized=optimized, mesh=mesh,
                              cfg=cfg, cell=cell, train_cfg=train_cfg)
        memory, analysis, secs = _trace(fn, args)
        del fn, args
    result = {
        "arch": arch,
        "shape": shape,
        "multi_pod": multi_pod,
        "optimized": optimized,
        "chips": dist.get_world_size(),
        "lower_s": round(secs, 1),
        "compile_s": 0.0,       # nothing is compiled: the trace is the program
        "memory": memory,
        "cost": {"flops": analysis["flops"], "bytes accessed": analysis["bytes"]},
        "collectives_unscaled": analysis["collectives"],
        "analysis": analysis,
    }
    print("memory:", memory)
    print("trace: flops={flops:.3e} bytes={bytes:.3e} collectives={c} kernels={k}".format(
        flops=analysis["flops"], bytes=analysis["bytes"],
        c={k: f"{v['bytes']:.2e}" for k, v in analysis["collectives"].items()},
        k={k: v["launches"] for k, v in analysis["kernels"].items()}))
    return result


def dryrun_rsp_partition(*, multi_pod: bool = False, records: int | None = None,
                         mesh=None) -> dict:
    """Trace Algorithm 1's collective program (``distributed_rsp_partition``:
    the shuffle, then the all-to-all) over the "data" ranks of rank 0's pod
    (D = 16 on the production mesh), each rank holding ``records / D``
    records of 4,097 int32 (``records`` defaults to D * D * 64, 64 records a
    sub-block).  The multi-pod variant partitions within each pod, as the
    reference's does."""
    from repro_torch.core.partition import distributed_rsp_partition
    from repro_torch.distributed.sharding import mesh_shape

    with _fake_mode():
        mesh = mesh if mesh is not None else mesh_lib.make_production_mesh(multi_pod=multi_pod)
        D = int(mesh_shape(mesh)["data"])
        if records is None:
            records = D * D * 64
        group = mesh.get_group("data")
        shard = torch.empty((records // D, RSP_SEQ), dtype=torch.int32, device=mesh.device_type)
        memory, analysis, secs = _trace(lambda s: distributed_rsp_partition(s, 0, group),
                                        (shard,))
        del shard
    return {
        "arch": "rsp-partition",
        "shape": f"records{records}x{RSP_SEQ}",
        "multi_pod": multi_pod,
        "chips": dist.get_world_size(),
        "lower_s": round(secs, 1),
        "compile_s": 0.0,
        "memory": memory,
        "analysis": analysis,
    }


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=sorted(ARCHS) + ["rsp-partition"], default=None)
    p.add_argument("--shape", choices=sorted(SHAPES), default=None)
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--optimized", action="store_true",
                   help="beyond-paper perf flags (flat attention, chunked CE)")
    p.add_argument("--both-meshes", action="store_true")
    p.add_argument("--all", action="store_true", help="run every applicable cell in subprocesses")
    p.add_argument("--out", default="results/dryrun_torch")
    p.add_argument("--save-hlo", default=None,
                   help="no counterpart in the port: it compiles no HLO (refused if given)")
    p.add_argument("--timeout", type=int, default=3000)
    args = p.parse_args()
    if args.save_hlo:
        p.error("--save-hlo has no counterpart: the port's dry run compiles no HLO")

    os.makedirs(args.out, exist_ok=True)
    world = 512 if args.multi_pod else 256

    if args.arch == "rsp-partition":
        init_fake_world(world)
        result = dryrun_rsp_partition(multi_pod=args.multi_pod)
        tag = f"rsp-partition_{'multi' if args.multi_pod else 'single'}"
        with open(os.path.join(args.out, tag + ".json"), "w") as f:
            json.dump(result, f, indent=1)
        print(json.dumps(result, indent=1))
        return 0

    if args.all:
        todo = []
        meshes = [False, True] if args.both_meshes else [args.multi_pod]
        for arch, shape in cells() + [("rsp-partition", "corpus")]:
            for mp in meshes:
                mesh_tag = "multi" if mp else "single"
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                       "--out", args.out] + (["--multi-pod"] if mp else [])
                if arch == "rsp-partition":
                    tag = f"rsp-partition_{mesh_tag}"
                else:
                    tag = f"{arch}_{shape}_{mesh_tag}"
                    cmd += ["--shape", shape]
                if os.path.exists(os.path.join(args.out, tag + ".json")):
                    print(f"[skip existing] {tag}")
                    continue
                todo.append((tag, cmd))

        failures = []
        for tag, cmd in todo:
            print(f"[run] {tag}", flush=True)
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True, timeout=args.timeout)
                if proc.returncode == 0:
                    continue
                log = proc.stdout[-5000:] + "\n" + proc.stderr[-10000:]
            except subprocess.TimeoutExpired as e:
                log = f"timed out after {args.timeout} s\n{e.stderr or ''}"
            with open(os.path.join(args.out, tag + ".err"), "w") as f:
                f.write(log)
            print(f"[FAIL] {tag}", flush=True)
            failures.append(tag)
        print(f"done; {len(failures)} failures: {failures}")
        return 1 if failures else 0

    if not args.arch or not args.shape:
        p.error("--arch/--shape required unless --all")
    try:
        init_fake_world(world)
        result = dryrun_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                             optimized=args.optimized)
    except Exception:
        traceback.print_exc()
        return 1
    tag = f"{args.arch}_{args.shape}_{'multi' if args.multi_pod else 'single'}"
    if args.optimized:
        tag += "_opt"
    with open(os.path.join(args.out, tag + ".json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
