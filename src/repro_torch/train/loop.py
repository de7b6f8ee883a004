"""Training: ``make_train_step`` (mixed precision, optional microbatch
gradient accumulation, and the reference's sharding rules with ZeRO-1 over
the data ranks) and a preemption-safe Trainer.

The state is the reference's tree, ``{"params": bf16 parameters, "opt":
{"master", "m", "v", "step"}}``, every leaf in the reference's layout
(layers stacked on a leading axis), so checkpoints cross between the
packages.  A step builds the model around ``state["params"]`` (a layer's
parameters are views of the stacked leaves, requiring grad), runs the
family's loss and its backward, stacks the layers' gradients back into the
reference's layout (:func:`param_grads`) and applies ``adamw_update``,
which updates the optimizer state in place.

Under ``rules`` (``distributed.sharding.ShardingRules`` on a
``DeviceMesh``; ``rules=None`` changes nothing, bit for bit) the state is
DTensors: the bf16 parameters rest at ``param_shardings`` and master, m
and v at ``optimizer_shardings`` (ZeRO-1: one more dimension over
"data").  Every rank's loader yields the same global batch, and a step
keeps this rank's data shard of it (``batch_shardings``; a batch leaf that
is a DTensor at that sharding is taken as the rank's shard), builds the
model on its own chunk of every parameter (no gather over "model") and
computes the loss and gradients of its shard tensor-parallel over "model"
(``distributed.tensor_parallel``: each model rank its heads, ff columns,
vocab rows and experts, with the reductions GSPMD inserts for the
reference), all-reduces its gradient chunks in float32 over the data axes
(their mean), clips by the norm of the whole reduced gradient, updates its
own chunk of master, m and v, and places the new bf16 parameters back (an
all-gather over "data").  A mesh of data ranks alone (one model rank)
computes the whole model on each.

Families: all five train -- the dense decoders, the MoE decoders (their
capacity dispatch in ``moe_groups`` groups, the router's aux loss added to
the cross entropy), the zamba2 hybrid, RWKV6 and the encoder; every kernel
on their paths has a backward (flash attention's, the SSD's, the WKV's).

The data pipeline is the RSP loader: every batch is a block-level sample
(Definition 4), and its O(1) sampler state rides along in each checkpoint,
so a restart reproduces the exact batch sequence.
"""

from __future__ import annotations

import dataclasses
import math
import signal
import time
from typing import Callable

import torch

from repro_torch import obs
from repro_torch.checkpoint import store as ckpt
from repro_torch.device import resolve_device
from repro_torch.models import api, transformer
from repro_torch.models.common import Tree, init_params, iter_leaves, set_leaf
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import build_lm
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update, leaves, tree_map
from repro_torch.optim.schedule import SCHEDULES


@dataclasses.dataclass
class TrainConfig:
    total_steps: int = 100
    warmup_steps: int = 10
    schedule: str = "cosine"
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    log_every: int = 10
    microbatch: int = 0          # 0 = no accumulation; else per-step microbatch count
    moe_groups: int = 1          # the MoE layers' dispatch groups
    seed: int = 0


def _module_leaf(module, path: tuple[str, ...]) -> torch.Tensor:
    for name in path:
        module = getattr(module, name)
    return module


def param_grads(model, params: Tree) -> Tree:
    """The gradients of ``model``'s parameters in the layout of ``params``
    (the reference's): a stacked leaf's gradient is its layers' gradients
    stacked (``model.stacks()``: the hybrid's rounds on two axes); a
    parameter that took no gradient gets zeros, as jax gives.  A parameter
    used more than once (zamba2's shared block) holds the sum of its
    calls' gradients.  Each parameter's ``.grad`` is released as it is
    read, so the stacked copies and the layers' gradients are never all
    held at once."""
    def grad(p: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        g, p.grad = p.grad, None
        return g if g is not None else torch.zeros_like(like)

    def stacked(layers, path, leaf):
        if not isinstance(layers, list):
            return grad(_module_leaf(layers, path), leaf)
        if not layers:       # a stack of no layers (a hybrid cut below one round)
            return torch.zeros_like(leaf)
        return torch.stack([stacked(sub, path, leaf[i]) for i, sub in enumerate(layers)])

    stacks = model.stacks()
    out: Tree = {}
    for path, leaf in iter_leaves(params):
        if path[0] in stacks:
            g = stacked(stacks[path[0]], path[1:], leaf)
        else:
            g = grad(_module_leaf(model, path), leaf)
        set_leaf(out, path, g)
    return out


def _data_groups(rules) -> tuple[list, int]:
    """The process groups of the mesh dimensions that carry the batch, and
    the number of data ranks."""
    from repro_torch.distributed.sharding import mesh_shape

    dp = rules.rules["batch"]
    names = () if dp is None else dp if isinstance(dp, tuple) else (dp,)
    sizes = mesh_shape(rules.mesh)
    return [rules.mesh.get_group(n) for n in names], math.prod(sizes[n] for n in names)


def _data_mean(t: torch.Tensor, groups: list, n: int,
               weight: torch.Tensor | None = None) -> torch.Tensor:
    """The float32 mean of ``t`` over the data ranks (each rank's ``t``
    times its ``weight`` first, where given): summed over each data mesh
    dimension in turn, then divided by their count."""
    from repro_torch.distributed.tensor_parallel import all_reduce

    t = t.to(torch.float32) if weight is None else t.to(torch.float32) * weight
    for group in groups:
        all_reduce(t, group)
    return t.div_(n)


def _mask_weight(batch: dict, groups: list, n: int) -> torch.Tensor | None:
    """A masked loss (the encoder's) is the mean over the positions its
    ``mask`` marks in the whole batch, so each data rank's mean over its
    own marked positions counts by their share: ``n * c_r / max(C, 1)``,
    ``c_r`` the rank's marked positions and ``C`` all ranks'.  None
    without a mask or with one data rank."""
    if "mask" not in batch or n == 1:
        return None
    from repro_torch.distributed.tensor_parallel import all_reduce

    mine = batch["mask"].to(torch.float32).sum()
    total = mine.clone()
    for group in groups:
        all_reduce(total, group)
    return mine * n / torch.clamp_min(total, 1.0)


def _any_rank(flag: bool, mesh) -> bool:
    """Whether ``flag`` is set on any rank of ``mesh``: a one-element MAX
    all-reduce over each of its dimensions."""
    import torch.distributed as dist

    from repro_torch.distributed.tensor_parallel import all_reduce

    t = torch.tensor([int(flag)], dtype=torch.int32, device=mesh.device_type)
    for group in mesh.get_all_groups():
        all_reduce(t, group, op=dist.ReduceOp.MAX)
    return bool(t.item())


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, train_cfg: TrainConfig, *,
                    rules=None) -> Callable:
    """``(state, batch) -> (state, metrics)``, state = {params, opt}; the
    batch's tensors on the parameters' device.  ``metrics``: loss (averaged
    over microbatches), ce and aux (the last microbatch's), grad_norm and
    lr, as 0-d tensors.  Under ``rules`` (see the module docstring) the
    batch is the global batch, and loss, ce and aux are averaged over the
    data ranks."""
    schedule = SCHEDULES[train_cfg.schedule]

    def grads_of(params: Tree, batch: dict):
        device = leaves(params)[0].device
        with obs.range("train.forward"):
            model = build_lm(cfg, params, device=device, trainable=True)
            loss, metrics = api.make_loss_fn(model, moe_groups=train_cfg.moe_groups)(batch)
        with obs.range("train.backward"):
            loss.backward()
            grads = param_grads(model, params)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def loss_and_grads(params: Tree, batch: dict):
        n = train_cfg.microbatch
        if n > 1:
            # split the batch into microbatches; accumulate float32
            loss = torch.zeros((), dtype=torch.float32, device=leaves(params)[0].device)
            grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                   device=p.device), params)
            for i in range(n):
                mb = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])[i] for k, v in batch.items()}
                mb_loss, metrics, mb_grads = grads_of(params, mb)
                for acc, g in zip(leaves(grads), leaves(mb_grads)):
                    acc.add_(g.to(torch.float32))
                loss = loss + mb_loss / n
                del mb_grads
            grads = tree_map(lambda g: g / n, grads)
        else:
            loss, metrics, grads = grads_of(params, batch)
        return loss, metrics, grads

    def step_fn(state: dict, batch: dict):
        loss, metrics, grads = loss_and_grads(state["params"], batch)
        with obs.range("train.optimizer"):
            lr_scale = schedule(state["opt"]["step"], warmup_steps=train_cfg.warmup_steps,
                                total_steps=train_cfg.total_steps)
            new_opt, new_params, stats = adamw_update(state["opt"], grads, opt_cfg,
                                                      lr_scale=lr_scale)
        return {"params": new_params, "opt": new_opt}, {"loss": loss, **metrics, **stats}

    if rules is None:
        return step_fn

    from repro_torch.distributed import tensor_parallel as tpl
    from repro_torch.distributed.sharding import (
        activation_sharding,
        batch_shardings,
        is_dtensor,
        local_chunk,
        param_shardings,
    )

    p_shardings = param_shardings(api.model_specs(cfg), rules)
    groups, n_data = _data_groups(rules)
    tp = tpl.from_rules(rules)

    def sharded_step_fn(state: dict, batch: dict):
        b_shardings = batch_shardings(batch, rules)
        for k, v in batch.items():
            b_shardings[k].shard_shape(v.shape)     # raises unless the data ranks divide it
            if is_dtensor(v) and tuple(v.placements) != b_shardings[k].placements():
                raise ValueError(f"batch leaf {k!r} is placed at {v.placements}, not at its"
                                 f" batch sharding {b_shardings[k].placements()}")
        # a DTensor leaf at its batch sharding is this rank's chunk already
        mine = {k: v.to_local() if is_dtensor(v) else
                local_chunk(v, rules.mesh, b_shardings[k].placements()) for k, v in batch.items()}
        # this rank's chunk of every parameter: no gather over "model"
        params = tree_map(lambda p: p.to_local() if is_dtensor(p) else p, state["params"])
        with activation_sharding(rules), tpl.tensor_parallel(tp):
            loss, metrics, grads = loss_and_grads(params, mine)
        del params
        weight = _mask_weight(mine, groups, n_data)
        for path, g in list(iter_leaves(grads)):
            set_leaf(grads, path, _data_mean(g, groups, n_data, weight))
        loss = _data_mean(loss, groups, n_data, weight)
        metrics = {k: _data_mean(v, groups, n_data, weight if k == "ce" else None)
                   for k, v in metrics.items()}
        step = state["opt"]["step"]
        with obs.range("train.optimizer"):
            lr_scale = schedule(step.to_local() if is_dtensor(step) else step,
                                warmup_steps=train_cfg.warmup_steps,
                                total_steps=train_cfg.total_steps)
            new_opt, new_params, stats = adamw_update(state["opt"], grads, opt_cfg,
                                                      lr_scale=lr_scale,
                                                      param_shardings=p_shardings)
        return {"params": new_params, "opt": new_opt}, {"loss": loss, **metrics, **stats}

    return sharded_step_fn


def init_state(cfg: ModelConfig, seed: int = 0, *, params: Tree | None = None, device="cuda",
               compute_dtype=torch.bfloat16, rules=None) -> dict:
    """{params: bf16, opt: adamw_init(master)}: the master weights drawn
    from ``torch.Generator(device)`` seeded with ``seed`` at the reference's
    scales, or ``params`` (a reference-layout tree, such as the
    reference's ``init_params``) as the master.  Under ``rules`` every
    rank draws the same state and keeps its chunk of each leaf
    (``distributed.elastic.state_shardings``)."""
    dev = resolve_device(device)
    specs = api.model_specs(cfg)
    if params is None:
        master = init_params(specs, torch.Generator(device=dev).manual_seed(seed), dev)
    else:
        master = transformer.params_to_tensors(specs, params, dev)
    opt = adamw_init(master)
    del master
    state = {"params": tree_map(lambda p: p.to(compute_dtype), opt["master"]), "opt": opt}
    if rules is None:
        return state
    from repro_torch.distributed.elastic import reshard_state, state_shardings

    return reshard_state(state, state_shardings(cfg, rules))


class _StepTimer:
    """The seconds of the work run inside it.  On a card, CUDA events on
    the current stream: work queued before it is not counted, however far
    the host ran ahead.  On the host, ``perf_counter``; the work inside
    must end with its outputs ready (a ``float()`` of them)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.seconds = float("nan")

    def __enter__(self) -> "_StepTimer":
        if self.cuda:
            self._events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            self._events[0].record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.cuda:
            start, end = self._events
            end.record()
            end.synchronize()
            self.seconds = start.elapsed_time(end) / 1e3
        else:
            self.seconds = time.perf_counter() - self._t0


class Trainer:
    """Checkpoint/restart training loop on ``device``.

    Fault tolerance: SIGTERM/SIGINT set a flag, and the step in flight ends
    with a final checkpoint; on start, the latest checkpoint (params,
    optimizer *and loader state*) is restored so a killed run resumes
    exactly where it stopped.  ``history`` keeps the metrics of every
    ``log_every``-th step (and the first), as floats, with the step and its
    seconds (``sec_per_step``: the logged step alone, from CUDA events on
    its stream on a card).  Under ``rules`` every rank of the mesh runs a Trainer over a
    loader of the same seed; a checkpoint is gathered on every rank and
    written by rank 0, and a restart restores it onto the rules' mesh
    (``distributed.elastic.restore_for_mesh``).  Since such a save is a
    collective, the ranks agree after each step whether any of them was
    signalled (a one-element all-reduce), and all save and stop together.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        opt_cfg: AdamWConfig,
        train_cfg: TrainConfig,
        loader,                       # RSPLoader-compatible (next_batch/state_dict)
        ckpt_dir: str,
        *,
        device="cuda",
        rules=None,
        batch_transform: Callable | None = None,
    ):
        self.cfg, self.opt_cfg, self.train_cfg = cfg, opt_cfg, train_cfg
        self.loader = loader
        self.ckpt_dir = ckpt_dir
        self.device = resolve_device(device)
        self.rules = rules
        self.batch_transform = batch_transform or (lambda b: b)
        self.step_fn = make_train_step(cfg, opt_cfg, train_cfg, rules=rules)
        self.checkpointer = ckpt.AsyncCheckpointer(ckpt_dir, keep_last=train_cfg.keep_checkpoints)
        self.history: list[dict] = []
        self._preempted = False

    def _install_signal_handlers(self) -> dict:
        def handler(signum, frame):
            self._preempted = True

        previous = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                previous[sig] = signal.signal(sig, handler)
            except ValueError:
                pass  # not on the main thread
        return previous

    def run(self, state: dict | None = None, *, stop_after_steps: int | None = None) -> dict:
        """``stop_after_steps`` emulates preemption after N steps (the final
        checkpoint is written exactly as the SIGTERM path would)."""
        previous = self._install_signal_handlers()
        try:
            return self._run(state, stop_after_steps)
        finally:
            for sig, h in previous.items():
                signal.signal(sig, h)

    def _run(self, state: dict | None, stop_after_steps: int | None) -> dict:
        start_step = 0
        if state is None:
            latest = ckpt.latest_step(self.ckpt_dir)
            if latest is not None:
                if self.rules is None:
                    state, extra = ckpt.restore(self.ckpt_dir, latest, device=self.device)
                else:
                    from repro_torch.distributed.elastic import restore_for_mesh

                    state, extra = restore_for_mesh(self.ckpt_dir, latest, self.cfg, self.rules,
                                                    like=None)
                self.loader.load_state_dict(extra["loader"])
                start_step = latest
            else:
                state = init_state(self.cfg, self.train_cfg.seed, device=self.device,
                                   rules=self.rules)

        for step in range(start_step, self.train_cfg.total_steps):
            if stop_after_steps is not None and step - start_step >= stop_after_steps:
                self._preempted = True
                self.checkpointer.save(step, state, extra={"loader": self.loader.state_dict()})
                break
            batch = self.batch_transform(self.loader.next_batch())
            if (step + 1) % self.train_cfg.log_every == 0 or step == start_step:
                with _StepTimer(self.device) as timer:
                    state, metrics = self.step_fn(state, batch)
                    metrics = {k: float(v) for k, v in metrics.items()}   # waits for the step
                metrics.update(step=step + 1, sec_per_step=timer.seconds)
                self.history.append(metrics)
            else:
                state, metrics = self.step_fn(state, batch)
            # under rules a save is a collective: every rank stops at the
            # step on which any rank saw the signal
            stop = self._preempted if self.rules is None else _any_rank(self._preempted,
                                                                         self.rules.mesh)
            if (step + 1) % self.train_cfg.checkpoint_every == 0 or stop:
                self.checkpointer.save(step + 1, state,
                                       extra={"loader": self.loader.state_dict()})
            if stop:
                break
        self.checkpointer.wait()
        return state
