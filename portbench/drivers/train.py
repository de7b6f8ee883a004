"""The training driver: the program's ``make_train_step`` over
``init_state(cfg, params=<the benchmark's weights>)``, fed by the
program's ``RSPLoader`` with block-level samples of the seed's corpus.

Set-up builds the one step function and state, and drives them through
``CHECKED_STEPS`` steps by the window's own call and feed (they are the
warm-up too): each step's loss, the first gradient's norm per leaf as the
optimizer took it in (its first moment after one step over ``1 - b1``,
over the step's clip scale) and,
after the last of them, each leaf's change from the weights drawn, are
read before the window goes on with the same state.  After the window and
once the program's state is freed, the plain reference follows the same
steps from the same weights on the same corpus rows, and the numbers
compared are:

  loss_gap            the largest |loss - reference loss| over the steps
  grad_norm_gap       the worst leaf's gap of first-gradient norms
  update_norm_gap     the worst leaf's gap of change norms (leaves whose
                      reference gradient is under 1e-3 of the median leaf's
                      are left out: round-off alone moves them under Adam)
  rows_not_in_corpus  batch rows of those steps that are no corpus row
  partition_defects   rows by which the RSP blocks miss being a partition
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.drivers import common
from portbench.reference.adamw import AdamW
from portbench.reference.common import Precision, iter_paths, no_tf32, set_path

CHECKED_STEPS = 3
MOVED = 1e-3            # a leaf moves when its reference gradient is above this share of the median


def model_config(cfg: dict):
    from repro_torch.models.config import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in cfg.items() if k in names})


def reference_steps(ref, specs, cfg: dict, seed: int, device, batches: list[torch.Tensor],
                    opt: dict, prec: Precision) -> dict:
    """The plain reference's training from the seed's weights over
    ``batches``: each step's loss, the first gradient's norm per leaf
    (before the clipping) and each leaf's change after the last step."""
    tree = common.make_weights(specs, seed, device)
    params = [leaf.clone().requires_grad_(True) for _, leaf in iter_paths(tree)]
    del tree
    tree = {}
    for spec, p in zip(specs, params):
        path = spec[0]
        set_path(tree, path, p)
    adam = AdamW(params, **opt)
    losses, first = [], None
    for tokens in batches:
        loss = ref.loss(tree, tokens, cfg, prec)
        loss.backward()
        norms = adam.step([p.grad for p in params])
        for p in params:
            p.grad = None
        losses.append(float(loss.detach()))
        if first is None:
            first = [float(n) for n in norms]
    del adam
    common.free_device()
    init = common.make_weights(specs, seed, device)
    change = [float(torch.linalg.vector_norm(p.detach() - leaf))
              for p, (_, leaf) in zip(params, iter_paths(init))]
    del init, params, tree
    common.free_device()
    return {"losses": losses, "grad_norms": first, "change_norms": change}


def compare(prog: dict, ref: dict) -> dict:
    """The numbers compared between a side and the reference."""
    med = float(np.median(ref["grad_norms"]))
    moved = [g >= MOVED * med for g in ref["grad_norms"]]
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(prog["losses"], ref["losses"])),
        "grad_norm_gap": common.leaf_gap(prog["grad_norms"], ref["grad_norms"]),
        "update_norm_gap": common.leaf_gap(prog["change_norms"], ref["change_norms"], moved),
    }


class Cell:
    """One training cell: ``step()`` is one training step of the window."""

    def __init__(self, run):
        from repro_torch.optim import AdamWConfig
        from repro_torch.optim.adamw import leaves
        from repro_torch.train import TrainConfig, init_state, make_train_step

        self.run = run
        cfg, traffic = run.config["run"], run.workload["traffic"]
        self.cfg, self.traffic = cfg, traffic
        self.ref = common.reference_module(run.config)
        self.specs = self.ref.leaf_specs(cfg)
        self.opt = run.workload["optimizer"]
        sched = run.workload["schedule"]
        opt_cfg = AdamWConfig(**self.opt)
        self.step_fn = make_train_step(model_config(cfg), opt_cfg,
                                       TrainConfig(schedule="cosine",
                                                   warmup_steps=sched["warmup_steps"],
                                                   total_steps=sched["total_steps"]))
        self.opt = {**self.opt, **sched}
        self.data = common.make_data(traffic, cfg["vocab_size"], run.seed, run.device)
        self.loader = common.make_loader(self.data, traffic["batch"], run.seed, run.device)
        weights = common.make_weights(self.specs, run.seed, run.device)
        self.state = init_state(model_config(cfg), params=weights, device=run.device)
        del weights
        self.tokens = traffic["batch"] * (traffic["length"] - 1)

        rows, losses = [], []
        for i in range(CHECKED_STEPS):
            batch = self._batch()
            rows.append(batch.cpu().numpy())
            self.state, metrics = self._step(batch)
            losses.append(metrics["loss"])
            if i == 0:
                # m = (1 - b1) x the clipped gradient: the gradient as the
                # optimizer took it in, before its clipping by the global norm
                scale = min(1.0, opt_cfg.grad_clip / max(float(metrics["grad_norm"]), 1e-12))
                grad_norms = [float(torch.linalg.vector_norm(m)) / (1 - opt_cfg.b1) / scale
                              for m in leaves(self.state["opt"]["m"])]
        init = common.make_weights(self.specs, run.seed, run.device)
        change = [float(torch.linalg.vector_norm(m - leaf)) for m, (_, leaf) in
                  zip(leaves(self.state["opt"]["master"]), iter_paths(init))]
        del init
        self.rows = rows
        self.readings = {"losses": [float(x) for x in losses], "grad_norms": grad_norms,
                         "change_norms": change}
        common.free_device()

    # -- the timed path -----------------------------------------------------
    def _batch(self) -> torch.Tensor:
        batch = self.loader.next_batch()
        if self.run.fault == "token":        # a token altered where the loader makes it
            batch = batch.clone()
            batch[0, 5] = (batch[0, 5] + 1) % self.cfg["vocab_size"]
        return batch

    def _step(self, batch: torch.Tensor):
        tokens = batch.to(torch.int32)
        if self.run.fault == "half_batch":   # half the rows left out, the mean over the rest
            tokens = tokens[: tokens.shape[0] // 2]
        if self.run.fault == "stale_state":  # the step's new state dropped
            from repro_torch.optim.adamw import tree_map

            copy = {"params": tree_map(torch.clone, self.state["params"]),
                    "opt": tree_map(torch.clone, self.state["opt"])}
            _, metrics = self.step_fn(copy, {"tokens": tokens})
            return self.state, metrics
        return self.step_fn(self.state, {"tokens": tokens})

    def step(self) -> int:
        with self.run.span("loader"):
            batch = self._batch()
        with self.run.span("step"):
            self.state, _ = self._step(batch)
        return self.tokens

    def close(self) -> None:
        """Frees the program's state."""
        self.loader.close()
        del self.state, self.step_fn, self.loader
        common.free_device()

    # -- the comparison -------------------------------------------------------
    def check(self) -> dict:
        no_tf32()
        device = self.run.device
        rows = np.concatenate(self.rows)
        idx, missing = common.corpus_rows(self.data, rows)
        batches = []
        for k, step_rows in enumerate(self.rows):
            n = step_rows.shape[0]
            picked = [self.data.corpus[i] if i >= 0 else r
                      for i, r in zip(idx[k * n:(k + 1) * n], step_rows)]
            batches.append(torch.from_numpy(np.stack(picked)).to(device))
        ref = reference_steps(self.ref, self.specs, self.cfg, self.run.seed, device, batches,
                              self.opt, Precision())
        numbers = compare(self.readings, ref)
        numbers["rows_not_in_corpus"] = missing
        numbers["partition_defects"] = common.partition_defects(self.data)
        sides = {"program": self.readings}
        if self.run.control:
            low = reference_steps(self.ref, self.specs, self.cfg, self.run.seed, device, batches,
                                  self.opt, Precision(self.run.control))
            self.run.control_numbers = compare(low, ref)
            sides["control"] = low
        if self.run.readings:
            self.run.detail = {"leaves": ["/".join(spec[0]) for spec in self.specs],
                               "reference": ref, **sides}
        return numbers
