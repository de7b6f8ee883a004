"""The scoring driver: forward-only calls of the program's
``make_forward_fn`` on a model built over the benchmark's float32 weights
(the type the program serves), under ``torch.inference_mode()``, each call
``batch`` corpus rows from the program's ``RSPLoader`` and every
position's logits out.

Which answers are compared is drawn from the seed before the window:
``sample_calls`` call indices among the first ``sample_range`` calls and
``sample_rows`` rows of each.  Those rows' logits are copied, as the
calls make them, into a buffer allocated at set-up.  After the window and
once the program's model is freed, the plain reference scores the same
corpus rows from the same weights, and the numbers compared are:

  logit_rms_gap        the root mean square of the logit gaps over that of
                       the reference's logits about their mean
  rows_not_in_corpus   rows of the compared calls that are no corpus row
  partition_defects    rows by which the RSP blocks miss being a partition
  sampled_calls_missed compared calls that the window never made
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.drivers import common
from portbench.drivers.train import model_config
from portbench.reference.common import Precision, no_tf32

SAMPLE_STREAM = 0x5A3F
WARMUP_CALLS = 2


def logit_gaps(parts) -> dict:
    """``logit_rms_gap`` from (side, reference) pairs of float32 logits of
    the same rows."""
    sq = ref_sq = ref_sum = count = 0.0
    for side, ref in parts:
        sq += float(((side - ref).double() ** 2).sum())
        ref_sum += float(ref.double().sum())
        ref_sq += float((ref.double() ** 2).sum())
        count += ref.numel()
    if not count:
        return {"logit_rms_gap": float("nan")}
    var = ref_sq / count - (ref_sum / count) ** 2
    return {"logit_rms_gap": (sq / count / var) ** 0.5}


class Cell:
    """One scoring cell: ``step()`` is one scoring call of the window."""

    def __init__(self, run):
        from repro_torch.models.api import make_forward_fn
        from repro_torch.models.transformer import build_lm

        self.run = run
        cfg, traffic = run.config["run"], run.workload["traffic"]
        self.cfg, self.traffic = cfg, traffic
        self.ref = common.reference_module(run.config)
        self.specs = self.ref.leaf_specs(cfg)
        self.data = common.make_data(traffic, cfg["vocab_size"], run.seed, run.device)
        self.loader = common.make_loader(self.data, traffic["batch"], run.seed, run.device)
        weights = common.make_weights(self.specs, run.seed, run.device)
        self.model = build_lm(model_config(cfg), weights, device=run.device)
        del weights
        self.forward = make_forward_fn(self.model)
        B, S, V = traffic["batch"], traffic["length"] - 1, cfg["vocab_size"]
        self.tokens = B * S

        rng = np.random.default_rng(common.stream_seed(run.seed, SAMPLE_STREAM))
        calls = rng.choice(traffic["sample_range"], traffic["sample_calls"], replace=False)
        self.sample = {int(c): np.sort(rng.choice(B, traffic["sample_rows"], replace=False))
                       for c in calls}
        n = traffic["sample_calls"] * traffic["sample_rows"]
        self.kept_logits = torch.empty((n, S, V), dtype=torch.bfloat16, device=run.device)
        # every row of a compared call is checked against the corpus
        self.kept_batches = torch.zeros((traffic["sample_calls"], B, S + 1), dtype=torch.int32,
                                        device=run.device)
        self.slot = {c: k * traffic["sample_rows"] for k, c in enumerate(sorted(self.sample))}
        self.calls = -WARMUP_CALLS
        for _ in range(WARMUP_CALLS):
            self.step()

    # -- the timed path -----------------------------------------------------
    def step(self) -> int:
        with self.run.span("loader"):
            batch = self.loader.next_batch()
            if self.run.fault == "token":
                batch = batch.clone()
                batch[0, 5] = (batch[0, 5] + 1) % self.cfg["vocab_size"]
        with self.run.span("step"), torch.inference_mode():
            tokens = batch[:, :-1].to(torch.int32)
            if self.run.fault == "half_batch":      # half the rows left out
                half = self.forward({"tokens": tokens[: tokens.shape[0] // 2]})
                logits = torch.cat([half, torch.zeros_like(half)])
            else:
                logits = self.forward({"tokens": tokens})
            if self.run.fault == "answer":          # an answer altered where it is made
                logits[:, 7] = logits[:, 7].roll(1, dims=-1)
            rows = self.sample.get(self.calls)
            if rows is not None:
                at = self.slot[self.calls]
                sel = torch.as_tensor(rows, device=logits.device)
                self.kept_logits[at:at + len(rows)] = logits.index_select(0, sel)
                self.kept_batches[at // len(rows)] = batch
        self.calls += 1
        return self.tokens

    def close(self) -> None:
        """Frees the program's model."""
        self.loader.close()
        del self.model, self.forward, self.loader
        common.free_device()

    # -- the comparison -------------------------------------------------------
    def check(self) -> dict:
        no_tf32()
        device = self.run.device
        done = [c for c in sorted(self.sample) if c < self.calls]
        batches = self.kept_batches[:len(done)].cpu().numpy()
        rows = np.concatenate([batches[k][self.sample[c]] for k, c in enumerate(done)]
                              or [np.zeros((0, batches.shape[-1]), np.int32)])
        idx, _ = common.corpus_rows(self.data, rows)
        _, missing = common.corpus_rows(self.data, batches.reshape(-1, batches.shape[-1]))
        weights = common.make_weights(self.specs, self.run.seed, device)
        sides = {"program": [], "control": []}
        with torch.no_grad():
            for k, i in enumerate(idx):
                row = self.data.corpus[i] if i >= 0 else rows[k]
                tokens = torch.from_numpy(row[None, :-1]).to(device)
                ref = self.ref.logits(weights, tokens, self.cfg, Precision())[0]
                sides["program"].append((self.kept_logits[k].float(), ref))
                if self.run.control:
                    low = self.ref.logits(weights, tokens, self.cfg, Precision(self.run.control))
                    sides["control"].append((low[0], ref))
        numbers = logit_gaps(sides["program"])
        if self.run.control:
            self.run.control_numbers = logit_gaps(sides["control"])
        del weights, sides
        common.free_device()
        numbers["rows_not_in_corpus"] = missing
        numbers["partition_defects"] = common.partition_defects(self.data)
        numbers["sampled_calls_missed"] = len(self.sample) - len(done)
        return numbers
