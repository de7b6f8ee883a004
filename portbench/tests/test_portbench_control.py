"""The comparison that decides ``correct`` fails where it must.

On the host, at a small size, every cell's run with its timed path broken
underneath comes out not correct under the cell's own limits: a step that
returns its state unchanged, half of the batch left out (the mean over the
rest), a token altered where the loader makes it, an answer altered where
the forward makes it.  (No cell runs across chips, so no exchange can be
left out.)  On the card, at the cell's own size and on three seeds, the
control -- the plain reference in fp8 put in the program's place -- comes
out not correct under the same limits."""

from __future__ import annotations

import pytest
import torch

from portbench.tests.helpers import CELLS, harness, run_small

FAULTS = {
    "zamba2-7b-24l.train-8x2048": ("stale_state", "half_batch", "token"),
    "rwkv6-1.6b.score-16x2048": ("half_batch", "token", "answer"),
}


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS for f in FAULTS[c]])
def test_a_broken_timed_path_is_not_correct(name, fault):
    clean = run_small(name, 20240002)["checks"]
    res = run_small(name, 20240002, fault=fault)
    assert res["correct"] is False, res["checks"]
    # a compared number the fault moves past the cell's limit and well past
    # the unbroken run's reading at this size
    moved = [k for k, c in res["checks"].items()
             if c["value"] > c["limit"] and c["value"] > 2 * clean[k]["value"]]
    assert moved, (res["checks"], clean)


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    limits = harness.load_cell(name)[2]["limits"]
    for seed in (11, 12, 13):
        res = harness.run_cell(name, seed, 5.0, False, control="fp8", judge=False)
        low = res["control"]
        assert any(v > limits[k] for k, v in low.items()), low
