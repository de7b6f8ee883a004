"""Small configurations and traffic for runs of a cell on the host."""

from __future__ import annotations

import copy
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for path in (ROOT / "src", ROOT):
    if str(path) not in sys.path:
        sys.path.insert(0, str(path))

from portbench import run as harness  # noqa: E402

SMALL = {
    "rwkv": {"num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 4, "d_ff": 96,
             "vocab_size": 256, "rwkv_head_dim": 16, "lora_rank": 8},
    "hybrid": {"num_layers": 4, "d_model": 64, "num_heads": 4, "num_kv_heads": 4, "d_ff": 96,
               "vocab_size": 256, "ssm_state": 16, "ssm_head_dim": 16, "attn_every": 2,
               "ssm_chunk": 8},
}
CELLS = ["zamba2-7b-24l.train-8x2048", "rwkv6-1.6b.score-16x2048"]
CONFIGS = ["rwkv6-1.6b", "zamba2-7b-24l"]


def config(name: str) -> dict:
    """A configuration file of the benchmark, by name."""
    import json

    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def small(name: str) -> tuple[dict, dict]:
    """The cell's configuration and workload cut to a host-sized run: the
    same files, every width and count shrunk, the same limits."""
    _, _, workload, config = harness.load_cell(name)
    config, workload = copy.deepcopy(config), copy.deepcopy(workload)
    config["run"].update(SMALL[config["run"]["family"]])
    batch = 4 if workload["driver"] == "train" else 8
    workload["traffic"].update(sequences=64, length=33, blocks=4, batch=batch)
    return config, workload


def run_small(name: str, seed: int, *, fault=None, control=None, seconds: float = 0.5,
              judge: bool = True) -> dict:
    import time

    import torch

    config, workload = small(name)
    if workload["driver"] == "score":
        seconds = max(seconds, 2.0)      # past the sampled calls
    return harness.run_cell(name, seed, seconds, False, device=torch.device("cpu"),
                            config=config, workload=workload, fault=fault, control=control,
                            judge=judge, t0=time.perf_counter())
