"""llama3.2-1b's training loss curves at full width and depth on one card,
batch 8 x 2048 at lr 3e-4, through chip_smoke.py's training phase (the
Trainer, the RSP loader, the flash kernels): the drifting token corpus and
the one without drift, under several warmups and horizons.

    python3 train_curves.py                      # the four runs below
    python3 train_curves.py --run drift,2,60     # corpus,warmup,steps

Each run starts from the same seeded state; every step's loss, gradient
norm and learning rate is printed as one JSON line.  About two minutes on
an H100.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RUNS = ("drift,2,20", "none,10,20", "drift,10,20", "drift,2,60")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--run", action="append", help="corpus (drift|none),warmup,steps")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as smoke
    from repro_torch.configs import ARCHS
    from repro_torch.train import init_state

    if not torch.cuda.is_available():
        print("train_curves: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    gpu = smoke.nvidia_smi()
    print(gpu, flush=True)
    cfg = ARCHS[smoke.TRAIN_ARCH]
    smoke.LOSS_DROP, smoke.DRIFT_RISE = -float("inf"), float("inf")   # measured, not gated
    tmp = tempfile.mkdtemp(prefix="rsp_curves_")
    try:
        for run in args.run or RUNS:
            corpus, warmup, steps = run.split(",")
            smoke.TRAIN_WARMUP, smoke.TRAIN_STEPS = int(warmup), int(steps)
            loader = smoke.token_loader(cfg.vocab_size, smoke.TRAIN_SEQ + 1, args.seed, device,
                                        corpus == "drift")
            out = smoke.trained(f"{corpus} corpus, warmup {warmup}", cfg,
                                init_state(cfg, args.seed, device=device), loader,
                                lambda b: {"tokens": b.to(torch.int32)}, device, gpu, tmp,
                                args.seed)[1]          # the trained state is dropped here
            loader.close()
            print(json.dumps({"corpus": corpus, "warmup": int(warmup), "steps": int(steps),
                              "losses": out["losses"],
                              "grad_norms": [float(x) for x in out["grad_norms"]],
                              "lrs": [float(x) for x in out["lrs"]], "card": gpu}), flush=True)
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
