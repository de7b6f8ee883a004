"""Serving launcher: restore a checkpoint (or draw seeded random weights)
and decode batched requests on the card; ``--ensemble k`` serves the RSP
block ensemble (Sec. 9's combination at decode time).

    python -m repro_torch.launch.serve --arch llama3.2-1b --preset full
    python -m repro_torch.launch.serve --arch zamba2-7b --preset full
    python -m repro_torch.launch.serve --arch zamba2-7b --device cpu
    python -m repro_torch.launch.serve --arch rwkv6-1.6b --preset full
    python -m repro_torch.launch.serve --arch granite-moe-3b-a800m --preset full
    python -m repro_torch.launch.serve --arch qwen3-moe-30b-a3b --device cpu

Prints tokens per second beside the device's name.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import store as ckpt
from repro_torch.configs import ARCHS, smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.transformer import build_lm
from repro_torch.serve.engine import EnsembleServer, ServeConfig, Server


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (host)"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default="qwen2-0.5b")
    ap.add_argument("--preset", choices=("cpu-small", "full"), default="cpu-small")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ensemble", type=int, default=0, help="serve k base models averaged")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    ap.add_argument("--device", default="cuda", help="cuda (default) | cuda:N | cpu")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = ARCHS[args.arch] if args.preset == "full" else smoke_config(args.arch)
    k = max(args.ensemble, 1)
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        state, _ = ckpt.restore(args.ckpt_dir, device=device)
        models = [build_lm(cfg, state["params"], device=device)] * k
        print(f"restored step {ckpt.latest_step(args.ckpt_dir)} from {args.ckpt_dir}")
    else:
        models = [build_lm(cfg, device=device, seed=args.seed + i) for i in range(k)]

    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt_len), np.int32)
    sc = ServeConfig(temperature=args.temperature)
    if args.ensemble > 1:
        server = EnsembleServer(cfg, models, sc, device=device)
        label = f"ensemble[{args.ensemble}]"
    else:
        server = Server(cfg, models[0], sc, device=device)
        label = "single"

    t0 = time.perf_counter()
    out = server.generate(prompts, max_new_tokens=args.new_tokens)
    dt = time.perf_counter() - t0
    tps = args.batch * args.new_tokens / dt
    print(f"{label} {cfg.name} on {device_name(device)}: generated {out.shape} in {dt:.2f}s"
          f" ({tps:.1f} tok/s)")
    for row in out[:2]:
        print("  ", row.tolist())


if __name__ == "__main__":
    main()
