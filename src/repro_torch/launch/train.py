"""Training launcher.

Runs on the card unless ``--device cpu`` is asked for (reduced presets for
a local check).  Data always flows through the RSP loader: the corpus is
partitioned once (Algorithm 1, ``two_stage_partition_np``), batches are
block-level samples, and the O(1) sampler state rides in each checkpoint,
so a restart resumes exactly.  Every LM family trains (dense, MoE with
``--moe-groups`` dispatch groups, the zamba2 hybrid, RWKV6); the encoder
is refused, as the reference refuses it.

``--distributed`` initialises ``torch.distributed`` from the torchrun
environment (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``): NCCL on the card (one GPU a process, ``LOCAL_RANK``), gloo
with ``--device cpu``.  Like the reference's launcher it passes no rules:
every rank trains the whole batch on its own (each into
``<ckpt-dir>/rank<r>`` when there are several ranks).  Training under
sharding rules is ``Trainer(..., rules=default_rules(make_host_mesh(...)))``
(``distributed.sharding``, ``launch.mesh``).

    python -m repro_torch.launch.train --arch llama3.2-1b --device cpu \\
        --steps 50 --ckpt-dir /tmp/ckpt
    python -m repro_torch.launch.train --arch llama3.2-1b --preset full \\
        --batch 8 --seq 2048 --lr 3e-4 --steps 20 --ckpt-dir ckpt
    torchrun --nproc-per-node 2 -m repro_torch.launch.train --distributed \\
        --device cpu --steps 10 --ckpt-dir /tmp/ckpt

Prints the training history (JSON) and the device's name.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.configs import ARCHS, smoke_config
from repro_torch.core import RSPSpec, two_stage_partition_np
from repro_torch.data import BlockSource, RSPLoader
from repro_torch.data.synthetic import make_token_corpus
from repro_torch.device import resolve_device
from repro_torch.optim import AdamWConfig
from repro_torch.train import TrainConfig, Trainer


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=sorted(ARCHS), default="llama3.2-1b")
    ap.add_argument("--preset", choices=("cpu-small", "full"), default="cpu-small")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--moe-groups", type=int, default=1,
                    help="the MoE layers' dispatch groups (the capacity is per group)")
    ap.add_argument("--ckpt-dir", default="rsp_train_ckpt")
    ap.add_argument("--blocks", type=int, default=32)
    ap.add_argument("--sequences", type=int, default=1024,
                    help="corpus sequences, a multiple of --blocks squared (Algorithm 1)")
    ap.add_argument("--device", default="cuda", help="cuda (default) | cuda:N | cpu")
    ap.add_argument("--distributed", action="store_true",
                    help="initialise torch.distributed from the torchrun environment"
                         " (nccl on the card, gloo with --device cpu)")
    args = ap.parse_args(argv)

    cfg = ARCHS[args.arch] if args.preset == "full" else smoke_config(args.arch)
    if cfg.family == "encoder":
        raise SystemExit("use a masked-prediction loop for encoder archs (see tests)")
    device = resolve_device(args.device)
    ckpt_dir, where = args.ckpt_dir, ""
    if args.distributed:
        import torch.distributed as dist

        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
            torch.cuda.set_device(device)
            dist.init_process_group("nccl", device_id=device)
        else:
            dist.init_process_group("gloo")
        where = f" (rank {dist.get_rank()} of {dist.get_world_size()})"
        if dist.get_world_size() > 1:
            ckpt_dir = os.path.join(ckpt_dir, f"rank{dist.get_rank()}")

    corpus = make_token_corpus(
        args.sequences, args.seq + 1, vocab_size=cfg.vocab_size, seed=0, drift=True
    )
    spec = RSPSpec(
        num_records=args.sequences, num_blocks=args.blocks,
        num_original_blocks=args.blocks, seed=1,
    )
    blocks = two_stage_partition_np(corpus, spec)
    loader = RSPLoader(BlockSource(blocks=blocks, device=device), batch_size=args.batch, seed=5)

    tc = TrainConfig(
        total_steps=args.steps, warmup_steps=max(args.steps // 10, 1),
        checkpoint_every=max(args.steps // 4, 1), log_every=max(args.steps // 10, 1),
        microbatch=args.microbatch, moe_groups=args.moe_groups, seed=0,
    )
    trainer = Trainer(
        cfg, AdamWConfig(lr=args.lr), tc, loader, ckpt_dir, device=device,
        batch_transform=lambda b: {"tokens": b.to(torch.int32)},
    )
    try:
        trainer.run()
    finally:
        loader.close()
        if args.distributed:
            dist.destroy_process_group()
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (host)"
    print(f"{cfg.name} trained {args.steps} steps on {name}{where}")
    print(json.dumps(trainer.history, indent=1))


if __name__ == "__main__":
    main()
