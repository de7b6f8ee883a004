"""flash_roofline.train: causal attention (the program's FlashAttention)
against its roofline, forward and backward calls together, its products
at the bf16 peak (``roofline.py``)."""

from portbench.metrics.roofline import backward_names, share
from portbench.work.flash import flash_bwd_work, flash_work
from portbench.work.peaks import BF16_FLOPS

ENTRIES = {"flash_attention": "repro_torch.models.attention:flash_attention"}


def read(ctx):
    cfg, t = ctx.config, ctx.workload["traffic"]
    B, S = t["batch"], t["length"] - 1
    H = cfg["num_heads"]
    Hkv = cfg.get("num_kv_heads", H)
    D = cfg["d_model"] // H
    train = ctx.metric.endswith(".train")
    return share(ctx, "flash_attention", backward_names("FlashAttention"),
                 flash_work(B, H, Hkv, S, D, True, lse=train),
                 flash_bwd_work(B, H, Hkv, S, D, True) if train else None, BF16_FLOPS)
