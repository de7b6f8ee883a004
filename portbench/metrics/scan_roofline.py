"""scan_roofline.train / .score: the configuration's scan (rwkv6's WKV,
the hybrid's SSD) against its roofline, forward and backward calls
together (``roofline.py``)."""

from portbench.metrics.roofline import backward_names, share
from portbench.work.ssd import ssd_bwd_work, ssd_work
from portbench.work.wkv import wkv_bwd_work, wkv_work

ENTRIES = {"wkv6": "repro_torch.models.rwkv6:wkv6", "ssd": "repro_torch.models.mamba2:ssd"}


def read(ctx):
    cfg, t = ctx.config, ctx.workload["traffic"]
    B, T = t["batch"], t["length"] - 1
    train = ctx.metric.endswith(".train")
    if cfg["family"] == "rwkv":
        C = cfg.get("rwkv_head_dim", 64)
        H = cfg["d_model"] // C
        return share(ctx, "wkv6", backward_names("WKV6"), wkv_work(B, T, H, C),
                     wkv_bwd_work(B, T, H, C) if train else None)
    if cfg["family"] == "hybrid":
        P, N, Q = cfg.get("ssm_head_dim", 64), cfg["ssm_state"], cfg.get("ssm_chunk", 128)
        H = cfg.get("ssm_expand", 2) * cfg["d_model"] // P
        return share(ctx, "ssd", backward_names("SSDScan"), ssd_work(B, T, H, P, N, Q),
                     ssd_bwd_work(B, T, H, P, N, Q) if train else None)
    return None
