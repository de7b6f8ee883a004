from repro_torch.optim.adamw import (
    AdamWConfig,
    adamw_init,
    adamw_update,
    clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.schedule import SCHEDULES, constant, linear_decay, warmup_cosine

__all__ = [k for k in dir() if not k.startswith("_")]
