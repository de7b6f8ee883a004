from repro_torch.train.loop import (
    TrainConfig,
    Trainer,
    init_state,
    make_train_step,
    param_grads,
)

__all__ = [k for k in dir() if not k.startswith("_")]
