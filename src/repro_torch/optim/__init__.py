from repro_torch.optim.optimizers import (
    Optimizer,
    adamw,
    clip_by_global_norm,
    get,
    rmsprop,
    sgd,
)

__all__ = ["Optimizer", "adamw", "clip_by_global_norm", "get", "rmsprop",
           "sgd"]
