from repro_torch.optim.optimizers import Optimizer, rmsprop

__all__ = ["Optimizer", "rmsprop"]
