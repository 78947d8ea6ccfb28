"""Optimizers over dicts of torch tensors (the paper's RL configurator uses
rmsprop(lr=1e-3), paper §3).

Only ``rmsprop`` is ported so far; ``adamw``/``sgd`` serve the LM side
(ROADMAP queue 1, item 8).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[dict], dict]
    update: Callable[[dict, dict, dict], tuple[dict, dict]]
    name: str


def rmsprop(lr: float = 1e-3, decay: float = 0.9, eps: float = 1e-8) -> Optimizer:
    """Classic rmsprop — the paper's policy-network optimizer (§3). As in
    the reference, ``eps`` is added OUTSIDE the square root:
    ``p - lr·g / (sqrt(nu) + eps)``. Functional: returns new tensors."""

    def init(params: dict) -> dict:
        return {"nu": {k: torch.zeros_like(p, dtype=torch.float32)
                       for k, p in params.items()},
                "count": torch.zeros((), dtype=torch.int32,
                                     device=next(iter(params.values())).device)}

    def update(grads: dict, state: dict, params: dict):
        nu = {k: decay * state["nu"][k] + (1 - decay) * torch.square(g)
              for k, g in grads.items()}
        new_params = {k: p - lr * grads[k] / (torch.sqrt(nu[k]) + eps)
                      for k, p in params.items()}
        return new_params, {"nu": nu, "count": state["count"] + 1}

    return Optimizer(init, update, "rmsprop")
