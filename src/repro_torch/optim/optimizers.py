"""Optimizers over trees of torch tensors (nested dicts and lists, the
port's parameter trees): the reference's ``repro.optim.optimizers``. The
paper's RL configurator uses rmsprop(lr=1e-3) (paper §3); ``adamw`` and
``sgd`` train the LM (``distribution/steps.py::make_train_step``).

Each update computes in f32 and casts back to the leaf's dtype, as the
reference does, so bf16 parameters take f32 moments, and ``moment_dtype``
makes the moments' precision a lever (``"bfloat16"``). Functional: an
update returns new tensors and leaves its inputs as they were.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils import global_norm, tree_leaves, tree_map

PyTree = Any


class Optimizer(NamedTuple):
    init: Callable[[PyTree], PyTree]
    update: Callable[[PyTree, PyTree, PyTree], tuple[PyTree, PyTree]]
    name: str


def clip_by_global_norm(grads: PyTree, max_norm: float) -> PyTree:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads)


def _count(params: PyTree) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def rmsprop(
    lr: float = 1e-3,
    decay: float = 0.9,
    eps: float = 1e-8,
    moment_dtype: str = "float32",
    grad_clip: float = 0.0,
) -> Optimizer:
    """Classic rmsprop — the paper's policy-network optimizer (§3). As in
    the reference, ``eps`` is added OUTSIDE the square root:
    ``p - lr·g / (sqrt(nu) + eps)``."""
    mdt = getattr(torch, moment_dtype)

    def init(params):
        return {"nu": tree_map(lambda p: torch.zeros_like(p, dtype=mdt),
                               params),
                "count": _count(params)}

    def update(grads, state, params):
        if grad_clip:
            grads = clip_by_global_norm(grads, grad_clip)
        nu = tree_map(
            lambda n, g: (decay * n.float()
                          + (1 - decay) * torch.square(g.float())).to(mdt),
            state["nu"], grads)
        new_params = tree_map(
            lambda p, g, n: (p.float() - lr * g.float()
                             / (torch.sqrt(n.float()) + eps)).to(p.dtype),
            params, grads, nu)
        return new_params, {"nu": nu, "count": state["count"] + 1}

    return Optimizer(init, update, "rmsprop")


def adamw(
    lr: float = 3e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    moment_dtype: str = "float32",
    grad_clip: float = 1.0,
) -> Optimizer:
    """AdamW with bias correction. Weight decay applies to every leaf with
    two or more dimensions AS STORED: a stacked layer tree's (L, d) norm
    scales are decayed, a layer list's (d,) ones are not (the reference's
    rule, on the same layouts)."""
    mdt = getattr(torch, moment_dtype)

    def init(params):
        z = lambda p: torch.zeros_like(p, dtype=mdt)
        return {"mu": tree_map(z, params), "nu": tree_map(z, params),
                "count": _count(params)}

    def update(grads, state, params):
        if grad_clip:
            grads = clip_by_global_norm(grads, grad_clip)
        cnt = state["count"] + 1
        mu = tree_map(
            lambda m, g: (b1 * m.float() + (1 - b1) * g.float()).to(mdt),
            state["mu"], grads)
        nu = tree_map(
            lambda n, g: (b2 * n.float()
                          + (1 - b2) * torch.square(g.float())).to(mdt),
            state["nu"], grads)
        c1 = 1.0 - b1 ** cnt.float()
        c2 = 1.0 - b2 ** cnt.float()

        def step(p, m, n):
            mh = m.float() / c1
            nh = n.float() / c2
            upd = mh / (torch.sqrt(nh) + eps)
            if p.ndim >= 2 and weight_decay:  # decay matrices only
                upd = upd + weight_decay * p.float()
            return (p.float() - lr * upd).to(p.dtype)

        new_params = tree_map(step, params, mu, nu)
        return new_params, {"mu": mu, "nu": nu, "count": cnt}

    return Optimizer(init, update, "adamw")


def sgd(lr: float = 1e-2, momentum: float = 0.9,
        grad_clip: float = 0.0) -> Optimizer:
    def init(params):
        return {"mu": tree_map(torch.zeros_like, params),
                "count": _count(params)}

    def update(grads, state, params):
        if grad_clip:
            grads = clip_by_global_norm(grads, grad_clip)
        mu = tree_map(lambda m, g: momentum * m + g.to(m.dtype),
                      state["mu"], grads)
        new_params = tree_map(lambda p, m: (p - lr * m).to(p.dtype),
                              params, mu)
        return new_params, {"mu": mu, "count": state["count"] + 1}

    return Optimizer(init, update, "sgd")


def get(name: str, **kw) -> Optimizer:
    return {"rmsprop": rmsprop, "adamw": adamw, "sgd": sgd}[name](**kw)
