"""The port's steps: the train step of ``repro.distribution.steps`` on one
device.

``make_train_step`` returns a ``StepBundle``: the step function, its
argument specs (the parameter tree, the optimizer state and the batch as
tensors on the ``meta`` device: shapes and dtypes, no data) and ``meta``.
The reference's bundle also carries the in/out shardings and donated
arguments that ``jit()`` / ``lower()`` compile for a mesh; one card has no
mesh and PyTorch compiles nothing, so the port keeps neither and
``bundle.fn`` is called directly. Meshes and expert parallelism wait for
the fleet mesh (ROADMAP queue 1, item 7).

The step is the reference's: the loss and its gradients
(``lm.forward_train`` under autograd, each layer under ``cfg.remat``),
then ``opt.update``. ``accum_steps > 1`` runs the micro-batches in order,
sums their gradients from zeros (in the parameters' dtype), divides by
``accum_steps`` and averages the metrics, as the reference's scan does.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.data.synthetic import batch_spec
from repro_torch.models import lm
from repro_torch.optim import Optimizer
from repro_torch.utils import (resolve_device, tree_leaves, tree_map,
                               tree_zeros_like)

PyTree = Any


@dataclass
class StepBundle:
    fn: Callable
    arg_specs: tuple          # meta-device tensors: the arguments' shapes
    meta: dict = dataclasses.field(default_factory=dict)


def _no_mesh(mesh, ep: bool) -> None:
    if mesh is not None or ep:
        raise NotImplementedError(
            "meshes and expert parallelism wait for the fleet mesh (ROADMAP "
            "queue 1, item 7); the port's steps run on one device")


def _grads(cfg: ModelConfig, params: PyTree, batch: dict):
    """(loss metrics, gradient tree) of ``lm.forward_train`` at ``params``."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = lm.forward_train(leaves, cfg, batch)
    gs = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                  materialize_grads=True))
    return ({k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(gs), leaves))


def make_train_step(
    cfg: ModelConfig,
    opt: Optimizer,
    shape: InputShape,
    *,
    accum_steps: int = 1,
    device=None,
    mesh=None,
    ep: bool = False,
) -> StepBundle:
    """The train step ``fn(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on ``device`` (``cuda`` unless another device is named; its
    inputs must lie there)."""
    _no_mesh(mesh, ep)
    device = resolve_device(device, "make_train_step")
    params_shape = lm.init_params(cfg, None, device="meta")
    opt_shape = opt.init(params_shape)
    bshape = batch_spec(cfg, shape.global_batch, shape.seq_len)

    def check(params):
        got = tree_leaves(params)[0].device
        if got != device and not (device.index is None
                                  and got.type == device.type):
            raise ValueError(f"the train step runs on {device}; its "
                             f"parameters are on {got}")

    if accum_steps == 1:
        def train_step(params, opt_state, batch):
            check(params)
            metrics, grads = _grads(cfg, params, batch)
            with torch.no_grad():
                new_params, new_opt = opt.update(grads, opt_state, params)
            return new_params, new_opt, metrics
    else:
        if shape.global_batch % accum_steps:
            raise ValueError(f"batch {shape.global_batch} does not split "
                             f"into {accum_steps} micro-batches")

        def train_step(params, opt_state, batch):
            check(params)
            micro = {k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                                  + v.shape[1:]) for k, v in batch.items()}
            grads = tree_zeros_like(params)
            mets = []
            for i in range(accum_steps):
                m, g = _grads(cfg, params, {k: v[i] for k, v in micro.items()})
                grads = tree_map(torch.add, grads, g)
                mets.append(m)
            with torch.no_grad():
                grads = tree_map(lambda g: g / accum_steps, grads)
                metrics = {k: torch.stack([m[k] for m in mets]).mean()
                           for k in mets[0]}
                new_params, new_opt = opt.update(grads, opt_state, params)
            return new_params, new_opt, metrics

    return StepBundle(
        fn=train_step,
        arg_specs=(params_shape, opt_shape, bshape),
        meta=dict(device=device, accum_steps=accum_steps),
    )


def make_prefill_step(cfg: ModelConfig, shape: InputShape, *,
                      max_seq: Optional[int] = None, **kw) -> StepBundle:
    raise NotImplementedError(
        "make_prefill_step comes with forward_decode (ROADMAP queue 1, item "
        "8.3); lm.forward_prefill runs on its own")


def make_decode_step(cfg: ModelConfig, shape: InputShape,
                     **kw) -> StepBundle:
    raise NotImplementedError(
        "make_decode_step comes with forward_decode (ROADMAP queue 1, item "
        "8.3)")


def make_step_for_cell(cfg: ModelConfig, shape: InputShape,
                       opt: Optional[Optimizer] = None, **kw) -> StepBundle:
    raise NotImplementedError(
        "make_step_for_cell comes with the dry-run launcher (ROADMAP queue "
        "1, item 8.5); use make_train_step")
