"""The port's steps: the train, prefill and decode steps of
``repro.distribution.steps`` on one device.

Each ``make_*_step`` returns a ``StepBundle``: the step function, its
argument specs (the parameter tree, the optimizer state, the batch, the
tokens or the decode state, as tensors on the ``meta`` device: shapes and
dtypes, no data) and ``meta``.
The reference's bundle also carries the in/out shardings and donated
arguments that ``jit()`` / ``lower()`` compile for a mesh; one card has no
mesh and PyTorch compiles nothing, so the port keeps neither and
``bundle.fn`` is called directly. A mesh of one device
(``launch.mesh.make_local_mesh(1, 1)``) is the same as ``mesh=None``;
larger meshes and expert parallelism wait for the LM mesh (ROADMAP
queue 1, item 7.2: DTensor placements from ``distribution.sharding``'s
rules).

The step is the reference's: the loss and its gradients
(``lm.forward_train`` under autograd, each layer under ``cfg.remat``),
then ``opt.update``. ``accum_steps > 1`` runs the micro-batches in order,
sums their gradients from zeros (in the parameters' dtype), divides by
``accum_steps`` and averages the metrics, as the reference's scan does.

The prefill step is ``lm.forward_prefill`` with a cache of ``max_seq``
positions, the batch's ``patch_embeds`` (vlm) or ``frames`` (audio) passed
on with its tokens (``batch_spec`` gives their shapes); the decode step is ``lm.forward_decode`` then the argmax of the
last position's logits. Both run without autograd. The decode step writes
its state in place and returns it (the reference donates it,
``donate_argnums=(2,)``): pass each step the state the last one returned.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.data.synthetic import batch_spec
from repro_torch.launch.mesh import Mesh
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
    """Accept no mesh or a ``launch.mesh.Mesh`` of one device; raise on any
    other mesh and on expert parallelism."""
    one = mesh is None or (isinstance(mesh, Mesh) and mesh.device_count == 1)
    if not one or ep:
        raise NotImplementedError(
            "meshes of more than one device and expert parallelism wait for "
            "the LM mesh (ROADMAP queue 1, item 7.2); the port's steps run "
            "on one device")


def _on(device: torch.device, params: PyTree, what: str) -> None:
    """Raise unless ``params`` lie on ``device`` (``cuda`` matches any
    card)."""
    got = tree_leaves(params)[0].device
    if got != device and not (device.index is None
                              and got.type == device.type):
        raise ValueError(f"the {what} step runs on {device}; its "
                         f"parameters are on {got}")


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
    params_shape = lm.init_params(cfg, None, shape.seq_len, device="meta")
    opt_shape = opt.init(params_shape)
    bshape = batch_spec(cfg, shape.global_batch, shape.seq_len)
    check = lambda params: _on(device, params, "train")

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
                      max_seq: Optional[int] = None, device=None, mesh=None,
                      ep: bool = False) -> StepBundle:
    """The prefill step ``fn(params, batch) -> (logits (B,1,V), DecodeState)``
    on ``device`` (``cuda`` unless another device is named). The cache holds
    ``max_seq`` positions: by default, as in the reference, the prompt, a
    VLM's patch embeddings and 64 more for the decode steps that follow."""
    _no_mesh(mesh, ep)
    device = resolve_device(device, "make_prefill_step")
    max_seq = max_seq or shape.seq_len + 64 + (cfg.vision_tokens or 0)

    def prefill_step(params, batch):
        _on(device, params, "prefill")
        with torch.no_grad():
            return lm.forward_prefill(params, cfg, batch, max_seq=max_seq)

    return StepBundle(
        fn=prefill_step,
        arg_specs=(lm.init_params(cfg, None, max_seq, device="meta"),
                   batch_spec(cfg, shape.global_batch, shape.seq_len)),
        meta=dict(device=device, max_seq=max_seq),
    )


def make_decode_step(cfg: ModelConfig, shape: InputShape, *, device=None,
                     mesh=None, ep: bool = False) -> StepBundle:
    """The serve step ``fn(params, tokens, state) -> (next_tok (B,1) int32,
    new_state)`` with a state of ``shape.seq_len`` positions of context, on
    ``device`` (``cuda`` unless another device is named): one
    ``lm.forward_decode``, then the greedy token of the last position."""
    _no_mesh(mesh, ep)
    device = resolve_device(device, "make_decode_step")
    B, max_seq = shape.global_batch, shape.seq_len

    def decode_step(params, tokens, state):
        _on(device, params, "decode")
        logits, new_state = lm.forward_decode(params, cfg, tokens, state)
        next_tok = logits[:, -1, :].argmax(dim=-1).to(torch.int32)[:, None]
        return next_tok, new_state

    return StepBundle(
        fn=decode_step,
        arg_specs=(lm.init_params(cfg, None, max_seq, device="meta"),
                   torch.empty((B, 1), dtype=torch.int32, device="meta"),
                   lm.init_decode_state(cfg, B, max_seq, device="meta")),
        meta=dict(device=device, max_seq=max_seq),
    )


def make_step_for_cell(cfg: ModelConfig, shape: InputShape,
                       opt: Optional[Optimizer] = None, *, mesh=None,
                       device=None, **kw) -> StepBundle:
    """Dispatch on the cell kind, as the reference does: train_* to
    ``make_train_step`` (AdamW with bf16 moments unless ``opt`` is given;
    ``accum_steps`` passes through), prefill_* to ``make_prefill_step``,
    decode_* / long_* to ``make_decode_step``.

    The reference first pads the config for its mesh's tensor-parallel
    size (``pad_config_for_mesh``); at TP 1 that is the identity, so on one
    device the config goes through unpadded. The padding comes with the
    LM mesh (ROADMAP queue 1, item 7.2), as does the split-K decode: one
    device never splits the batch, so the decode bundle's ``meta`` says
    ``split_k=False``."""
    kw.update(mesh=mesh, device=device)
    if shape.kind == "train":
        from repro_torch.optim import adamw

        return make_train_step(cfg, opt or adamw(moment_dtype="bfloat16"),
                               shape, **kw)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape, **kw)
    bundle = make_decode_step(cfg, shape, **kw)
    bundle.meta["split_k"] = False
    return bundle
