"""The port's steps: the train, prefill and decode steps of
``repro.distribution.steps``, on one device or SPMD over an LM mesh.

Each ``make_*_step`` returns a ``StepBundle``: the step function, its
argument specs (the parameter tree, the optimizer state, the batch, the
tokens or the decode state, as tensors on the ``meta`` device: shapes and
dtypes, no data; on a mesh, meta DTensors with their placements) and
``meta``. The reference's bundle also carries the in/out shardings and
donated arguments that ``jit()`` / ``lower()`` compile for a mesh; PyTorch
compiles nothing, so ``bundle.fn`` is called directly and the shardings
are the placements its arguments carry.

**On a mesh** (``mesh=`` a ``torch.distributed`` ``DeviceMesh`` with the
reference's axis names, ``launch.mesh.make_local_mesh`` /
``make_production_mesh``) every rank calls the step with its DTensors:
parameters (and the optimizer's moments, ``sharding.opt_state_specs``)
FSDP+TP by ``param_pspecs`` (``ep=`` the expert-parallel MoE layout; the
prefill and decode steps' ``fsdp=False`` the TP-only inference layout),
the batch split over the data axes that divide it (``dp_axes_for``; with
``accum_steps`` over those that divide a micro-batch), the decode state by
``state_pspecs``. ``meta`` carries the reference's ``pspecs``, ``ospecs``,
``bspecs``, ``sspecs``, ``dp``, ``ms`` and ``split_k``. The models run on DTensors under
``implicit_replication`` (positions, masks and RoPE tables are plain
tensors, replicated), with ``sharding.make_shard_fn``'s hook: each layer
gathers its FSDP weights to their TP-only layout where it uses them, and
the activations take the reference's constraints. The loss and the greedy
token read the whole vocab (``lm.whole_vocab``). When the decode batch
splits over no data axis (``split_k``), the KV caches split their positions
over the data axes instead and each layer's decode attention combines the
ranks' softmax partials (``layers._decode_attend``). A mesh of one device
runs the same ops on the same local tensors as ``mesh=None``.

The step is the reference's: the loss and its gradients
(``lm.forward_train`` under autograd, each layer under ``cfg.remat``),
then ``opt.update``. ``accum_steps > 1`` runs the micro-batches in order,
sums their gradients from zeros (in the parameters' dtype), divides by
``accum_steps`` and averages the metrics, as the reference's scan does.
On a mesh each gradient is brought to its parameter's placements (the
reduce-scatter over the data axes) and the metrics come back as plain
tensors, the same on every rank.

The prefill step is ``lm.forward_prefill`` with a cache of ``max_seq``
positions, the batch's ``patch_embeds`` (vlm) or ``frames`` (audio) passed
on with its tokens (``batch_spec`` gives their shapes); the decode step is
``lm.forward_decode`` then the argmax of the last position's logits. Both
run without autograd. The decode step writes its state in place and returns
it (the reference donates it, ``donate_argnums=(2,)``): pass each step the
state the last one returned.
"""
from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.data.synthetic import batch_spec
from repro_torch.distribution import sharding as sh
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


class _Mesh:
    """An LM mesh's roles for one step: the ``DeviceMesh``, its
    ``MeshSpec``, the batch's data axes and the shard hook."""

    def __init__(self, mesh, batch: int):
        from torch.distributed.device_mesh import DeviceMesh

        if not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh= takes a torch.distributed DeviceMesh "
                            f"(launch.mesh.make_local_mesh), not "
                            f"{type(mesh).__name__}")
        self.mesh = mesh
        self.ms = sh.MeshSpec.for_mesh(mesh)
        self.dp = sh.dp_axes_for(batch, mesh, self.ms)
        self.shard = sh.make_shard_fn(mesh, self.ms, self.dp)

    def place(self, tree: PyTree, specs: PyTree) -> PyTree:
        return sh.distribute_tree(tree, specs, self.mesh)


def _check_ep(mesh, ep: bool) -> None:
    if ep and mesh is None:
        raise ValueError("ep=True shards the experts over a mesh's model "
                         "axis; pass mesh=")


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def _on(device: torch.device, params: PyTree, what: str) -> None:
    """Raise unless ``params`` lie on ``device`` (``cuda`` matches any
    card; a DTensor's block is what is checked)."""
    got = _local(tree_leaves(params)[0]).device
    if got != device and not (device.index is None
                              and got.type == device.type):
        raise ValueError(f"the {what} step runs on {device}; its "
                         f"parameters are on {got}")


def _grads(cfg: ModelConfig, params: PyTree, batch: dict, shard=lm._noshard):
    """(loss metrics, gradient tree) of ``lm.forward_train`` at ``params``;
    on a mesh each gradient takes its parameter's placements."""
    from torch.distributed.tensor import DTensor

    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = lm.forward_train(leaves, cfg, batch, shard=shard)
    gs = iter(torch.autograd.grad(loss, tree_leaves(leaves),
                                  materialize_grads=True))

    def grad(p):
        g = next(gs)
        if isinstance(g, DTensor) and g.placements != p.placements:
            g = g.redistribute(p.device_mesh, p.placements)
        return g
    return ({k: v.detach() for k, v in metrics.items()},
            tree_map(lambda p: grad(p), leaves))


def _replicated():
    """The context a mesh step runs in: plain tensors (positions, masks,
    RoPE tables, the optimizer's count) count as replicated DTensors."""
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


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
    inputs must lie there), over ``mesh`` when one is given (the module
    docstring says how)."""
    _check_ep(mesh, ep)
    device = resolve_device(device, "make_train_step")
    params_shape = lm.init_params(cfg, None, shape.seq_len, device="meta")
    opt_shape = opt.init(params_shape)
    bshape = batch_spec(cfg, shape.global_batch, shape.seq_len)
    check = lambda params: _on(device, params, "train")
    if shape.global_batch % accum_steps:
        raise ValueError(f"batch {shape.global_batch} does not split "
                         f"into {accum_steps} micro-batches")
    meta = dict(device=device, accum_steps=accum_steps)
    shard, ctx, micro_pl = lm._noshard, contextlib.nullcontext, None
    if mesh is not None:
        m = _Mesh(mesh, shape.global_batch // accum_steps)
        pspecs = sh.param_pspecs(cfg, params_shape, m.ms, ep=ep)
        ospecs = sh.opt_state_specs(opt_shape, pspecs)
        bspecs = sh.batch_pspecs(cfg, bshape, m.dp)
        params_shape = m.place(params_shape, pspecs)
        opt_shape = m.place(opt_shape, ospecs)
        bshape = m.place(bshape, bspecs)
        micro_pl = {k: sh.placements_for(s, mesh) for k, s in bspecs.items()}
        shard, ctx = m.shard, _replicated
        meta.update(pspecs=pspecs, ospecs=ospecs, bspecs=bspecs, dp=m.dp,
                    ms=m.ms)

    from torch.distributed.tensor import Replicate

    def micro(batch, i):
        """Micro-batch ``i``: rows i·mb .. (i+1)·mb - 1 of the batch,
        split over the micro-batch's data axes on a mesh."""
        out = {}
        for k, v in batch.items():
            if micro_pl is not None:   # the rows whole, then the micro split
                v = v.redistribute(mesh, [Replicate()] * mesh.ndim)
            x = v.reshape((accum_steps, v.shape[0] // accum_steps)
                          + v.shape[1:])[i]
            if micro_pl is not None:
                x = x.redistribute(mesh, micro_pl[k])
            out[k] = x
        return out

    def train_step(params, opt_state, batch):
        check(params)
        with ctx():
            if accum_steps == 1:
                metrics, grads = _grads(cfg, params, batch, shard)
            else:
                grads = tree_zeros_like(params)
                mets = []
                for i in range(accum_steps):
                    m_, g = _grads(cfg, params, micro(batch, i), shard)
                    grads = tree_map(torch.add, grads, g)
                    mets.append(m_)
                with torch.no_grad():
                    grads = tree_map(lambda g: g / accum_steps, grads)
                    metrics = {k: torch.stack([sh.whole(m_[k])
                                               for m_ in mets]).mean()
                               for k in mets[0]}
            with torch.no_grad():
                new_params, new_opt = opt.update(grads, opt_state, params)
        return new_params, new_opt, sh.whole(metrics)

    return StepBundle(fn=train_step, arg_specs=(params_shape, opt_shape, bshape),
                      meta=meta)


def _state_specs(cfg: ModelConfig, m: "_Mesh", B: int, max_seq: int,
                 split_k: bool) -> tuple[lm.DecodeState, PyTree]:
    """(the decode state's meta shapes, its specs on the mesh): the
    reference's ``state_pspecs``, the KV positions over the data axes when
    ``split_k``."""
    st = lm.init_decode_state(cfg, B, max_seq, device="meta")
    return st, sh.state_pspecs(cfg, st, m.ms,
                               m.ms.data if split_k else m.dp,
                               shard_kv_seq=split_k)


def mesh_state(state_shape: lm.DecodeState, sspecs: PyTree, mesh,
               device) -> lm.DecodeState:
    """A zero decode state on ``mesh``, each leaf placed by its spec with
    only the rank's own block allocated, an axis that does not divide its
    dim dropped (an unpadded config's kv heads); ``pos`` a plain 0-d
    tensor (it is replicated)."""
    def one(t, s):
        if t.ndim == 0:
            return torch.zeros((), dtype=t.dtype, device=device)
        return sh.mesh_zeros(t.shape, t.dtype,
                             sh.drop_nondividing(s, t.shape, mesh), mesh,
                             device)
    return sh._map_specs(one, state_shape, sspecs)


def make_prefill_step(cfg: ModelConfig, shape: InputShape, *,
                      max_seq: Optional[int] = None, device=None, mesh=None,
                      ep: bool = False, fsdp: bool = True) -> StepBundle:
    """The prefill step ``fn(params, batch) -> (logits (B,1,V), DecodeState)``
    on ``device`` (``cuda`` unless another device is named), over ``mesh``
    when one is given. The cache holds ``max_seq`` positions: by default,
    as in the reference, the prompt, a VLM's patch embeddings and 64 more
    for the decode steps that follow."""
    _check_ep(mesh, ep)
    device = resolve_device(device, "make_prefill_step")
    max_seq = max_seq or shape.seq_len + 64 + (cfg.vision_tokens or 0)
    B = shape.global_batch
    params_shape = lm.init_params(cfg, None, max_seq, device="meta")
    bshape = batch_spec(cfg, B, shape.seq_len)
    meta = dict(device=device, max_seq=max_seq)
    if mesh is None:
        def prefill_step(params, batch):
            _on(device, params, "prefill")
            with torch.no_grad():
                return lm.forward_prefill(params, cfg, batch, max_seq=max_seq)

        return StepBundle(fn=prefill_step, arg_specs=(params_shape, bshape),
                          meta=meta)

    m = _Mesh(mesh, B)
    pspecs = sh.param_pspecs(cfg, params_shape, m.ms, ep=ep, fsdp=fsdp)
    bspecs = sh.batch_pspecs(cfg, bshape, m.dp)
    st_shape, sspecs = _state_specs(cfg, m, B, max_seq, False)

    def prefill_step(params, batch):
        _on(device, params, "prefill")
        with torch.no_grad(), _replicated():
            state = mesh_state(st_shape, sspecs, mesh, device)
            return lm.forward_prefill(params, cfg, batch, max_seq=max_seq,
                                      shard=m.shard, state=state)

    meta.update(pspecs=pspecs, bspecs=bspecs, sspecs=sspecs, dp=m.dp,
                ms=m.ms)
    return StepBundle(fn=prefill_step,
                      arg_specs=(m.place(params_shape, pspecs),
                                 m.place(bshape, bspecs)),
                      meta=meta)


def make_decode_step(cfg: ModelConfig, shape: InputShape, *, device=None,
                     mesh=None, ep: bool = False,
                     fsdp: bool = True) -> StepBundle:
    """The serve step ``fn(params, tokens, state) -> (next_tok (B,1) int32,
    new_state)`` with a state of ``shape.seq_len`` positions of context, on
    ``device`` (``cuda`` unless another device is named): one
    ``lm.forward_decode``, then the greedy token of the last position.

    Over ``mesh``, as in the reference: a batch that splits over the data
    axes splits the state with it; a batch that splits over none
    (``meta["split_k"]``, long-context decode) splits the KV caches'
    positions over the data axes instead (split-K)."""
    _check_ep(mesh, ep)
    device = resolve_device(device, "make_decode_step")
    B, max_seq = shape.global_batch, shape.seq_len
    params_shape = lm.init_params(cfg, None, max_seq, device="meta")
    tok_shape = torch.empty((B, 1), dtype=torch.int32, device="meta")
    st_shape = lm.init_decode_state(cfg, B, max_seq, device="meta")
    meta = dict(device=device, max_seq=max_seq, split_k=False)
    if mesh is None:
        def decode_step(params, tokens, state):
            _on(device, params, "decode")
            logits, new_state = lm.forward_decode(params, cfg, tokens, state)
            next_tok = logits[:, -1, :].argmax(dim=-1).to(torch.int32)[:, None]
            return next_tok, new_state

        return StepBundle(fn=decode_step,
                          arg_specs=(params_shape, tok_shape, st_shape),
                          meta=meta)

    m = _Mesh(mesh, B)
    split_k = m.dp == ()
    pspecs = sh.param_pspecs(cfg, params_shape, m.ms, ep=ep, fsdp=fsdp)
    st_shape, sspecs = _state_specs(cfg, m, B, max_seq, split_k)
    tspec = (sh._n(m.dp), None)

    def decode_step(params, tokens, state):
        _on(device, params, "decode")
        with torch.no_grad(), _replicated():
            logits, new_state = lm.forward_decode(params, cfg, tokens, state,
                                                  shard=m.shard)
            last = lm.whole_vocab(logits)[:, -1, :]
            next_tok = last.argmax(dim=-1).to(torch.int32)[:, None]
        return next_tok, new_state

    meta.update(pspecs=pspecs, sspecs=sspecs, dp=m.dp, ms=m.ms,
                split_k=split_k)
    placed = sh._map_specs(
        lambda t, s: t if t.ndim == 0 else sh.distribute_tree(t, s, mesh),
        st_shape, sspecs)
    return StepBundle(fn=decode_step,
                      arg_specs=(m.place(params_shape, pspecs),
                                 m.place(tok_shape, tspec), placed),
                      meta=meta)


def make_step_for_cell(cfg: ModelConfig, shape: InputShape,
                       opt: Optional[Optimizer] = None, *, mesh=None,
                       device=None, **kw) -> StepBundle:
    """Dispatch on the cell kind, as the reference does: train_* to
    ``make_train_step`` (AdamW with bf16 moments unless ``opt`` is given;
    ``accum_steps`` passes through), prefill_* to ``make_prefill_step``,
    decode_* / long_* to ``make_decode_step`` (whose ``meta["split_k"]``
    says whether the decode splits its KV positions). On a mesh the config
    is first padded for the mesh's tensor-parallel size
    (``pad_config_for_mesh``; the identity at TP 1 and without a mesh);
    ``pad_config_for_mesh`` gives the config the step runs."""
    if mesh is not None:
        cfg = sh.pad_config_for_mesh(
            cfg, sh.tp_size(mesh, sh.MeshSpec.for_mesh(mesh)))
    kw.update(mesh=mesh, device=device)
    if shape.kind == "train":
        from repro_torch.optim import adamw

        return make_train_step(cfg, opt or adamw(moment_dtype="bfloat16"),
                               shape, **kw)
    if shape.kind == "prefill":
        return make_prefill_step(cfg, shape, **kw)
    return make_decode_step(cfg, shape, **kw)
