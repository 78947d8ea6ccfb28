"""Model assembly of the port: every family of ``repro.models.lm`` — dense,
ssm (RWKV-6), hybrid (zamba2: Mamba2 layers and a shared attention block),
moe (GShard experts), vlm (patch embeddings ahead of the text) and audio
(whisper: a non-causal encoder and a decoder with cross-attention).

* ``init_params``      — the parameter tree, drawn on a device from an
                         explicit ``torch.Generator``
* ``forward_train``    — full-sequence forward + CE loss (a VLM's over the
                         text region; an MoE's plus 0.01 · its balance loss)
* ``forward_prefill``  — full-sequence forward returning last-position
                         logits and a primed ``DecodeState``
* ``forward_decode``   — one-token step with the cached state, which it
                         updates in place
* ``score_last``       — ``forward_prefill``'s logits without the state
* ``load_reference_params`` — the reference's parameter pytree (numpy
                         arrays) as the port's tree
* ``load_reference_opt_state`` — the reference optimizer's state as the
                         port optimizer's

The port keeps the reference's parameter layout: the same nested keys, and
each linear weight (d_in, d_out) applied as ``x @ W``, so the converter only
moves arrays into tensors. A layer stack (and whisper's encoder stack) is
stacked along a leading L axis when ``cfg.scan_layers`` (as in the full
configs) and a list otherwise (the reduced ones); ``_backbone`` walks either
in a Python loop, a stacked tree unbound once a pass so that its gradient is
one stack, not a scatter a layer. The hybrid's Mamba2 layers are one such
stack, with the ``shared_block`` (one dense block's weights) run after every
``hybrid_period``-th of them, in the reference's period order. An MoE layer
returns its aux (``moe_drop_frac``, ``moe_lb_loss``), averaged over the
layers as both of the reference's layouts do.

``forward_train`` runs under autograd (``distribution/steps.py`` builds the
train step on it). While grad is enabled, each layer runs under the
reference's ``_maybe_remat``: ``cfg.remat`` ``"none"`` keeps every
activation, ``"full"`` (JAX's ``nothing_saveable``) keeps only the layer's
inputs and recomputes the layer in the backward pass, and ``"block"``
(``dots_with_no_batch_dims_saveable``) keeps the outputs of the weight
matmuls (``aten.mm`` / ``aten.addmm``, the products without batch
dimensions) and recomputes the rest, attention's batched products
included. Remat changes memory, never values.

The ssm blocks run the time mix as the reference's ``_rwkv_block`` does,
with ``rwkv6_time_mix``'s default impl (the plain ``wkv6_chunked``); the
wkv kernel is reached through ``rwkv6_time_mix(..., impl="pallas")``, as in
the reference. Under ``attn_impl="pallas"`` every self-attention of a full
sequence (whisper's non-causal encoder included) runs the flash-attention
kernel; cross-attention and decode attention stay plain, as there.

Every entry point takes the reference's ``shard(name, x)`` hook (identity by
default) and calls it at the reference's points. On an LM mesh
(``distribution.steps`` with ``mesh=``) the parameters, the batch and the
decode state are DTensors and the hook is
``distribution.sharding.make_shard_fn``'s: besides the activation
constraints, each layer's parameters go through ``shard("weights", p)``
where the layer uses them (inside its remat), which gathers FSDP shards to
their TP-only layout.
"""
from __future__ import annotations

import functools
from typing import Any, NamedTuple, Optional

import numpy as np
import torch
from torch.utils import checkpoint as ckpt

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.utils import resolve_device, softmax_cross_entropy, tree_map

PyTree = Any

#: the families the port runs: all of the reference's
PORTED = ("dense", "ssm", "hybrid", "moe", "vlm", "audio")


class DecodeState(NamedTuple):
    """All sequence state needed to emit the next token."""

    pos: torch.Tensor  # scalar int32: #tokens already in the state
    kv_k: Optional[torch.Tensor] = None  # (L_or_inv, B, Smax, nkv, hd)
    kv_v: Optional[torch.Tensor] = None
    ssm: Optional[PyTree] = None
    cross_k: Optional[torch.Tensor] = None  # whisper: (L, B, F, nkv, hd)
    cross_v: Optional[torch.Tensor] = None


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def _stack(trees: list) -> PyTree:
    """Stack a list of equal trees leaf-wise along a new leading axis. Each
    leaf's per-layer tensors are released as soon as they are stacked, so
    the peak is the tree plus one stacked leaf, not twice the tree."""
    first = trees[0]
    if isinstance(first, dict):
        out = {}
        for key in list(first):
            out[key] = _stack([t[key] for t in trees])
            for t in trees:
                del t[key]
        return out
    return torch.stack(trees)


def _hybrid_periods(cfg: ModelConfig) -> tuple[int, int]:
    """(layers per period, number of periods) for the hybrid period walk."""
    per = cfg.hybrid_period or cfg.num_layers
    assert cfg.num_layers % per == 0, (cfg.num_layers, per)
    return per, cfg.num_layers // per


def _shared_after(cfg: ModelConfig, i: int) -> bool:
    """Whether the hybrid's shared block follows Mamba2 layer ``i``, as in
    the reference: after each period of the stacked layers (its scan over
    ``_hybrid_periods``), after every ``hybrid_period``-th listed layer."""
    if cfg.scan_layers:
        return (i + 1) % _hybrid_periods(cfg)[0] == 0
    return bool(cfg.hybrid_period) and (i + 1) % cfg.hybrid_period == 0


def _init_dense_layer(gen, cfg: ModelConfig, device,
                      moe: bool = False) -> dict:
    dt = L._dtype(cfg)
    p = {
        "norm1": L.init_rmsnorm(cfg.d_model, dt, device),
        "attn": L.init_attention(gen, cfg, device),
        "norm2": L.init_rmsnorm(cfg.d_model, dt, device),
    }
    if moe:
        p["moe"] = L.init_moe(gen, cfg, device)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, device)
    return p


def _init_decoder_xattn_layer(gen, cfg: ModelConfig, device) -> dict:
    dt = L._dtype(cfg)
    return {
        "norm1": L.init_rmsnorm(cfg.d_model, dt, device),
        "attn": L.init_attention(gen, cfg, device),
        "norm2": L.init_rmsnorm(cfg.d_model, dt, device),
        "xattn": L.init_attention(gen, cfg, device, cross=True),
        "norm3": L.init_rmsnorm(cfg.d_model, dt, device),
        "mlp": L.init_mlp(gen, cfg, device),
    }


def _init_hybrid_layer(gen, cfg: ModelConfig, device) -> dict:
    return {"norm": L.init_rmsnorm(cfg.d_model, L._dtype(cfg), device),
            "mamba": L.init_mamba2(gen, cfg, device)}


def _init_stack(init_layer, n: int, gen, cfg: ModelConfig, device):
    blocks = [init_layer(gen, cfg, device) for _ in range(n)]
    return _stack(blocks) if cfg.scan_layers else blocks


def init_params(cfg: ModelConfig, gen: Optional[torch.Generator],
                max_seq: int = 0, *, device=None) -> PyTree:
    """The parameter tree of any family, drawn from ``gen`` on its device
    (``device`` overrides it; on ``meta`` nothing is drawn and ``gen`` may
    be None). ``max_seq`` sizes the audio family's learned decoder
    positions, ``max(max_seq, 4096)`` of them, as in the reference."""
    device = torch.device(device if device is not None else gen.device)
    dt = L._dtype(cfg)
    emb_scale = 1.0 / np.sqrt(cfg.d_model)
    params: dict = {
        "embed": L._init(gen, (cfg.vocab_size, cfg.d_model), emb_scale, dt,
                         device),
        "final_norm": L.init_rmsnorm(cfg.d_model, dt, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._init(gen, (cfg.d_model, cfg.vocab_size),
                                    emb_scale, dt, device)
    fam = cfg.family
    init_layer = {
        "dense": _init_dense_layer, "vlm": _init_dense_layer,
        "moe": functools.partial(_init_dense_layer, moe=True),
        "ssm": L.init_rwkv6, "hybrid": _init_hybrid_layer,
        "audio": _init_decoder_xattn_layer,
    }.get(fam)
    if init_layer is None:
        raise ValueError(fam)
    if fam == "audio":
        params["enc_layers"] = _init_stack(_init_dense_layer,
                                           cfg.encoder_layers, gen, cfg,
                                           device)
    params["layers"] = _init_stack(init_layer, cfg.num_layers, gen, cfg,
                                   device)
    if fam == "hybrid":
        params["shared_block"] = _init_dense_layer(gen, cfg, device)
    if fam == "audio":
        params["enc_norm"] = L.init_rmsnorm(cfg.d_model, dt, device)
        params["enc_pos"] = L._init(gen, (cfg.encoder_seq, cfg.d_model),
                                    0.02, dt, device)
        params["dec_pos"] = L._init(gen, (max(max_seq, 4096), cfg.d_model),
                                    0.02, dt, device)
    return params


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: same bits
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def load_reference_params(tree: PyTree, cfg: ModelConfig, device=None) -> PyTree:
    """The reference's ``init_params`` tree (leaves as numpy arrays or
    anything ``np.asarray`` takes) as the port's tree on ``device`` (``cuda``
    unless another device is named). The layouts are the same — x @ W
    weights, the same keys — so leaves keep their shapes and dtypes. The
    layer stack may be stacked (``scan_layers=True``, a dict of (L, ...)
    arrays) or a list of per-layer dicts; it must be the one ``cfg``
    names. A hybrid tree's ``shared_block`` (one dense layer's dict) sits
    beside its layers; an audio tree's ``enc_layers`` (in the same layout),
    ``enc_norm``, ``enc_pos`` and ``dec_pos`` beside its decoder layers. An
    MoE router stays f32 in a bf16 tree, as the reference keeps it."""
    device = resolve_device(device, "load_reference_params")
    stacked = isinstance(tree["layers"], dict)
    if stacked != cfg.scan_layers:
        raise ValueError(f"reference layers are {'stacked' if stacked else 'a list'}"
                         f" but cfg.scan_layers={cfg.scan_layers}")

    return tree_map(lambda a: _to_tensor(a, device), tree)


def load_reference_opt_state(state: PyTree, cfg: ModelConfig,
                             device=None) -> PyTree:
    """The reference optimizer's state (``repro.optim``'s adamw, sgd or
    rmsprop: ``mu`` / ``nu`` trees that mirror the parameter tree, and the
    int32 ``count``) as the port optimizer's, on ``device`` (``cuda`` unless
    another device is named). Leaves keep their dtypes, bf16 moments
    included."""
    device = resolve_device(device, "load_reference_opt_state")
    return {k: (load_reference_params(v, cfg, device) if k in ("mu", "nu")
                else _to_tensor(v, device))
            for k, v in state.items()}


# ---------------------------------------------------------------------------
# Blocks and the full-sequence forward
# ---------------------------------------------------------------------------


_noshard = L._noshard


def _dense_block(p, cfg, x, shard=_noshard, causal=None):
    p = shard("weights", p)
    x = x + L.attention_apply(p["attn"], cfg,
                              L.rmsnorm(p["norm1"], x, cfg.norm_eps),
                              causal=causal, shard=shard)
    x = shard("act_btd", x)
    x = x + L.mlp_apply(p["mlp"], cfg, L.rmsnorm(p["norm2"], x, cfg.norm_eps),
                        shard=shard)
    return shard("act_btd", x)


def _moe_block(p, cfg, x, shard=_noshard):
    """A dense block with the MoE in the MLP's place: (x, aux)."""
    p = shard("weights", p)
    x = x + L.attention_apply(p["attn"], cfg,
                              L.rmsnorm(p["norm1"], x, cfg.norm_eps),
                              shard=shard)
    x = shard("act_btd", x)
    y, aux = L.moe_apply(p["moe"], cfg, L.rmsnorm(p["norm2"], x, cfg.norm_eps),
                         shard=shard)
    return shard("act_btd", x + y), aux


def _xattn_block(p, cfg, x, enc_out, shard=_noshard):
    """Whisper's decoder block: causal self-attention, cross-attention over
    the encoder's output, the MLP."""
    p = shard("weights", p)
    x = x + L.attention_apply(p["attn"], cfg,
                              L.rmsnorm(p["norm1"], x, cfg.norm_eps),
                              causal=True, shard=shard)
    x = x + L.attention_apply(p["xattn"], cfg,
                              L.rmsnorm(p["norm2"], x, cfg.norm_eps),
                              kv_src=enc_out, shard=shard)
    x = x + L.mlp_apply(p["mlp"], cfg, L.rmsnorm(p["norm3"], x, cfg.norm_eps),
                        shard=shard)
    return shard("act_btd", x)


def _rwkv_block(p, cfg, x, shard=_noshard):
    p = shard("weights", p)
    h, _ = L.rwkv6_time_mix(p, cfg, L.rmsnorm(p["tm_norm"], x, cfg.norm_eps),
                            shard=shard)
    x = shard("act_btd", x + h)
    h, _ = L.rwkv6_channel_mix(p, cfg, L.rmsnorm(p["cm_norm"], x, cfg.norm_eps),
                               shard=shard)
    return shard("act_btd", x + h)


def _unstack(tree: PyTree) -> list:
    """A stacked tree as a list of per-layer trees: each leaf unbound once
    (one ``unbind``, whose backward is one ``stack``)."""
    if isinstance(tree, dict):
        parts = {k: _unstack(v) for k, v in tree.items()}
        n = len(next(iter(parts.values())))
        return [{k: v[i] for k, v in parts.items()} for i in range(n)]
    return list(torch.unbind(tree))


def _layers(params, cfg: ModelConfig):
    """The per-layer trees, from either layout."""
    if cfg.scan_layers:
        return iter(_unstack(params))
    return iter(params)


#: the ops whose outputs ``remat="block"`` keeps: the weight matmuls, JAX's
#: dot_generals without batch dimensions (``x @ W`` folds to ``mm``;
#: einsums with batch dimensions run as ``bmm`` and are recomputed)
_SAVED_BY_BLOCK = frozenset({torch.ops.aten.mm.default,
                             torch.ops.aten.addmm.default})


def _block_policy(ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_BLOCK
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _maybe_remat(fn, cfg: ModelConfig):
    """``fn(p, x)`` under ``cfg.remat`` while grad is enabled (the module
    docstring says what each mode keeps); ``fn`` itself otherwise. ``fn``
    may return a tuple (an MoE block's (x, aux))."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn
    kw = dict(use_reentrant=False, preserve_rng_state=False)
    if cfg.remat == "block":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _block_policy)
    elif cfg.remat != "full":
        raise ValueError(f"remat={cfg.remat!r}")
    return lambda p, x: ckpt.checkpoint(fn, p, x, **kw)


def _mamba_block(p, cfg, x, shard=_noshard):
    p = shard("weights", p)
    return shard("act_btd", x + L.mamba2_mix(
        p["mamba"], cfg, L.rmsnorm(p["norm"], x, cfg.norm_eps),
        shard=shard)[0])


def _mean_aux(auxs: list) -> dict:
    """Per-layer aux dicts averaged over the layers."""
    if not auxs:
        return {}
    return {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}


def embed_lookup(table, tokens):
    """``table[tokens]``. On an LM mesh whose model axis splits the vocab
    (more than one rank) the lookup is vocab-parallel: each rank looks up
    the tokens that fall in its block of rows, zeros for the others, and
    the result is a partial sum over that axis (DTensor's ``Partial``,
    reduced by the next redistribute), so the table is never gathered."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.distribution.sharding import block_index

    vdims = []
    if isinstance(table, DTensor):
        mesh = table.device_mesh
        vdims = [i for i, p in enumerate(table.placements)
                 if p.is_shard(0) and mesh.size(i) > 1]
    if not vdims:
        return table[tokens]
    if any(not p.is_replicate() for i, p in enumerate(table.placements)
           if i not in vdims):
        raise ValueError(f"a vocab-parallel lookup takes a table split on "
                         f"its rows only, not {table.placements}")
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    rows = [p if p.is_shard(0) else Replicate() for p in tokens.placements]
    tok = tokens.redistribute(mesh, rows).to_local()
    # each rank's table gradient covers its own token rows: a partial sum
    # over the axes that split the rows
    w = table.to_local(grad_placements=[
        Partial() if p.is_replicate() and rows[i].is_shard() else p
        for i, p in enumerate(table.placements)])
    vl = w.shape[0]
    local = tok.long() - block_index(mesh, vdims) * vl
    mine = (local >= 0) & (local < vl)
    x = w[local.clamp(0, vl - 1)] * mine[..., None].to(w.dtype)
    return DTensor.from_local(
        x, mesh, [Partial() if i in vdims else p for i, p in enumerate(rows)],
        run_check=False)


def _embed(params, cfg: ModelConfig, tokens, batch: Optional[dict],
           shard=_noshard):
    """Token embeddings; a VLM's patch embeddings ahead of them, whisper's
    learned positions ``dec_pos[:S]`` added."""
    x = embed_lookup(shard("weights", params["embed"]), tokens)
    if cfg.family == "vlm":
        x = torch.cat([batch["patch_embeds"].to(x.dtype), x], dim=1)
    if cfg.family == "audio":
        x = x + shard("weights", params["dec_pos"])[:x.shape[1]][None]
    return shard("act_btd", x)


def _encoder(params, cfg: ModelConfig, frames, shard=_noshard):
    """Whisper's encoder: the frames plus ``enc_pos``, non-causal dense
    blocks (each under ``_maybe_remat``), the final norm."""
    x = frames.to(L._dtype(cfg)) + shard("weights", params["enc_pos"])[
        None, :frames.shape[1]]
    layer = _maybe_remat(
        lambda p, h: _dense_block(p, cfg, h, shard, causal=False), cfg)
    for p in _layers(params["enc_layers"], cfg):
        x = layer(p, x)
    return L.rmsnorm(shard("weights", params["enc_norm"]), x, cfg.norm_eps)


def _backbone(params, cfg: ModelConfig, x, batch: Optional[dict] = None,
              shard=_noshard):
    """(B,S,d) -> ((B,S,d), aux) through the family's blocks, in order; each
    block (a hybrid's Mamba2 layer and each call of its shared block) under
    ``_maybe_remat``. aux holds an MoE's per-layer aux averaged over the
    layers, and is empty for the other families. ``batch`` carries
    whisper's ``frames``."""
    fam = cfg.family
    enc_out = _encoder(params, cfg, batch["frames"], shard) \
        if fam == "audio" else None
    plain = {"ssm": _rwkv_block, "hybrid": _mamba_block,
             "moe": _moe_block}.get(fam, _dense_block)

    def block(p, h):
        if fam == "audio":
            return _xattn_block(p, cfg, h, enc_out, shard)
        return plain(p, cfg, h, shard)

    layer = _maybe_remat(block, cfg)
    shared = _maybe_remat(lambda p, h: _dense_block(p, cfg, h, shard), cfg)
    auxs = []
    for i, p in enumerate(_layers(params["layers"], cfg)):
        x = layer(p, x)
        if fam == "moe":
            x, aux = x
            auxs.append(aux)
        if fam == "hybrid" and _shared_after(cfg, i):
            x = shared(params["shared_block"], x)
    return x, _mean_aux(auxs)


def _logits(params, cfg: ModelConfig, x, shard=_noshard):
    x = L.rmsnorm(shard("weights", params["final_norm"]), x, cfg.norm_eps)
    w = shard("weights", params["embed"]).T if cfg.tie_embeddings \
        else shard("weights", params["lm_head"])
    logits = shard("logits", x @ w)
    vt = cfg.vocab_true or cfg.vocab_size
    if vt != cfg.vocab_size:  # mask padded vocab slots
        mask = torch.arange(cfg.vocab_size, device=logits.device) < vt
        logits = torch.where(mask[None, None, :], logits,
                             torch.tensor(-1e9, dtype=logits.dtype,
                                          device=logits.device))
    return logits


def whole_vocab(logits):
    """Logits with their vocab dim whole on every rank: on an LM mesh the
    model axis splits it (``shard("logits")``), and the loss's gather of
    each label's logit and the decode step's argmax read all of it, so the
    vocab blocks are all-gathered over that axis here; plain logits as they
    are."""
    from torch.distributed.tensor import DTensor, Replicate

    if not isinstance(logits, DTensor):
        return logits
    pl = [Replicate() if p.is_shard(logits.ndim - 1) else p
          for p in logits.placements]
    return logits.redistribute(logits.device_mesh, pl)


def cross_entropy(logits, labels):
    """``softmax_cross_entropy`` of (B, S, V) logits against (B, S) labels.
    On an LM mesh whose model axis splits the vocab (more than one rank)
    it runs vocab-parallel, as GSPMD partitions the reference's: each rank
    takes its block's max (all-reduced, MAX), its sum of exponentials and
    the logit of each label that falls in its block (both partial sums,
    all-reduced through DTensor's ``Partial``, which carries their
    gradients); the (B, S, V) logits are never gathered. Otherwise (no
    mesh, or a vocab that no rank splits) the logits are taken whole."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from repro_torch.distribution.sharding import block_index

    vd = logits.ndim - 1
    if isinstance(logits, DTensor):
        mesh = logits.device_mesh
        vdims = [i for i, p in enumerate(logits.placements)
                 if p.is_shard(vd) and mesh.size(i) > 1]
    if not isinstance(logits, DTensor) or not vdims:
        return softmax_cross_entropy(whole_vocab(logits), labels)
    from torch.distributed import _functional_collectives as funcol

    rows = [p if p.is_shard(0) else Replicate() for p in logits.placements]
    part = [Partial() if i in vdims else p for i, p in enumerate(rows)]
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh,
                                    [Replicate()] * mesh.ndim, run_check=False)
    lab = labels.redistribute(mesh, rows).to_local()
    x = logits.to_local().float()
    vl = x.shape[-1]
    off = block_index(mesh, vdims) * vl
    m = x.detach().amax(dim=-1, keepdim=True)
    for i in vdims:
        m = funcol.all_reduce(m, "max", (mesh, i))
    m = funcol.wait_tensor(m) if hasattr(funcol, "wait_tensor") else m
    sumexp = torch.exp(x - m).sum(dim=-1)
    mine = (lab >= off) & (lab < off + vl)
    gold = torch.gather(x, -1, (lab - off).clamp(0, vl - 1)[..., None]
                        .long())[..., 0] * mine

    def whole(t, pl):
        return DTensor.from_local(t.contiguous(), mesh, pl, run_check=False)
    lse = torch.log(whole(sumexp, part).redistribute(mesh, rows)) \
        + whole(m[..., 0], rows)
    return lse - whole(gold, part).redistribute(mesh, rows)


def _whole_sum(t):
    """``t.sum()``; a DTensor's is reduced over the mesh here (a partial
    sum left to the division after it breaks DTensor's backward)."""
    from torch.distributed.tensor import DTensor, Replicate

    total = t.sum()
    if isinstance(total, DTensor):
        total = total.redistribute(total.device_mesh,
                                   [Replicate()] * total.device_mesh.ndim)
    return total


def forward_train(params: PyTree, cfg: ModelConfig, batch: dict, *,
                  shard=_noshard) -> tuple[torch.Tensor, dict]:
    """CE loss over the batch. batch: tokens, labels, [mask, patch_embeds,
    frames]. A VLM's loss runs over the text region only; an MoE adds
    0.01 · ``moe_lb_loss``, and its aux enters ``metrics`` (whose
    ``ce_loss`` is the loss returned, as in the reference)."""
    x = _embed(params, cfg, batch["tokens"], batch, shard)
    x, aux = _backbone(params, cfg, x, batch, shard)
    logits = _logits(params, cfg, x, shard)
    if cfg.family == "vlm":  # loss only over the text region
        logits = logits[:, batch["patch_embeds"].shape[1]:]
    ce = cross_entropy(logits, batch["labels"])
    mask = batch.get("mask")
    if mask is not None:
        loss = _whole_sum(ce * mask) / torch.clamp(_whole_sum(mask), min=1.0)
    else:
        loss = ce.mean()
    if "moe_lb_loss" in aux:
        loss = loss + 0.01 * aux["moe_lb_loss"]
    return loss, {"ce_loss": loss, **aux}


# ---------------------------------------------------------------------------
# Prefill / decode
# ---------------------------------------------------------------------------


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      device=None) -> DecodeState:
    """Empty state sized for `max_seq` total positions, on ``device``
    (``cuda`` unless another device is named). Whisper's adds the
    per-layer cross K/V over its ``encoder_seq`` frames."""
    device = resolve_device(device, "init_decode_state")
    pos = torch.zeros((), dtype=torch.int32, device=device)
    fam = cfg.family
    if fam == "ssm":
        return DecodeState(pos=pos, ssm=_stack(
            [L.init_rwkv6_state(cfg, batch, device)
             for _ in range(cfg.num_layers)]))
    if fam not in PORTED:
        raise ValueError(fam)
    dt = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
    hd = cfg.resolved_head_dim
    n = (cfg.num_layers // cfg.hybrid_period if fam == "hybrid"
         else cfg.num_layers)
    kv_k = torch.zeros((n, batch, max_seq, cfg.num_kv_heads, hd), dtype=dt,
                       device=device)
    ssm = cross_k = cross_v = None
    if fam == "hybrid":
        ssm = _stack([L.init_mamba2_state(cfg, batch, device)
                      for _ in range(cfg.num_layers)])
    if fam == "audio":
        cross_k = torch.zeros((n, batch, cfg.encoder_seq, cfg.num_kv_heads,
                               hd), dtype=dt, device=device)
        cross_v = torch.zeros_like(cross_k)
    return DecodeState(pos=pos, kv_k=kv_k, kv_v=torch.zeros_like(kv_k),
                       ssm=ssm, cross_k=cross_k, cross_v=cross_v)


def _pos_tensor(n: int, device) -> torch.Tensor:
    return torch.tensor(n, dtype=torch.int32, device=device)


def forward_prefill(params: PyTree, cfg: ModelConfig, batch: dict,
                    max_seq: int, *, shard=_noshard,
                    state: Optional[DecodeState] = None
                    ) -> tuple[torch.Tensor, DecodeState]:
    """Run the full prompt, return last-position logits (B, 1, V) + a primed
    DecodeState.

    As in the reference, the K/V caches of an attention model (dense, vlm,
    moe, audio) are recomputed per layer from the layer's input (the norm,
    the K/V projections, RoPE on K) beside the block, and written into a
    fresh ``init_decode_state``: Sp = the embedded sequence's length
    positions (a VLM's patch positions, then its tokens) and ``pos`` = Sp.
    Whisper's cross K/V are each decoder layer's projections of the
    encoder's output. An ssm model keeps each layer's final recurrent state
    (``_prefill_ssm``); a hybrid both (``_prefill_hybrid``). ``state`` is
    the fresh state to fill (an LM mesh's, placed on it), by default
    ``init_decode_state``'s."""
    tokens = batch["tokens"]
    B = tokens.shape[0]
    x = _embed(params, cfg, tokens, batch, shard)
    if state is None:
        state = init_decode_state(cfg, B, max_seq, device=x.device)
    if cfg.family == "ssm":
        return _prefill_ssm(params, cfg, x, state, shard)
    if cfg.family == "hybrid":
        return _prefill_hybrid(params, cfg, x, state, shard)
    fam = cfg.family
    hd, nkv = cfg.resolved_head_dim, cfg.num_kv_heads
    Sp = x.shape[1]
    pos = torch.arange(Sp, device=x.device)
    enc_out = _encoder(params, cfg, batch["frames"], shard) \
        if fam == "audio" else None

    def kv_of(p, h):
        src = L.rmsnorm(p["norm1"], h, cfg.norm_eps)
        k = L.split_heads(src @ p["attn"]["wk"], nkv, hd)
        v = L.split_heads(src @ p["attn"]["wv"], nkv, hd)
        if "bk" in p["attn"]:
            k = k + L.split_heads(p["attn"]["bk"], nkv, hd)
            v = v + L.split_heads(p["attn"]["bv"], nkv, hd)
        k = L.apply_rope(k, pos, cfg.rope_theta)
        return k, v

    for i, p in enumerate(_layers(params["layers"], cfg)):
        p = shard("weights", p)
        k, v = kv_of(p, x)
        if fam == "moe":
            x, _ = _moe_block(p, cfg, x, shard)
        elif fam == "audio":
            x = _xattn_block(p, cfg, x, enc_out, shard)
            state.cross_k[i] = L.split_heads(
                enc_out @ p["xattn"]["wk"], nkv, hd).to(state.cross_k.dtype)
            state.cross_v[i] = L.split_heads(
                enc_out @ p["xattn"]["wv"], nkv, hd).to(state.cross_v.dtype)
        else:
            x = _dense_block(p, cfg, x, shard)
        state.kv_k[i, :, :Sp] = k.to(state.kv_k.dtype)
        state.kv_v[i, :, :Sp] = v.to(state.kv_v.dtype)
    state = state._replace(pos=_pos_tensor(Sp, x.device))
    return _logits(params, cfg, x[:, -1:], shard), state


def _prefill_ssm(params, cfg: ModelConfig, x, state: DecodeState,
                 shard=_noshard):
    """The ssm branch: every layer's time mix and channel mix run from a
    fresh zero state, so the wkv recurrence takes the state path
    (``wkv6_chunked``) and its final state is kept per layer."""
    B, S = x.shape[:2]
    sts = []
    for i, p in enumerate(_layers(params["layers"], cfg)):
        p = shard("weights", p)
        st0 = ({k: torch.zeros_like(v[i]) for k, v in state.ssm.items()}
               if L._is_dtensor(state.ssm["wkv"])   # on the mesh's layout
               else L.init_rwkv6_state(cfg, B, x.device))
        o, st = L.rwkv6_time_mix(p, cfg, L.rmsnorm(p["tm_norm"], x,
                                                   cfg.norm_eps), state=st0,
                                 shard=shard)
        x = shard("act_btd", x + o)
        o, st = L.rwkv6_channel_mix(p, cfg, L.rmsnorm(p["cm_norm"], x,
                                                      cfg.norm_eps),
                                    state={**st, "shift_cm": st0["shift_cm"]},
                                    shard=shard)
        x = shard("act_btd", x + o)
        sts.append(st)
    state = state._replace(pos=_pos_tensor(S, x.device), ssm=_stack(sts))
    return _logits(params, cfg, x[:, -1:], shard), state


def _prefill_hybrid(params, cfg: ModelConfig, x, state: DecodeState,
                    shard=_noshard):
    """The hybrid branch: each Mamba2 layer returns its final conv / SSM
    state from its chunked scan (no recompute), and each call of the shared
    block fills its own K/V cache, recomputed from the call's input as the
    dense branch does (the reference adds no qkv bias here)."""
    B, S = x.shape[:2]
    hd = cfg.resolved_head_dim
    pos = torch.arange(S, device=x.device)
    sp = shard("weights", params["shared_block"])
    inv, m_states = 0, []
    for i, p in enumerate(_layers(params["layers"], cfg)):
        p = shard("weights", p)
        y, mst = L.mamba2_mix(p["mamba"], cfg,
                              L.rmsnorm(p["norm"], x, cfg.norm_eps),
                              return_state=True, shard=shard)
        m_states.append(mst)
        x = shard("act_btd", x + y)
        if _shared_after(cfg, i):
            src = L.rmsnorm(sp["norm1"], x, cfg.norm_eps)
            k = L.split_heads(src @ sp["attn"]["wk"], cfg.num_kv_heads, hd)
            v = L.split_heads(src @ sp["attn"]["wv"], cfg.num_kv_heads, hd)
            state.kv_k[inv, :, :S] = L.apply_rope(k, pos, cfg.rope_theta).to(
                state.kv_k.dtype)
            state.kv_v[inv, :, :S] = v.to(state.kv_v.dtype)
            x = _dense_block(sp, cfg, x, shard)
            inv += 1
    state = state._replace(pos=_pos_tensor(S, x.device), ssm=_stack(m_states))
    return _logits(params, cfg, x[:, -1:], shard), state


def _write(dst: dict, src: dict) -> None:
    """A layer's new recurrent state into its slot of the stacked state."""
    for k, t in dst.items():
        t.copy_(src[k])


@torch.no_grad()
def forward_decode(params: PyTree, cfg: ModelConfig, tokens,
                   state: DecodeState, *, shard=_noshard
                   ) -> tuple[torch.Tensor, DecodeState]:
    """One greedy-decode step. tokens (B,1) int -> logits (B,1,V), new state.

    The step CONSUMES ``state``: each layer's K/V cache slot at ``pos`` and
    each recurrent state (RWKV-6's token shifts and wkv state, Mamba2's conv
    and SSM states) are written in place, and the returned DecodeState holds
    the same tensors with ``pos + 1`` (the reference's decode step donates
    its state the same way, ``donate_argnums=(2,)``). ``pos`` stays a 0-d
    tensor on the device: nothing is read back to the host. Whisper adds
    ``dec_pos`` at ``pos`` clamped into its table (the reference's
    ``dynamic_slice_in_dim`` clamps the start) and attends over its cross
    K/V (``_cross_decode``); an MoE's step dispatches the whole batch as one
    group of B tokens, as the reference's does. Runs without autograd."""
    x = embed_lookup(shard("weights", params["embed"]), tokens)
    pos = state.pos
    fam = cfg.family
    if fam == "audio":
        table = shard("weights", params["dec_pos"])
        at = pos.clamp(0, table.shape[0] - 1).reshape(1).long()
        x = x + table.index_select(0, at)[None]
    x = shard("act_btd_dec", x)

    def self_attn(p, h, i):
        o, _, _ = L.attention_decode(p["attn"], cfg,
                                     L.rmsnorm(p["norm1"], h, cfg.norm_eps),
                                     state.kv_k[i], state.kv_v[i], pos,
                                     shard=shard)
        return shard("act_btd", h + o)

    def attn_step(p, h, i):
        h = self_attn(p, h, i)
        return shard("act_btd", h + L.mlp_apply(
            p["mlp"], cfg, L.rmsnorm(p["norm2"], h, cfg.norm_eps),
            shard=shard))

    layers = (shard("weights", p) for p in _layers(params["layers"], cfg))
    if fam in ("dense", "vlm"):
        for i, p in enumerate(layers):
            x = attn_step(p, x, i)
    elif fam == "moe":
        for i, p in enumerate(layers):
            x = self_attn(p, x, i)
            # the batch's B tokens are one dispatch group: (B,1,d) -> (1,B,d)
            hn = L.rmsnorm(p["norm2"], x, cfg.norm_eps).transpose(0, 1)
            y, _ = L.moe_apply(p["moe"], cfg, hn, shard=shard)
            x = shard("act_btd", x + y.transpose(0, 1))
    elif fam == "audio":
        for i, p in enumerate(layers):
            x = self_attn(p, x, i)
            x = x + _cross_decode(p["xattn"], cfg,
                                  L.rmsnorm(p["norm2"], x, cfg.norm_eps),
                                  state.cross_k[i], state.cross_v[i], shard)
            x = shard("act_btd", x + L.mlp_apply(
                p["mlp"], cfg, L.rmsnorm(p["norm3"], x, cfg.norm_eps),
                shard=shard))
    elif fam == "ssm":
        for i, p in enumerate(layers):
            st = {k: v[i] for k, v in state.ssm.items()}
            o, st2 = L.rwkv6_time_mix(
                p, cfg, L.rmsnorm(p["tm_norm"], x, cfg.norm_eps), state=st,
                shard=shard)
            x = shard("act_btd", x + o)
            o, st3 = L.rwkv6_channel_mix(
                p, cfg, L.rmsnorm(p["cm_norm"], x, cfg.norm_eps), state=st2,
                shard=shard)
            x = shard("act_btd", x + o)
            _write(st, st3)
    elif fam == "hybrid":
        inv = 0
        shared = shard("weights", params["shared_block"])
        for i, p in enumerate(layers):
            st = {k: v[i] for k, v in state.ssm.items()}
            y, st2 = L.mamba2_mix(p["mamba"], cfg,
                                  L.rmsnorm(p["norm"], x, cfg.norm_eps),
                                  state=st, shard=shard)
            x = shard("act_btd", x + y)
            _write(st, st2)
            if _shared_after(cfg, i):
                x = attn_step(shared, x, inv)
                inv += 1
    else:
        raise ValueError(fam)
    return _logits(params, cfg, x, shard), state._replace(pos=pos + 1)


def _cross_decode(p, cfg: ModelConfig, q_in, xk, xv, shard=_noshard):
    """Cross-attention for one decoder position against the cached encoder
    K/V: plain, non-causal, chunks of 512 frames, as the reference's."""
    B = q_in.shape[0]
    hd = cfg.resolved_head_dim
    q = shard("act_heads", L.split_heads(q_in @ p["wq"], cfg.num_heads, hd))
    o = L.attention_core(q, xk.to(q.dtype), xv.to(q.dtype), causal=False,
                         chunk=512, impl="chunked")
    return o.reshape(B, 1, -1) @ p["wo"]


def score_last(params: PyTree, cfg: ModelConfig, tokens) -> torch.Tensor:
    """Last-position logits (B, 1, V) of ``forward_prefill`` without its
    decode state: embed, backbone, final norm and head on the last
    position. This is what the reference's jitted serve step keeps of
    ``forward_prefill`` once XLA drops the unused K/V recompute and cache.
    It takes tokens only, as ``StreamEngine`` serves them (the dense, ssm,
    hybrid and moe families)."""
    x, _ = _backbone(params, cfg, _embed(params, cfg, tokens, None))
    return _logits(params, cfg, x[:, -1:])


def build_model(cfg: ModelConfig) -> dict:
    """The reference's convenience bundle: ``init``, ``train``,
    ``prefill``, ``decode`` and ``init_state`` with ``cfg`` bound."""
    return {
        "init": functools.partial(init_params, cfg),
        "train": functools.partial(forward_train, cfg=cfg),
        "prefill": functools.partial(forward_prefill, cfg=cfg),
        "decode": functools.partial(forward_decode, cfg=cfg),
        "init_state": functools.partial(init_decode_state, cfg),
    }
