"""Model layers of the port: ``repro.models.layers`` (attention, the GLU
MLP, the GShard MoE, Mamba2 and RWKV-6).

Conventions
-----------
* Params are nested dicts of tensors in the reference's layout: a linear
  map is a (d_in, d_out) weight applied as ``x @ W``, so the reference's
  arrays load unchanged (``lm.load_reference_params``). Layer stacks are
  either stacked along a leading L axis (``cfg.scan_layers``) or a list.
* Parameters are drawn from an explicit ``torch.Generator`` on their device,
  one tensor at a time: a float32 draw, scaled, then cast to the compute
  dtype, as the reference's ``_init`` does. The port cannot replay
  ``jax.random``; tests carry the reference's weights instead.
* Casts mirror the reference step by step: ``rmsnorm`` and ``apply_rope``
  compute in f32 and cast back; the matmuls run in ``cfg.dtype``; the
  attention upcasts inside.
* ``attention_core`` has the reference's three impls. ``chunked`` and
  ``naive`` are plain torch, as they are plain jnp in the reference;
  ``pallas`` (the config value keeps the reference's name) selects the
  hand-written CUDA kernel ``kernels/csrc/flash_attention.cu``.
* ``rwkv6_time_mix`` has the reference's two impls. ``chunked`` (the
  default, and what ``lm._rwkv_block`` runs) is the plain torch
  ``wkv6_chunked``; ``pallas`` goes through ``kernels/ops.py::rwkv6_wkv``
  to the hand-written CUDA kernel ``kernels/csrc/rwkv6_wkv.cu`` when no
  state is given, and falls back to ``wkv6_chunked`` with one.
  ``wkv6_chunked`` clamps its chunk to S, so a decode step (one token with
  a state) runs one chunk of one step, where the reference pads it to a
  whole chunk.
* ``attention_decode`` and ``mamba2_mix`` are plain torch, as they are
  plain jnp in the reference (its ``mamba2_mix`` runs its own chunked scan,
  ``_ssd_scan`` here, not the SSD kernel). Decode writes its caches and
  states in place (``attention_decode``, ``lm.forward_decode``).
* ``shard(name, x)`` is the reference's injection point for its sharding
  constraints, called at the reference's points; the default is the
  identity. On an LM mesh (``distribution.sharding.make_shard_fn``) the
  activations are DTensors and the hook redistributes them. The kernels
  and the scans run on each rank's own block (``on_blocks``: the batch
  where it is sharded, the heads on the model axis), since heads are
  independent and DTensor has no rule for a hand-written kernel; the
  decode attention's split-K mode (the cache's positions sharded over the
  data axes) combines each rank's softmax partials itself
  (``_decode_attend``).
* ``moe_apply`` is the reference's GShard capacity dispatch in plain torch
  (its dispatch and combine are one-hot einsums outside any Pallas kernel
  there): an f32 router, top-k with renormalised gates, each (token,
  choice) placed in GShard order (all first choices, then all second
  ones, ...), overflow dropped; the dispatch, expert and combine products
  run as batched matmuls over (group, expert · slot) rows.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _noshard(name: str, x):
    return x


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward hands a contiguous gradient on: a
    gradient that leaves a local block in another layout (an einsum's
    backward) would reach DTensor's ``view`` of the block's producer,
    which cannot view it."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def on_blocks(fn, args: tuple, dims: tuple, out_dims: tuple):
    """``fn`` on each rank's own block of DTensor ``args``, outputs wrapped
    back as DTensors. ``dims[i]`` is ``(batch dim, head dim)`` of
    ``args[i]`` (None where it has none; non-tensor args pass through) and
    ``out_dims`` the same for each output. The mesh axes that split the
    first argument's batch or head dim keep splitting them, in every
    argument and output; the others are replicated. A head split that some
    argument's head count does not divide (GQA's kv heads below the model
    axis) runs the heads whole on every rank instead. Plain tensors count
    as replicated. ``to_local`` / ``from_local`` carry the gradients; an
    argument replicated over an axis that splits the others' blocks gets a
    partial gradient there (each rank's share of it)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    lead = args[0]
    mesh = lead.device_mesh
    b0, h0 = dims[0]
    roles = []
    for pl in lead.placements:
        d = pl.dim if isinstance(pl, Shard) else None
        roles.append("b" if d is not None and d == b0 else
                     "h" if d is not None and d == h0 else None)
    for role, k in (("b", 0), ("h", 1)):
        n = 1
        for i, r in enumerate(roles):
            n *= mesh.size(i) if r == role else 1
        if any(isinstance(a, torch.Tensor) and dd[k] is not None
               and a.shape[dd[k]] % n for a, dd in zip(args, dims)):
            roles = [None if r == role else r for r in roles]

    def placement(dd):
        return [Shard(dd[0]) if r == "b" and dd[0] is not None else
                Shard(dd[1]) if r == "h" and dd[1] is not None else
                Replicate() for r in roles]

    def local(a, dd):
        if not isinstance(a, torch.Tensor):
            return a
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        pl = placement(dd)
        grad_pl = [Partial() if p.is_replicate() and r is not None else p
                   for p, r in zip(pl, roles)]
        x = a.redistribute(mesh, pl).to_local(grad_placements=grad_pl)
        return _ContiguousGrad.apply(x) if x.requires_grad else x

    out = fn(*(local(a, dd) for a, dd in zip(args, dims)))
    single = not isinstance(out, tuple)
    outs = (out,) if single else out
    wrapped = tuple(
        DTensor.from_local(o, mesh, placement(dd), run_check=False)
        if isinstance(o, torch.Tensor) else o
        for o, dd in zip(outs, out_dims))
    return wrapped[0] if single else wrapped


def _init(gen: Optional[torch.Generator], shape, scale, dtype,
          device) -> torch.Tensor:
    """``scale · N(0, 1)`` drawn in f32 from ``gen`` on ``device``, then cast.
    On the ``meta`` device (shapes only) nothing is drawn."""
    device = torch.device(device)
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return x.mul_(float(scale)).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, dtype, device) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                        device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: broadcastable to (..., S)."""
    if theta <= 0:  # arch without RoPE (whisper: learned absolute positions)
        return x
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., None].float() * freqs  # (..., S, hd/2)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, hd/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA; self / cross; prefill)
# ---------------------------------------------------------------------------


def init_attention(gen, cfg: ModelConfig, device, *,
                   cross: bool = False) -> dict:
    """Self- or cross-attention weights: the same layout (``cross`` is the
    reference's flag and changes nothing in it)."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nq, nkv = cfg.num_heads, cfg.num_kv_heads
    dt = _dtype(cfg)
    s_in = 1.0 / np.sqrt(d)
    s_out = 1.0 / np.sqrt(nq * hd) / np.sqrt(2 * cfg.num_layers)
    p = {
        "wq": _init(gen, (d, nq * hd), s_in, dt, device),
        "wk": _init(gen, (d, nkv * hd), s_in, dt, device),
        "wv": _init(gen, (d, nkv * hd), s_in, dt, device),
        "wo": _init(gen, (nq * hd, d), s_out, dt, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((nq * hd,), dtype=dt, device=device)
        p["bk"] = torch.zeros((nkv * hd,), dtype=dt, device=device)
        p["bv"] = torch.zeros((nkv * hd,), dtype=dt, device=device)
    return p


def split_heads(x, n: int, hd: int):
    """(..., n·hd) -> (..., n, hd). On an LM mesh, an axis that would split
    the heads unevenly (an unpadded config's GQA kv heads below the model
    axis) is gathered first: its blocks would not be whole heads."""
    if _is_dtensor(x):
        from repro_torch.distribution.sharding import even_placements

        mesh = x.device_mesh
        pl = even_placements(x.placements, x.shape[:-1] + (n,), mesh)
        if pl != list(x.placements):
            x = x.redistribute(mesh, pl)
    return x.reshape(*x.shape[:-1], n, hd)


def _project_qkv(p, cfg: ModelConfig, x, kv_src):
    """Returns q (B,S,nq,hd), k,v (B,Skv,nkv,hd)."""
    hd = cfg.resolved_head_dim
    q = x @ p["wq"]
    k = kv_src @ p["wk"]
    v = kv_src @ p["wv"]
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    B, S = x.shape[:2]
    Skv = kv_src.shape[1]
    q = split_heads(q, cfg.num_heads, hd)
    k = split_heads(k, cfg.num_kv_heads, hd)
    v = split_heads(v, cfg.num_kv_heads, hd)
    return q, k, v


def attention_core(q, k, v, *, causal: bool, chunk: int, q_offset: int = 0,
                   impl: str = "chunked") -> torch.Tensor:
    """GQA attention. q (B,S,nq,hd); k/v (B,Skv,nkv,hd). Returns (B,S,nq,hd).

    ``chunked`` walks KV in blocks with a running (max, denom), holding at
    most (B, nkv, g, S, chunk) scores at once. ``naive`` materialises the
    scores (oracle / tiny shapes). ``pallas`` selects the hand-written CUDA
    flash-attention kernel (``kernels/ops.py::flash_attention``; its plain
    version on CPU tensors).
    """
    if _is_dtensor(q):  # an LM mesh: each rank's batch rows and heads
        return on_blocks(
            lambda q, k, v: attention_core(q, k, v, causal=causal,
                                           chunk=chunk, q_offset=q_offset,
                                           impl=impl),
            (q, k, v), ((0, 2),) * 3, ((0, 2),))
    if impl == "pallas":
        from repro_torch.kernels import ops as kops

        return kops.flash_attention(q, k, v, causal=causal, q_offset=q_offset)

    B, S, nq, hd = q.shape
    Skv, nkv = k.shape[1], k.shape[2]
    g = nq // nkv
    scale = float(1.0 / np.sqrt(hd))
    qf = (q.float() * scale).reshape(B, S, nkv, g, hd)
    q_pos = torch.arange(S, device=q.device) + q_offset  # absolute positions

    if impl == "naive":
        s = torch.einsum("bsngh,btnh->bngst", qf, k.float())  # (B,nkv,g,S,Skv)
        if causal:
            mask = q_pos[:, None] >= torch.arange(Skv, device=q.device)[None, :]
            s = s.masked_fill(~mask, float("-inf"))
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bngst,btnh->bsngh", w, v.float())
        return o.reshape(B, S, nq, hd).to(q.dtype)

    # --- chunked online softmax over KV blocks ---
    chunk = min(chunk, Skv)
    n_chunks = (Skv + chunk - 1) // chunk
    m = torch.full((B, nkv, g, S), float("-inf"), device=q.device)
    l = torch.zeros((B, nkv, g, S), device=q.device)
    acc = torch.zeros((B, nkv, g, S, hd), device=q.device)
    for c in range(n_chunks):
        start = c * chunk
        kb = k[:, start:start + chunk].float()
        vb = v[:, start:start + chunk].float()
        s = torch.einsum("bsngh,btnh->bngst", qf, kb)
        kv_pos = start + torch.arange(kb.shape[1], device=q.device)
        if causal:
            valid = q_pos[:, None] >= kv_pos[None, :]
            s = s.masked_fill(~valid, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        # guard fully-masked rows (m == -inf): exp(-inf - -inf) -> use 0
        safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.exp(s - safe_m[..., None])
        p = torch.where(torch.isfinite(s), p, 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bngst,btnh->bngsh", p, vb)
        m = m_new
    o = acc / torch.clamp(l[..., None], min=1e-30)
    o = o.permute(0, 3, 1, 2, 4).reshape(B, S, nq, hd)
    return o.to(q.dtype)


def attention_apply(p: dict, cfg: ModelConfig, x, *, kv_src=None,
                    causal: Optional[bool] = None, shard=_noshard):
    """Full prefill attention (self by default, cross if kv_src given).
    ``causal`` overrides ``cfg.causal`` (whisper's encoder runs non-causal);
    cross-attention is never causal and never takes the kernel, as in the
    reference (its ``pallas`` impl runs ``chunked`` there)."""
    cross = kv_src is not None
    kv_in = kv_src if cross else x
    q, k, v = _project_qkv(p, cfg, x, kv_in)
    if not cross:
        pos = torch.arange(x.shape[1], device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    q = shard("act_heads", q)
    k = shard("act_kv_heads", k)
    v = shard("act_kv_heads", v)
    is_causal = cfg.causal if causal is None else causal
    o = attention_core(
        q, k, v, causal=is_causal and not cross, chunk=cfg.attn_chunk,
        impl=cfg.attn_impl if cfg.attn_impl != "pallas" or not cross else "chunked",
    )
    o = shard("act_heads", o)
    B, S = x.shape[:2]
    return o.reshape(B, S, -1) @ p["wo"]


def attention_decode(p: dict, cfg: ModelConfig, x, cache_k, cache_v, pos, *,
                     shard=_noshard):
    """One-token decode. x (B,1,d); cache (B,Smax,nkv,hd); pos a 0-d int32
    tensor on x's device.

    Returns (out (B,1,d), cache_k, cache_v). This token's k/v are written
    into the caches at ``pos`` IN PLACE (``index_copy_``; ``pos`` is clamped
    to Smax - 1 as ``dynamic_update_slice`` clamps it) and the same tensors
    are returned: the caller gives the old caches up, as the reference's
    decode step donates its state (``distribution/steps.py``,
    ``donate_argnums=(2,)``). The softmax runs in f32 over the whole cache,
    masked to positions <= pos, so the step is linear in Smax, as in the
    reference; each cache is read through one f32 copy in (B, nkv, Smax, hd)
    order. ``pos`` is only ever used as a tensor: no step waits on the
    host.

    On an LM mesh the caches are DTensors (``_decode_attend_mesh``): each
    rank attends over its own block of the cache, and a cache whose
    positions are split over the data axes (split-K) combines the ranks'
    partial softmaxes."""
    q, k, v = _project_qkv(p, cfg, x, x)
    B = cache_k.shape[0]
    posv = pos.reshape(1, 1).expand(B, 1)
    q = apply_rope(q, posv, cfg.rope_theta)
    k = apply_rope(k, posv, cfg.rope_theta)
    if _is_dtensor(cache_k):
        o = _decode_attend_mesh(q, k, v, cache_k, cache_v, pos)
    else:
        o = _decode_attend(q, k, v, cache_k, cache_v, pos)
    return o.to(x.dtype) @ p["wo"], cache_k, cache_v


def _decode_attend(q, k, v, cache_k, cache_v, pos, *, offset=0,
                   smax: Optional[int] = None, gather=None):
    """The decode attention on plain tensors: write k/v at ``pos`` and
    attend q (B,1,nq,hd) over the cache (B,S,nkv,hd); returns (B,1,nq·hd)
    f32. With ``gather`` the cache holds positions ``offset`` ..
    ``offset + S - 1`` of ``smax`` (a block of a split-K cache): the row at
    ``pos`` is written only by the rank that owns it (the others write
    back what is there), the softmax partials (max, sum of exponentials,
    weighted values) over the block go through ``gather`` (stacked over
    the blocks on a new leading axis) and are combined, the flash-decoding
    combine."""
    B, S, nkv, hd = cache_k.shape
    smax = S if smax is None else smax
    at = pos.clamp(max=smax - 1).reshape(1).long()
    if gather is None:
        cache_k.index_copy_(1, at, k.to(cache_k.dtype))
        cache_v.index_copy_(1, at, v.to(cache_v.dtype))
    else:
        loc = at - offset
        owns = (loc >= 0) & (loc < S)
        loc = loc.clamp(0, S - 1)
        for cache, new in ((cache_k, k), (cache_v, v)):
            row = torch.where(owns, new.to(cache.dtype),
                              cache.index_select(1, loc))
            cache.index_copy_(1, loc, row)
    nq = q.shape[2]
    g = nq // nkv
    scale = float(1.0 / np.sqrt(hd))
    qf = (q.float() * scale).reshape(B, nkv, g, hd)

    def f32(cache):  # (B, nkv, S, hd), one contiguous f32 copy
        return cache.transpose(1, 2).to(torch.float32,
                                        memory_format=torch.contiguous_format)

    s = qf @ f32(cache_k).transpose(-1, -2)  # (B, nkv, g, S)
    valid = torch.arange(S, device=q.device)
    valid = (valid + offset if offset else valid) <= pos
    s = s.masked_fill(~valid, float("-inf"))
    if gather is None:
        w = torch.softmax(s, dim=-1)
        return (w @ f32(cache_v)).reshape(B, 1, nq * hd)
    m = s.amax(dim=-1, keepdim=True)
    pexp = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    part = torch.cat([m, pexp.sum(dim=-1, keepdim=True),
                      pexp @ f32(cache_v)], dim=-1)  # (B, nkv, g, 2 + hd)
    parts = gather(part)                             # (n, B, nkv, g, 2 + hd)
    mx = parts[..., :1].amax(dim=0)
    w = torch.exp(parts[..., :1] - mx)
    den = (w * parts[..., 1:2]).sum(dim=0)
    o = (w * parts[..., 2:]).sum(dim=0) / den
    return o.reshape(B, 1, nq * hd)


def _decode_attend_mesh(q, k, v, cache_k, cache_v, pos):
    """``_decode_attend`` on each rank's block of DTensor caches (B, Smax,
    nkv, hd): q, k and v take the caches' batch and head placements and
    are replicated over the axes that split the positions; those axes
    (split-K) gather the softmax partials, one all-gather an axis. Returns
    a (B, 1, nq·hd) f32 DTensor."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.distribution.sharding import block_index, whole

    mesh = cache_k.device_mesh
    cp = cache_k.placements
    seq = [i for i, pl in enumerate(cp) if pl == Shard(1)]
    tp = [pl if pl in (Shard(0), Shard(2)) else Replicate() for pl in cp]
    q, k, v = (t.redistribute(mesh, tp).to_local() for t in (q, k, v))
    ck, cv = cache_k.to_local(), cache_v.to_local()
    posl = whole(pos)
    smax = cache_k.shape[1]
    offset, gather = 0, None
    if seq:
        n = 1
        for i in seq:
            n *= mesh.size(i)
        if smax % n:
            raise ValueError(f"a split-K cache of {smax} positions over {n} "
                             "ranks must split evenly")
        offset = block_index(mesh, seq) * (smax // n)

        def gather(part):
            out = part[None]
            for i in seq:
                out = funcol.all_gather_tensor(out, 0, (mesh, i))
            return funcol.wait_tensor(out) if hasattr(funcol, "wait_tensor") \
                else out
    o = _decode_attend(q, k, v, ck, cv, posl, offset=offset, smax=smax,
                       gather=gather)
    opl = [Shard(0) if pl == Shard(0) else Shard(2) if pl == Shard(2)
           else Replicate() for pl in tp]
    return DTensor.from_local(o, mesh, opl, run_check=False)


# ---------------------------------------------------------------------------
# MLP (GLU)
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg: ModelConfig, device, d_ff: Optional[int] = None) -> dict:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = _dtype(cfg)
    s_in = 1.0 / np.sqrt(d)
    s_out = 1.0 / np.sqrt(f) / np.sqrt(2 * cfg.num_layers)
    return {
        "wg": _init(gen, (d, f), s_in, dt, device),
        "wu": _init(gen, (d, f), s_in, dt, device),
        "wd": _init(gen, (f, d), s_out, dt, device),
    }


def _act(name: str):
    # jax.nn.gelu is the tanh approximation by default
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


def mlp_apply(p: dict, cfg: ModelConfig, x, *, shard=_noshard) -> torch.Tensor:
    h = _act(cfg.act)(x @ p["wg"]) * (x @ p["wu"])
    h = shard("act_ff", h)
    return h @ p["wd"]


# ---------------------------------------------------------------------------
# Mixture of Experts (GShard capacity dispatch)
# ---------------------------------------------------------------------------


def init_moe(gen, cfg: ModelConfig, device) -> dict:
    """The reference's layout: an f32 router (d, E) in every dtype, the
    experts' GLU weights stacked on a leading E axis, and, with shared
    experts, one MLP of hidden ``cfg.d_ff`` behind a (d, 1) sigmoid gate."""
    d, m, E = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    dt = _dtype(cfg)
    s_in = 1.0 / np.sqrt(d)
    s_out = 1.0 / np.sqrt(m) / np.sqrt(2 * cfg.num_layers)
    p = {
        "router": _init(gen, (d, E), s_in, torch.float32, device),
        "wg": _init(gen, (E, d, m), s_in, dt, device),
        "wu": _init(gen, (E, d, m), s_in, dt, device),
        "wd": _init(gen, (E, m, d), s_out, dt, device),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, cfg, device, cfg.d_ff)
        p["shared_gate"] = torch.zeros((d, 1), dtype=dt, device=device)
    return p


def moe_capacity(cfg: ModelConfig, S: int) -> int:
    """Slots an expert has in a dispatch group of S tokens: ceil(S·k/E·cf),
    at least 4 and at most S·k, in the reference's Python floats."""
    E, k, cf = cfg.num_experts, cfg.moe_top_k, cfg.moe_capacity_factor
    return max(4, min(int(np.ceil(S * k / E * cf)), S * k))


def moe_route(p: dict, cfg: ModelConfig, x):
    """The router of groups x (G, S, d): (probs (G,S,E) f32, gate_idx
    (G,S,k), renormalised gate values (G,S,k), queue positions (G,S,k),
    counts (G,E)), the last two from ``moe_queue``."""
    probs = torch.softmax(x.float() @ p["router"], dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.moe_top_k, dim=-1)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return (probs, gate_idx, gate_vals,
            *moe_queue(gate_idx, cfg.num_experts))


def moe_queue(gate_idx, E: int):
    """(queue positions (G,S,k), counts (G,E)) of the choices gate_idx
    (G,S,k) among E experts. A (token, choice)'s position in its expert's
    queue follows GShard order: all first choices of the group by
    position, then all second choices, and so on; counts are every choice
    routed to an expert, dropped or not."""
    counts = torch.zeros((gate_idx.shape[0], E), dtype=torch.long,
                         device=gate_idx.device)
    pos = []
    for c in range(gate_idx.shape[-1]):
        onehot = F.one_hot(gate_idx[..., c], E)  # (G,S,E)
        in_e = onehot.cumsum(dim=1) - onehot + counts[:, None, :]
        pos.append(in_e.gather(2, gate_idx[..., c:c + 1])[..., 0])
        counts = counts + onehot.sum(dim=1)
    return torch.stack(pos, dim=-1), counts


def moe_apply(p: dict, cfg: ModelConfig, x, *, shard=_noshard):
    """x (B,S,d) -> (out, aux). Dispatch groups are the batch rows or,
    where ``cfg.moe_group_size`` G is set, below S and divides it, rows of
    G tokens (the one-hot products cost O(S·E·C·d) with C ∝ S). aux:
    ``moe_drop_frac`` (the share of routed choices dropped for capacity)
    and ``moe_lb_loss`` (E · Σ mean prob · first-choice share)."""
    if _is_dtensor(x) and any(pl.is_shard(1) for pl in x.placements):
        # a group's queue runs over all its tokens: gather them (an MoE
        # decode step's group is the batch, split over the data axes)
        from torch.distributed.tensor import Replicate

        whole = [Replicate() if pl.is_shard(1) else pl for pl in x.placements]
        out, aux = moe_apply(p, cfg, x.redistribute(x.device_mesh, whole),
                             shard=shard)
        return out.redistribute(x.device_mesh, x.placements), aux
    B0, S0, d0 = x.shape
    G = cfg.moe_group_size
    if G and S0 > G and S0 % G == 0:
        out, aux = _moe_apply_grouped(p, cfg,
                                      x.reshape(B0 * (S0 // G), G, d0), shard)
        return out.reshape(B0, S0, d0), aux
    return _moe_apply_grouped(p, cfg, x, shard)


def _moe_apply_grouped(p: dict, cfg: ModelConfig, x, shard=_noshard):
    B, S, d = x.shape
    E = cfg.num_experts
    C = moe_capacity(cfg, S)
    probs, gate_idx, gate_vals, pos, counts = moe_route(p, cfg, x)
    fits = pos < C
    # each (token, choice) that fits takes slot e·C + pos of the (E·C)
    # one-hot rows; a token's k choices name k distinct experts
    slot = gate_idx * C + pos.clamp(max=C - 1)
    zeros = torch.zeros((B, S, E * C), dtype=torch.float32, device=x.device)
    dispatch = zeros.scatter_add(2, slot, fits.float()).to(x.dtype)
    combine = zeros.scatter_add(2, slot, gate_vals * fits).to(x.dtype)

    xin = torch.bmm(dispatch.transpose(1, 2), x)  # (B, E·C, d)
    xe = xin.reshape(B, E, C, d).transpose(0, 1).reshape(E, B * C, d)
    h = _act(cfg.act)(torch.bmm(xe, p["wg"])) * torch.bmm(xe, p["wu"])
    h = shard("act_moe_ff", h)
    out_e = torch.bmm(h, p["wd"])  # (E, B·C, d)
    out_e = out_e.reshape(E, B, C, d).transpose(0, 1).reshape(B, E * C, d)
    out = torch.bmm(combine, out_e)  # (B, S, d)

    if "shared" in p:
        g = torch.sigmoid(x @ p["shared_gate"])
        out = out + g * mlp_apply(p["shared"], cfg, x, shard=shard)

    dropped = 1.0 - counts.clamp(max=C).sum() / counts.sum().clamp(min=1)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(gate_idx[..., 0], E).float().mean(dim=(0, 1))
    return out, {"moe_drop_frac": dropped,
                 "moe_lb_loss": E * torch.sum(me * ce)}


# ---------------------------------------------------------------------------
# Mamba2 (SSD, chunked) — zamba2 backbone
# ---------------------------------------------------------------------------


def init_mamba2(gen, cfg: ModelConfig, device) -> dict:
    """The reference's layout: the z/x/B/C/dt projections kept separate and
    the depthwise convolutions kept per stream (x/B/C)."""
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    ns, hd = cfg.ssm_state, cfg.ssm_head_dim
    nh = d_in // hd
    dt = _dtype(cfg)
    s = 1.0 / np.sqrt(d)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "z_proj": _init(gen, (d, d_in), s, dt, device),
        "x_proj": _init(gen, (d, d_in), s, dt, device),
        "B_proj": _init(gen, (d, ns), s, dt, device),
        "C_proj": _init(gen, (d, ns), s, dt, device),
        "dt_proj": _init(gen, (d, nh), s, dt, device),
        "conv_x_w": _init(gen, (4, d_in), 0.2, dt, device),
        "conv_x_b": torch.zeros((d_in,), dtype=dt, device=device),
        "conv_B_w": _init(gen, (4, ns), 0.2, dt, device),
        "conv_B_b": torch.zeros((ns,), dtype=dt, device=device),
        "conv_C_w": _init(gen, (4, ns), 0.2, dt, device),
        "conv_C_b": torch.zeros((ns,), dtype=dt, device=device),
        "A_log": torch.log(torch.arange(1, nh + 1, **f32)),
        "D": torch.ones((nh,), **f32),
        "dt_bias": torch.zeros((nh,), **f32),
        "norm": init_rmsnorm(d_in, dt, device),
        "out_proj": _init(gen, (d_in, d), 1.0 / np.sqrt(d_in), dt, device),
    }


def _depthwise_conv(x, w, b, state: Optional[torch.Tensor]):
    """Causal depthwise conv, width K. x (B,S,Cd), w (K,Cd). Returns (y,
    new_state): the last K - 1 inputs, the state included."""
    K = w.shape[0]
    if state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i:i + x.shape[1]] * w[i] for i in range(K))
    return F.silu(y + b), xp[:, xp.shape[1] - (K - 1):]


def _ssd_scan(xdt, Bf, Cf, loga, chunk: int):
    """``mamba2_mix``'s chunked SSD scan (the reference's ``lax.scan``
    body). xdt (B,S,nh,hd) Δ-scaled input, Bf/Cf (B,S,ns), loga (B,S,nh)
    per-step log decay (<= 0), all f32. Returns (y (B,S,nh,hd), the final
    state h (B,nh,hd,ns)) with y_t = C_t · h_t, h_t = e^{loga_t} h_{t-1} +
    x_t B_tᵀ: the decay is INCLUSIVE (y_t reads the state after step t's
    own decay). Padded steps have loga 0 and no input."""
    B, S, nh, hd = xdt.shape
    nch = -(-S // chunk)
    pad = nch * chunk - S

    def padc(a):
        return F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))

    xp, bp, cp, lp = padc(xdt), padc(Bf), padc(Cf), padc(loga)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=xdt.device).tril()[None, :, :, None]
    h = torch.zeros((B, nh, hd, Bf.shape[-1]), dtype=torch.float32,
                    device=xdt.device)
    ys = []
    for c in range(nch):
        sl = slice(c * chunk, (c + 1) * chunk)
        xb, bb, cb, lab = xp[:, sl], bp[:, sl], cp[:, sl], lp[:, sl]
        cum = lab.cumsum(dim=1)  # (B,C,nh) inclusive
        y_inter = torch.einsum("bcs,bnhs->bcnh", cb, h) * cum.exp()[..., None]
        # intra-chunk: L[t,s] = exp(cum_t - cum_s) for s <= t (per head).
        # The EXPONENT is masked (not the exp): exp of the s > t branch
        # overflows and would poison gradients through the where.
        lmat = torch.where(mask, cum[:, :, None, :] - cum[:, None, :, :],
                           -1e30).exp()  # (B,C,C,nh)
        cb_dot = torch.einsum("bcs,bds->bcd", cb, bb)  # (B,C,C)
        y_intra = torch.einsum("bcdn,bdnh->bcnh", cb_dot[..., None] * lmat, xb)
        tot = cum[:, -1:, :]  # (B,1,nh)
        upd = torch.einsum("bcnh,bcs->bnhs",
                           xb * (tot - cum).exp()[..., None], bb)
        h = h * tot[:, 0].exp()[:, :, None, None] + upd
        ys.append(y_inter + y_intra)
    return torch.cat(ys, dim=1)[:, :S], h


def mamba2_mix(p: dict, cfg: ModelConfig, x, *, state: Optional[dict] = None,
               chunk: int = 64, return_state: bool = False, shard=_noshard):
    """Chunked SSD. x (B,S,d). state={'conv_x','conv_B','conv_C','ssm'} for
    decode (S == 1), which returns the new state; ``return_state=True`` makes
    the full-sequence path return its final state too (prefill)."""
    B, S, d = x.shape
    d_in = cfg.ssm_expand * d
    hd = cfg.ssm_head_dim
    nh = d_in // hd

    z = x @ p["z_proj"]
    dt_raw = x @ p["dt_proj"]
    st = state or {}
    xs, cs_x = _depthwise_conv(x @ p["x_proj"], p["conv_x_w"], p["conv_x_b"],
                               st.get("conv_x"))
    Bmat, cs_B = _depthwise_conv(x @ p["B_proj"], p["conv_B_w"],
                                 p["conv_B_b"], st.get("conv_B"))
    Cmat, cs_C = _depthwise_conv(x @ p["C_proj"], p["conv_C_w"],
                                 p["conv_C_b"], st.get("conv_C"))
    conv_state = {"conv_x": cs_x.float(), "conv_B": cs_B.float(),
                  "conv_C": cs_C.float()}
    dt_v = F.softplus(dt_raw.float() + p["dt_bias"])  # (B,S,nh)
    A = -torch.exp(p["A_log"])  # (nh,)
    xh = xs.reshape(B, S, nh, hd).float()
    Bf, Cf = Bmat.float(), Cmat.float()  # (B,S,ns)
    loga = dt_v * A  # (B,S,nh) per-step log decay (<= 0)
    xdt = xh * dt_v[..., None]  # Δ-scaled input

    def out(y, new_state):
        y = y.reshape(B, S, d_in)
        y = rmsnorm(p["norm"], (y * F.silu(z.float())).to(x.dtype),
                    cfg.norm_eps)
        y = shard("act_ssm", y)
        return y @ p["out_proj"], new_state

    if state is not None:  # single-token decode
        h_new = state["ssm"] * loga[:, 0].exp()[..., None, None] + \
            torch.einsum("bnh,bs->bnhs", xdt[:, 0], Bf[:, 0])
        y = torch.einsum("bnhs,bs->bnh", h_new, Cf[:, 0])
        y = y + p["D"][None, :, None] * xh[:, 0]
        return out(y, {**conv_state, "ssm": h_new})

    if _is_dtensor(xdt):  # an LM mesh: each rank's batch rows and heads
        y, h_last = on_blocks(
            lambda *a: _ssd_scan(*a, chunk), (xdt, Bf, Cf, loga),
            ((0, 2), (0, None), (0, None), (0, 2)), ((0, 2), (0, 1)))
    else:
        y, h_last = _ssd_scan(xdt, Bf, Cf, loga, chunk)
    y = y + p["D"][None, None, :, None] * xh
    return out(y, {**conv_state, "ssm": h_last} if return_state else None)


def init_mamba2_state(cfg: ModelConfig, batch: int, device) -> dict:
    d_in = cfg.ssm_expand * cfg.d_model
    ns, hd = cfg.ssm_state, cfg.ssm_head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "conv_x": torch.zeros((batch, 3, d_in), **f32),
        "conv_B": torch.zeros((batch, 3, ns), **f32),
        "conv_C": torch.zeros((batch, 3, ns), **f32),
        "ssm": torch.zeros((batch, d_in // hd, hd, ns), **f32),
    }


# ---------------------------------------------------------------------------
# RWKV6 (Finch) — chunked wkv with data-dependent per-channel decay
# ---------------------------------------------------------------------------


def init_rwkv6(gen, cfg: ModelConfig, device) -> dict:
    d = cfg.d_model
    dt = _dtype(cfg)
    s = 1.0 / np.sqrt(d)
    lora = 64
    f = cfg.d_ff
    full = lambda shape, value, dtype: torch.full(shape, value, dtype=dtype,
                                                   device=device)
    return {
        "tm_norm": init_rmsnorm(d, dt, device),
        "mix_rkvwg": full((5, d), 0.5, dt),  # token-shift mixes for r,k,v,w,g
        "wr": _init(gen, (d, d), s, dt, device),
        "wk": _init(gen, (d, d), s, dt, device),
        "wv": _init(gen, (d, d), s, dt, device),
        "wg": _init(gen, (d, d), s, dt, device),
        "w_lora_a": _init(gen, (d, lora), s, dt, device),
        "w_lora_b": _init(gen, (lora, d), 0.1 / np.sqrt(lora), dt, device),
        "w_bias": full((d,), -6.0, torch.float32),
        "u_bonus": full((d,), 0.0, torch.float32),
        "wo": _init(gen, (d, d), s / np.sqrt(2 * cfg.num_layers), dt, device),
        "ln_x": init_rmsnorm(d, dt, device),
        "cm_norm": init_rmsnorm(d, dt, device),
        "mix_cm": full((2, d), 0.5, dt),
        "cm_k": _init(gen, (d, f), s, dt, device),
        "cm_v": _init(gen, (f, d), 1.0 / np.sqrt(f) / np.sqrt(2 * cfg.num_layers),
                      dt, device),
        "cm_r": _init(gen, (d, d), s, dt, device),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor]):
    """Shifted sequence (x_{t-1}); prev (B,1,d) carries across decode steps."""
    if prev is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([prev.to(x.dtype), x], dim=1)[:, :-1]


def wkv6_chunked(r, k, v, logw, u, state: Optional[torch.Tensor] = None,
                 chunk: int = 32):
    """Chunked RWKV6 recurrence, plain torch.

    r,k,v (B,S,H,hd); logw (B,S,H,hd) per-channel log decay (<=0);
    u (H,hd) bonus. Returns (o (B,S,H,hd) f32, final state (B,H,hd,hd)).
      S_t = diag(w_t) S_{t-1} + k_t^T v_t ;  o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    All exponents are differences of cumulative sums with s<=t, hence <=0;
    the masked (s>=t) exponents are set to -1e30 before ``exp``. The chunk
    is clamped to S, so a short input (a decode step, S == 1) is not padded.
    """
    B, S, H, hd = r.shape
    chunk = min(chunk, S)
    nch = -(-S // chunk)
    pad = nch * chunk - S

    def padc(a):  # zero-padded steps: decay 1, no input
        return F.pad(a.float(), (0, 0, 0, 0, 0, pad))

    rc, kc, vc, lw = padc(r), padc(k), padc(v), padc(logw)
    uf = u.float()
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=r.device).tril(-1)[None, :, :, None, None]
    Sst = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
           if state is None else state.float())
    outs = []
    for c in range(nch):
        sl = slice(c * chunk, (c + 1) * chunk)
        rb, kb, vb, lwb = rc[:, sl], kc[:, sl], vc[:, sl], lw[:, sl]
        cum = lwb.cumsum(dim=1)  # inclusive cumsum of log w
        cum_excl = cum - lwb     # exclusive: sum_{s<t}
        # inter: o_t += (r_t * exp(cum_excl_t)) @ S_in
        o_inter = torch.einsum("bchk,bhkv->bchv", rb * cum_excl.exp(), Sst)
        # intra (s < t): D[t,s,:] = exp(cum_excl_t - cum_s)
        Dm = (cum_excl[:, :, None] - cum[:, None, :]).masked_fill(
            ~mask, -1e30).exp()  # (B,C,C,H,hd)
        att = (rb[:, :, None] * Dm * kb[:, None]).sum(-1)  # (B,C,C,H)
        o_intra = torch.einsum("bcsh,bshv->bchv", att, vb)
        # current-token bonus
        o_bonus = (rb * kb * uf).sum(-1, keepdim=True) * vb
        # state update: S_out = diag(exp(cum_C)) S_in + sum_s diag(exp(cum_C-cum_s)) k_s^T v_s
        tot = cum[:, -1]  # (B,H,hd)
        k_dec = kb * (tot[:, None] - cum).exp()
        Sst = Sst * tot.exp()[..., None] + torch.einsum("bshk,bshv->bhkv",
                                                         k_dec, vb)
        outs.append(o_inter + o_intra + o_bonus)
    return torch.cat(outs, dim=1)[:, :S], Sst


def rwkv6_time_mix(p: dict, cfg: ModelConfig, x, *, state: Optional[dict] = None,
                   impl: str = "chunked", shard=_noshard):
    B, S, d = x.shape
    H, hd = cfg.num_heads, cfg.ssm_head_dim
    prev = None if state is None else state["shift_tm"]
    xs = _token_shift(x, prev)
    mixes = p["mix_rkvwg"]

    def mixed(i):
        return x + (xs - x) * mixes[i]

    r = (mixed(0) @ p["wr"]).reshape(B, S, H, hd)
    k = (mixed(1) @ p["wk"]).reshape(B, S, H, hd)
    v = (mixed(2) @ p["wv"]).reshape(B, S, H, hd)
    w_in = mixed(3)
    g = F.silu(mixed(4) @ p["wg"])
    # data-dependent decay via LoRA; logw <= ~0, clamped for fp32 safety
    w_raw = p["w_bias"] + ((w_in @ p["w_lora_a"]) @ p["w_lora_b"]).float()
    logw = -torch.exp(torch.clamp(w_raw, -20.0, 1.0))  # (B,S,d) in (-e, 0)
    logw = torch.clamp(logw, -8.0, -1e-6).reshape(B, S, H, hd)
    u = p["u_bonus"].reshape(H, hd)

    wkv_state = None if state is None else state["wkv"]
    if _is_dtensor(r):  # an LM mesh: each rank's batch rows and heads
        o, S_fin = on_blocks(
            lambda *a: _wkv(impl, cfg, *a), (r, k, v, logw, u, wkv_state),
            ((0, 2),) * 4 + ((None, 0), (0, 1)), ((0, 2), (0, 1)))
    else:
        o, S_fin = _wkv(impl, cfg, r, k, v, logw, u, wkv_state)
    o = rmsnorm(p["ln_x"], o.reshape(B, S, d).to(x.dtype), cfg.norm_eps)
    o = shard("act_ssm", o * g.to(o.dtype))
    out = o @ p["wo"]
    new_state = None
    if state is not None:
        new_state = {**state, "shift_tm": x[:, -1:], "wkv": S_fin}
    return out, new_state


def _wkv(impl: str, cfg: ModelConfig, r, k, v, logw, u, state):
    """The wkv recurrence by ``impl``: the kernel (``pallas``) or the plain
    ``wkv6_chunked``."""
    if impl == "pallas":
        from repro_torch.kernels import ops as kops

        return kops.rwkv6_wkv(r, k, v, logw, u, chunk=cfg.wkv_chunk,
                              state=state)
    return wkv6_chunked(r, k, v, logw, u, chunk=cfg.wkv_chunk, state=state)


def rwkv6_channel_mix(p: dict, cfg: ModelConfig, x, *,
                      state: Optional[dict] = None, shard=_noshard):
    prev = None if state is None else state["shift_cm"]
    xs = _token_shift(x, prev)
    xk = x + (xs - x) * p["mix_cm"][0]
    xr = x + (xs - x) * p["mix_cm"][1]
    kk = torch.square(F.relu(xk @ p["cm_k"]))
    kk = shard("act_ff", kk)
    out = torch.sigmoid(xr @ p["cm_r"]) * (kk @ p["cm_v"])
    new_state = None if state is None else {**state, "shift_cm": x[:, -1:]}
    return out, new_state


def init_rwkv6_state(cfg: ModelConfig, batch: int, device) -> dict:
    H, hd = cfg.num_heads, cfg.ssm_head_dim
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "shift_tm": torch.zeros((batch, 1, cfg.d_model), **f32),
        "shift_cm": torch.zeros((batch, 1, cfg.d_model), **f32),
        "wkv": torch.zeros((batch, H, hd, hd), **f32),
    }
