"""Model layers of the port: the dense subset of ``repro.models.layers``.

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

MoE, Mamba2, RWKV6 and ``attention_decode`` come with later slices.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


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


def init_attention(gen, cfg: ModelConfig, device) -> dict:
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
    q = q.reshape(B, S, cfg.num_heads, hd)
    k = k.reshape(B, Skv, cfg.num_kv_heads, hd)
    v = v.reshape(B, Skv, cfg.num_kv_heads, hd)
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


def attention_apply(p: dict, cfg: ModelConfig, x, *, kv_src=None):
    """Full prefill attention (self by default, cross if kv_src given)."""
    cross = kv_src is not None
    kv_in = kv_src if cross else x
    q, k, v = _project_qkv(p, cfg, x, kv_in)
    if not cross:
        pos = torch.arange(x.shape[1], device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    o = attention_core(
        q, k, v, causal=cfg.causal and not cross, chunk=cfg.attn_chunk,
        impl=cfg.attn_impl if cfg.attn_impl != "pallas" or not cross else "chunked",
    )
    B, S = x.shape[:2]
    return o.reshape(B, S, -1) @ p["wo"]


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


def mlp_apply(p: dict, cfg: ModelConfig, x) -> torch.Tensor:
    h = _act(cfg.act)(x @ p["wg"]) * (x @ p["wu"])
    return h @ p["wd"]
