"""Model-layout wrappers around the port's hand-written kernels.

On a CUDA tensor each wrapper launches its CUDA kernel; on a CPU tensor the
kernel's wrapper runs its plain version. The routes that reach each kernel,
as in the reference:

* ``flash_attention`` — ``layers.attention_core`` when
  ``cfg.attn_impl == "pallas"`` (the config value keeps the reference's
  name; in the port it selects the CUDA kernel).
* ``rwkv6_wkv`` — ``layers.rwkv6_time_mix(..., impl="pallas")`` with no
  state. With a state (``forward_prefill``'s ssm branch) it falls back to
  the plain ``wkv6_chunked``, and the model's own ``_rwkv_block``
  (``forward_train``, ``score_last``) runs ``wkv6_chunked`` too.
* ``mamba2_ssd`` — called directly; no model layer calls it (the hybrid
  family's ``mamba2_mix`` runs its own chunked scan, in the reference and
  in the port).
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import mamba2_ssd as _ssd
from repro_torch.kernels import rwkv6_wkv as _wkv


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """q (B,S,Hq,hd), k/v (B,Skv,Hkv,hd) — model layout; returns same layout.

    The transposes are views: the kernel reads the strided (B,H,S,hd) view
    and writes a contiguous (B,Hq,S,hd) output, returned transposed back.
    The reference's ``block_q``/``block_k`` are TPU tiling knobs; the CUDA
    kernel's tiles are fixed in its source: in bf16, 64 packed (position,
    q head) rows of one kv head against 64-key tiles; in f32, 16 query rows
    of one q head against 32-key tiles."""
    o = _fa.flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 q_offset=q_offset)
    return o.transpose(1, 2)


def mamba2_ssd(x, bm, cm, loga, *, chunk: int = _ssd.DEFAULT_CHUNK):
    """x (B,nh,S,hd), bm/cm (B,S,ns), loga (B,nh,S) -> y (B,nh,S,hd)."""
    return _ssd.mamba2_ssd(x, bm, cm, loga, chunk=chunk)


def rwkv6_wkv(r, k, v, logw, u, *, state=None,
              chunk: int = _wkv.DEFAULT_CHUNK):
    """Model layout r/k/v/logw (B,S,H,hd) -> (o (B,S,H,hd), S_fin).

    The kernel covers the full-sequence path from a zero state; a non-None
    ``state`` falls back to the plain chunked ``wkv6_chunked``, as in the
    reference. The transposes are views (no copy): the kernel reads the
    strided (B,H,S,hd) views and writes a contiguous (B,H,S,hd) o, returned
    transposed back."""
    if state is not None:
        from repro_torch.models.layers import wkv6_chunked

        return wkv6_chunked(r, k, v, logw, u, state=state, chunk=chunk)
    o, sfin = _wkv.rwkv6_wkv(*(a.transpose(1, 2) for a in (r, k, v, logw)),
                             u, chunk=chunk)
    return o.transpose(1, 2), sfin
