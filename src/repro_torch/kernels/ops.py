"""Model-layout wrappers around the port's hand-written kernels.

The model layer calls these when ``cfg.attn_impl == "pallas"`` (the config
value keeps the reference's name; in the port it selects the hand-written
CUDA kernel). On a CPU tensor each kernel wrapper runs its plain version.
The ``mamba2_ssd`` and ``rwkv6_wkv`` wrappers come with their kernels.
"""
from __future__ import annotations

from repro_torch.kernels import flash_attention as _fa


def flash_attention(q, k, v, *, causal: bool = True, q_offset: int = 0):
    """q (B,S,Hq,hd), k/v (B,Skv,Hkv,hd) — model layout; returns same layout.

    The transposes are views: the kernel reads the strided (B,H,S,hd) view
    and writes a contiguous (B,Hq,S,hd) output, returned transposed back.
    The reference's ``block_q``/``block_k`` are TPU tiling knobs; the CUDA
    kernel's tiles are fixed in its source."""
    o = _fa.flash_attention_bhsd(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=causal,
                                 q_offset=q_offset)
    return o.transpose(1, 2)
