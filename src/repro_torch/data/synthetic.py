"""Synthetic LM batches, as ``repro.data.synthetic.make_batch`` draws them,
and their shapes (``batch_spec``).

The draws are the reference's numpy draws from ``seed`` in its order, so
the tokens and labels are the reference's bit for bit; the tensors are
made on a device (``cuda`` unless another device is named).
``batch_spec`` gives the same structure as tensors on the ``meta`` device
(shapes and dtypes, no data), the port's stand-in for the reference's
``jax.ShapeDtypeStruct``. Structure per architecture family:

* all archs:  tokens (B,S) int32, labels (B,S) int32, mask (B,S) f32
* vlm:        + patch_embeds (B, vision_tokens, d_model)
* audio:      + frames (B, encoder_seq, d_model)   (stub frontend)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.utils import resolve_device


def _act_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def make_batch(cfg: ModelConfig, batch: int, seq: int, seed: int = 0,
               device=None) -> dict:
    device = resolve_device(device, "make_batch")
    rng = np.random.default_rng(seed)
    vocab = cfg.vocab_true or cfg.vocab_size
    ints = lambda a: torch.from_numpy(a.astype(np.int32)).to(device)
    out = {
        "tokens": ints(rng.integers(0, vocab, (batch, seq))),
        "labels": ints(rng.integers(0, vocab, (batch, seq))),
        "mask": torch.ones((batch, seq), dtype=torch.float32, device=device),
    }
    floats = lambda a: torch.from_numpy(a).to(device, _act_dtype(cfg))
    if cfg.family == "vlm":
        out["patch_embeds"] = floats(
            rng.normal(0, 1, (batch, cfg.vision_tokens, cfg.d_model)))
    if cfg.family == "audio":
        out["frames"] = floats(
            rng.normal(0, 1, (batch, cfg.encoder_seq, cfg.d_model)))
    return out


def batch_spec(cfg: ModelConfig, batch: int, seq: int) -> dict:
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype,
                                            device="meta")
    out = {
        "tokens": meta((batch, seq), torch.int32),
        "labels": meta((batch, seq), torch.int32),
        "mask": meta((batch, seq), torch.float32),
    }
    if cfg.family == "vlm":
        out["patch_embeds"] = meta((batch, cfg.vision_tokens, cfg.d_model),
                                   _act_dtype(cfg))
    if cfg.family == "audio":
        out["frames"] = meta((batch, cfg.encoder_seq, cfg.d_model),
                             _act_dtype(cfg))
    return out
