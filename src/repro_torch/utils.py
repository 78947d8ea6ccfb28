"""Small helpers shared across the port.

``txp`` is the array namespace the port passes as ``xp=`` to the formulas it
shares with numpy (``service_terms_arrays``, the workload ``device_rate``
laws, ``DeviceLeverTable.step_index``, ``pack_tick_consts``). Those formulas
were written for numpy/``jax.numpy``, whose ``maximum``/``minimum``/``clip``
accept Python scalars; ``torch.maximum`` wants two tensors. ``txp`` routes a
scalar bound through ``torch.clamp`` (the scalar rides in the kernel launch,
so no host-to-device copy and no sync on the hot loop) and keeps torch's
tensor-tensor ops otherwise — one formula, no fork.
"""
from __future__ import annotations

import types

import torch


def _maximum(a, b):
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    if isinstance(b, torch.Tensor):
        return torch.maximum(a, b)
    return torch.clamp(a, min=b)


def _minimum(a, b):
    if not isinstance(a, torch.Tensor):
        a, b = b, a
    if isinstance(b, torch.Tensor):
        return torch.minimum(a, b)
    return torch.clamp(a, max=b)


def _clip(x, lo, hi):
    """numpy's ``clip``: ``minimum(maximum(x, lo), hi)``, tensor bounds allowed."""
    return _minimum(_maximum(x, lo), hi)


txp = types.SimpleNamespace(
    maximum=_maximum,
    minimum=_minimum,
    clip=_clip,
    where=torch.where,
    asarray=torch.as_tensor,
    log2=torch.log2,
    sin=torch.sin,
    zeros_like=torch.zeros_like,
    stack=torch.stack,
    float32=torch.float32,
)
