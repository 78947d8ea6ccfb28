"""Small helpers shared across the port.

``txp`` is the array namespace the port passes as ``xp=`` to the formulas it
shares with numpy (``service_terms_arrays``, the workload ``device_rate``
laws, ``DeviceLeverTable.step_index``, ``pack_tick_consts``). Those formulas
were written for numpy/``jax.numpy``, whose ``maximum``/``minimum``/``clip``
accept Python scalars; ``torch.maximum`` wants two tensors. ``txp`` routes a
scalar bound through ``torch.clamp`` (the scalar rides in the kernel launch,
so no host-to-device copy and no sync on the hot loop) and keeps torch's
tensor-tensor ops otherwise — one formula, no fork.

``round_up`` is the reference's integer helper (``repro.utils``), copied;
``softmax_cross_entropy`` is its CE in torch; ``tree_map``,
``tree_leaves``, ``tree_zeros_like`` and ``global_norm`` are its tree
helpers over nested dicts, lists and tuples of tensors (the port's
parameter trees; dict keys are walked in insertion order, where
``jax.tree`` sorts them, so a sum over leaves may round differently).
``resolve_device`` is the port's rule for every entry point: ``cuda`` unless
the caller names another device, and no silent fall back to the CPU.
``strict_f32`` keeps f32 matrix products out of TF32 on the card for the
code that needs every digit (the Lasso's normal equations, k-means sums).
"""
from __future__ import annotations

import contextlib
import types
from typing import Any, Callable

import torch

PyTree = Any


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


def _asarray(x, dtype=None):
    """numpy's ``asarray(x, dtype)``: the dtype may come positionally."""
    return torch.as_tensor(x, dtype=dtype)


def _clip(x, lo, hi):
    """numpy's ``clip``: ``minimum(maximum(x, lo), hi)``, tensor bounds allowed."""
    return _minimum(_maximum(x, lo), hi)


txp = types.SimpleNamespace(
    maximum=_maximum,
    minimum=_minimum,
    clip=_clip,
    where=torch.where,
    asarray=_asarray,
    log2=torch.log2,
    sin=torch.sin,
    zeros_like=torch.zeros_like,
    stack=torch.stack,
    float32=torch.float32,
)


def round_up(x: int, to: int) -> int:
    return ((x + to - 1) // to) * to


def resolve_device(device=None, what: str = "the port") -> torch.device:
    """``cuda`` unless the caller asks for another device. Without a card,
    ``device=None`` raises — the CPU runs only on request."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what} runs on a CUDA card and none is available; pass "
                "device='cpu' to run the kernels' plain versions")
        device = "cuda"
    return torch.device(device)


@contextlib.contextmanager
def strict_f32():
    """f32 matrix products in full f32 on the card inside the block (TF32
    keeps ~3 decimal digits); the previous setting is restored after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def softmax_cross_entropy(logits: torch.Tensor,
                          labels: torch.Tensor) -> torch.Tensor:
    """Numerically-stable CE. logits (..., V) f32-accumulated, labels (...) int."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return lse - gold


def tree_map(fn: Callable, tree: PyTree, *rest: PyTree) -> PyTree:
    """``fn`` over the leaves of ``tree`` and of each tree in ``rest`` (same
    structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: PyTree) -> list:
    """The leaves in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_zeros_like(tree: PyTree) -> PyTree:
    return tree_map(torch.zeros_like, tree)


def global_norm(tree: PyTree) -> torch.Tensor:
    """sqrt of the f32 sum of every leaf's f32 sum of squares."""
    leaves = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))
