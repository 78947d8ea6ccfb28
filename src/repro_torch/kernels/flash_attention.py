"""Flash attention (GQA, causal or full): the LM engine's attention hot-spot.

Replaces the TPU kernel ``repro.kernels.flash_attention.flash_attention_bhsd``
(``pl.pallas_call`` of ``_attn_kernel``) with a CUDA C++ kernel written by
hand for Hopper, ``csrc/flash_attention.cu``: the same contract — q
(B, Hq, Sq, hd), k/v (B, Hkv, Skv, hd), kv head = q head // (Hq // Hkv),
``q_offset`` for queries that start later than the keys, f32 math on f32 or
bf16 inputs, output in q's dtype.

* ``flash_attention_bhsd`` is the wrapper. On a CUDA tensor it checks dtype,
  shapes and the innermost stride, allocates the output with
  ``torch.empty``, launches the kernel on the current stream and counts the
  launch in ``LAUNCHES``; a failed build or launch raises. On a CPU tensor
  it runs the plain version.
* ``flash_attention_bhsd_ref`` is the plain PyTorch version with the
  semantics of the reference's oracle ``kernels/ref.py::attention_ref``:
  K/V repeated per group, full softmax in f32, output in q's dtype.

Bound on an H100 at the serve shape (B=32, Hq=28, Hkv=4, S=64, hd=128,
bf16, causal): 33.6 MB of q, k, v and o, ~10 us at 3.35 TB/s; ~0.95 GFLOP,
~1 us on the bf16 tensor cores, so memory bounds it (``attention_cost``).
The first design is simple (see the source's header): a warp per 4 query
rows, lanes splitting hd, K/V tiles staged in shared memory, no tensor
cores.

The library is compiled with ``nvcc`` into ``build/kernels/`` at first use
(through ``kernels/build.py``), never at import.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build as kbuild

#: kernel launches (the serve path's proof that it ran on the kernel)
LAUNCHES = 0

SOURCE = "flash_attention.cu"
NVCC_FLAGS = kbuild.FLAGS
#: head widths the kernel is instantiated for
HEAD_DIMS = (32, 64, 128)
_LIB = None


def flash_attention_bhsd_ref(q, k, v, *, causal: bool = True,
                             q_offset: int = 0):
    """q (B,Hq,Sq,hd), k/v (B,Hkv,Skv,hd) -> (B,Hq,Sq,hd). Full softmax."""
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = Hq // Hkv
    kq = torch.repeat_interleave(k, g, dim=1).float()
    vq = torch.repeat_interleave(v, g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() / math.sqrt(hd), kq)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(qpos < kpos, float("-inf"))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", w, vq).to(q.dtype)


def attention_cost(B: int, Hq: int, Hkv: int, Sq: int, Skv: int, hd: int, *,
                   causal: bool, q_offset: int, itemsize: int):
    """(bytes, flops) the function must move and do: q, k, v read once and o
    written once; 4·hd flops (q·k and p·v) per unmasked (query, key) pair."""
    nbytes = itemsize * hd * B * (2 * Hq * Sq + 2 * Hkv * Skv)
    if causal:
        pairs = sum(min(Skv, i + q_offset + 1) for i in range(Sq))
    else:
        pairs = Sq * Skv
    return nbytes, 4 * hd * pairs * B * Hq


def _library():
    global _LIB
    if _LIB is None:
        lib = kbuild.load(SOURCE, NVCC_FLAGS)
        fn = lib.flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def flash_attention_bhsd(q, k, v, *, causal: bool = True,
                         q_offset: int = 0):
    """q (B,Hq,Sq,hd), k/v (B,Hkv,Skv,hd) -> (B,Hq,Sq,hd) in q's dtype.

    The inputs may be strided views (only hd must be contiguous); the output
    is contiguous. ``q_offset`` is the absolute position of query row 0."""
    global LAUNCHES
    if not q.is_cuda:
        return flash_attention_bhsd_ref(q, k, v, causal=causal,
                                        q_offset=q_offset)
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D (B, H, S, hd)")
    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Hkv, Skv, hd) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if Hq % Hkv:
        raise ValueError(f"flash_attention: {Hq} q heads over {Hkv} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    if q.dtype not in kbuild.DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; the kernel takes float32 or bfloat16")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attention: hd must be the contiguous axis")
    q_offset = int(q_offset)
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    lib = _library()
    o = torch.empty((B, Hq, Sq, hd), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            kbuild.DTYPE_CODES[q.dtype], B, Hq, Hkv, Sq, Skv, hd,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            int(causal), q_offset, 1.0 / math.sqrt(hd), stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return o
