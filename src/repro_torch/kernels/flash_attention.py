"""Flash attention (GQA, causal or full): the LM engine's attention hot-spot.

Replaces the TPU kernel ``repro.kernels.flash_attention.flash_attention_bhsd``
(``pl.pallas_call`` of ``_attn_kernel``) with a CUDA C++ kernel written by
hand for Hopper, ``csrc/flash_attention.cu``: the same contract — q
(B, Hq, Sq, hd), k/v (B, Hkv, Skv, hd), kv head = q head // (Hq // Hkv),
``q_offset`` for queries that start later than the keys, f32 softmax on f32
or bf16 inputs, p rounded to v's dtype before p·v, output in q's dtype.

* ``flash_attention_bhsd`` is the wrapper. On a CUDA tensor it checks the
  launch layout (``_launch_layout``), allocates the output with
  ``torch.empty``, launches the kernel on the current stream and counts the
  launch in ``LAUNCHES``; a layout the kernel cannot take, a failed build or
  a failed launch raises. On a CPU tensor it runs the plain version.
* ``flash_attention_bhsd_ref`` is the plain PyTorch version with the
  semantics of the reference's oracle ``kernels/ref.py::attention_ref``:
  K/V repeated per group, full softmax in f32, output in q's dtype.

Bound on an H100 at the serve shape (B=32, Hq=28, Hkv=4, S=64, hd=128,
bf16, causal): 33.6 MB of q, k, v and o, ~10 us at 3.35 TB/s; ~0.95 GFLOP,
~1 us on the bf16 tensor cores, so memory bounds it (``attention_cost``).

Design (the source's header has the details). bf16 runs on the tensor
cores: one block per (b, kv head, 64 packed rows), a packed row being one
(position, q head of the group) pair, so a kv head's K/V tiles are read once
for its whole group; ``mma.sync`` m16n8k16 for q·kᵀ and p·v, P reused
from the score registers, the softmax in 32-key steps so that four blocks
fit an SM; 16-byte ``cp.async`` staging of Q and of 64-key K/V tiles in
bf16 (double-buffered when a launch has several); a causal tile reads only
the keys its last position sees; the output leaves through shared memory
in 16-byte stores. That staging needs every row start
16-byte aligned, which ``_launch_layout`` checks. f32 keeps the CUDA-core
kernel (a warp per 4 query rows, lanes splitting hd): on the tensor cores an
f32 product is TF32, about 3 decimal digits, short of the f32 tolerance.

The library is compiled with ``nvcc`` into ``build/kernels/`` at first use
(through ``kernels/build.py``), never at import.
"""
from __future__ import annotations

import contextlib
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
#: every (b, h, s) stride must be a multiple of this many elements (16 bytes
#: of bf16), so that each row the kernel stages starts 16-byte aligned
ALIGN_ELEMS = 8
_LAUNCH = None


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


def _launcher():
    """The kernel's C entry point, looked up once (built at first use)."""
    global _LAUNCH
    if _LAUNCH is None:
        fn = kbuild.load(SOURCE, NVCC_FLAGS).flash_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 9 + [ctypes.c_int] * 2
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LAUNCH = fn
    return _LAUNCH


def _launch_layout(q, k, v, q_offset: int) -> tuple:
    """The nine (b, h, s) element strides of q, k and v that the kernel is
    launched with, or a ValueError/TypeError naming what it cannot take:
    not 4-D, shapes or devices that disagree, q heads not a multiple of kv
    heads, a dtype other than float32/bfloat16 (all three the same), hd not
    contiguous or not in ``HEAD_DIMS``, ``q_offset`` < 0, and — since the
    bf16 path stages rows with 16-byte ``cp.async`` — a row stride that is
    not a multiple of ``ALIGN_ELEMS`` elements or a base pointer that is not
    16-byte aligned. The stride of a size-1 axis is never used, so it is
    passed as 0. Runs on any device: it only reads metadata."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention: q, k, v must be 4-D (B, H, S, hd)")
    B, Hq, Sq, hd = q.shape
    _, Hkv, Skv, _ = kshape = k.shape
    if kshape != (B, Hkv, Skv, hd) or v.shape != kshape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} do not agree")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: {Hq} q heads over {Hkv} kv heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head_dim {hd} not in {HEAD_DIMS}")
    dt = q.dtype
    if dt not in kbuild.DTYPE_CODES or k.dtype != dt or v.dtype != dt:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                        f"{v.dtype}; the kernel takes float32 or bfloat16")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_attention: q, k, v on different devices")
    if q_offset < 0:
        raise ValueError(f"flash_attention: q_offset {q_offset} < 0")
    strides = ()
    for name, x, (n0, n1, n2, _) in (("q", q, q.shape), ("k", k, kshape),
                                     ("v", v, kshape)):
        s0, s1, s2, s3 = x.stride()
        if s3 != 1:
            raise ValueError(f"flash_attention: {name}'s hd is not the "
                             f"contiguous axis (strides {x.stride()})")
        st = (s0 if n0 > 1 else 0, s1 if n1 > 1 else 0, s2 if n2 > 1 else 0)
        if (st[0] | st[1] | st[2]) % ALIGN_ELEMS:
            raise ValueError(f"flash_attention: {name}'s strides {x.stride()} "
                             f"are not multiples of {ALIGN_ELEMS} elements")
        if x.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name}'s data is not 16-byte "
                             f"aligned")
        strides += st
    return strides


def flash_attention_bhsd(q, k, v, *, causal: bool = True,
                         q_offset: int = 0):
    """q (B,Hq,Sq,hd), k/v (B,Hkv,Skv,hd) -> (B,Hq,Sq,hd) in q's dtype.

    The inputs may be strided views (hd contiguous, row starts 16-byte
    aligned: see ``_launch_layout``); the output is contiguous.
    ``q_offset`` is the absolute position of query row 0."""
    global LAUNCHES
    if not q.is_cuda:
        return flash_attention_bhsd_ref(q, k, v, causal=causal,
                                        q_offset=q_offset)
    strides = _launch_layout(q, k, v, q_offset)
    launch = _launcher()
    B, Hq, Sq, hd = q.shape
    o = torch.empty((B, Hq, Sq, hd), dtype=q.dtype, device=q.device)
    # host cost matters on the serve path (28 calls a batch): a device guard
    # only when q is not on the current device, and the current stream as a
    # raw handle (building a torch.cuda.Stream costs ~10 us a call)
    guard = (contextlib.nullcontext()
             if q.device.index == torch.cuda.current_device()
             else torch.cuda.device(q.device))
    with guard:
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    kbuild.DTYPE_CODES[q.dtype], B, Hq, k.shape[1], Sq,
                    k.shape[2], hd, *strides, int(causal), int(q_offset),
                    1.0 / math.sqrt(hd),
                    torch._C._cuda_getCurrentRawStream(q.device.index))
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    LAUNCHES += 1
    return o
