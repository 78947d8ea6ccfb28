"""The RWKV-6 (Finch) wkv recurrence: rwkv6-7b's time-mix hot-spot.

Replaces the TPU kernel ``repro.kernels.rwkv6_wkv.rwkv6_wkv``
(``pl.pallas_call`` of ``_wkv_kernel``) with a CUDA C++ kernel written by
hand for Hopper, ``csrc/rwkv6_wkv.cu``, with the same contract: r/k/v/logw
(B, H, S, hd), u (H, hd) -> o (B, H, S, hd) in r's dtype and the final
state S_fin (B, H, hd, hd) in f32, from a zero state; f32 math on f32 or
bf16 r/k/v, with logw and u in f32.

* ``rwkv6_wkv`` is the wrapper. On a CUDA tensor it checks dtypes, shapes,
  devices and the innermost strides, allocates o and S_fin with
  ``torch.empty``, launches the kernel on the current stream and counts the
  launch in ``LAUNCHES``; a failed build or launch raises. On a CPU tensor
  it runs the plain version.
* ``rwkv6_wkv_ref`` is the plain PyTorch version: the sequential
  recurrence of the reference's oracle ``kernels/ref.py::rwkv6_wkv_ref``,
  in f32, with o cast to r's dtype.

The kernel runs the recurrence token by token (the source's header says
why); ``chunk`` is the number of tokens it stages in shared memory at a
time, a speed lever that does not change the result. Bound on an H100 at
the rwkv6-7b train shape (B=4, H=64, S=4096, hd=64, bf16 r/k/v): 0.81 GB,
~0.24 ms at 3.35 TB/s, against 17.2 GFLOP of recurrence, ~0.26 ms at the
67 TFLOP/s of f32 (``wkv_cost``).

The library is compiled with ``nvcc`` into ``build/kernels/`` at first use
(through ``kernels/build.py``), never at import.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build as kbuild

#: kernel launches (the RWKV-6 path's proof that it ran on the kernel)
LAUNCHES = 0

DEFAULT_CHUNK = 64
SOURCE = "rwkv6_wkv.cu"
NVCC_FLAGS = kbuild.FLAGS
#: head widths the kernel is instantiated for
HEAD_DIMS = (32, 64, 128)
_LIB = None


def rwkv6_wkv_ref(r, k, v, logw, u):
    """Sequential wkv6. r/k/v/logw (B,H,S,hd), u (H,hd) -> (o, S_fin)."""
    B, H, S, hd = r.shape
    rf, kf, vf, lw = (a.float() for a in (r, k, v, logw))
    uf = u.float()[None, :, :, None]
    state = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    outs = []
    for t in range(S):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        outs.append(torch.einsum("bhk,bhkv->bhv", rf[:, :, t], state + uf * kv))
        state = state * torch.exp(lw[:, :, t])[..., None] + kv
    o = torch.stack(outs, dim=2) if outs else torch.zeros_like(rf)
    return o.to(r.dtype), state


def wkv_cost(B: int, H: int, S: int, hd: int, *, itemsize: int):
    """(bytes, flops) the function must move and do: r, k, v (``itemsize``
    bytes each) and logw (f32) read once, u read once, o written once in
    r's dtype, S_fin written once in f32; ~4·hd² flops per token and head
    (r·S and the state's decay and k vᵀ update)."""
    n = B * H * S * hd
    nbytes = n * (4 * itemsize + 4) + 4 * H * hd + 4 * B * H * hd * hd
    return nbytes, 4 * hd * hd * B * H * S


def smem_bytes(chunk: int, hd: int) -> int:
    """Dynamic shared memory the kernel takes for a tile of ``chunk``
    tokens: r, k, exp(logw) and v as f32, u and one bonus per token."""
    return 4 * (4 * chunk * hd + hd + chunk)


def _library():
    global _LIB
    if _LIB is None:
        lib = kbuild.load(SOURCE, NVCC_FLAGS)
        fn = lib.rwkv6_wkv_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def rwkv6_wkv(r, k, v, logw, u, *, chunk: int = DEFAULT_CHUNK):
    """r/k/v/logw (B,H,S,hd), u (H,hd) -> (o (B,H,S,hd) in r's dtype,
    S_fin (B,H,hd,hd) f32).

    The inputs may be strided views (only hd must be contiguous); o is
    contiguous. ``chunk`` is clipped to S, as in the reference."""
    global LAUNCHES
    if not r.is_cuda:
        return rwkv6_wkv_ref(r, k, v, logw, u)
    if any(a.dim() != 4 for a in (r, k, v, logw)) or u.dim() != 2:
        raise ValueError("rwkv6_wkv: r, k, v, logw must be 4-D (B, H, S, hd) "
                         "and u 2-D (H, hd)")
    B, H, S, hd = r.shape
    if any(tuple(a.shape) != (B, H, S, hd) for a in (k, v, logw)) or \
            tuple(u.shape) != (H, hd):
        raise ValueError(f"rwkv6_wkv: shapes r {tuple(r.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, logw "
                         f"{tuple(logw.shape)}, u {tuple(u.shape)} disagree")
    if hd not in HEAD_DIMS:
        raise ValueError(f"rwkv6_wkv: head_dim {hd} not in {HEAD_DIMS}")
    if r.dtype not in kbuild.DTYPE_CODES or k.dtype != r.dtype \
            or v.dtype != r.dtype:
        raise TypeError(f"rwkv6_wkv: r/k/v dtypes {r.dtype}, {k.dtype}, "
                        f"{v.dtype}; the kernel takes float32 or bfloat16")
    if logw.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"rwkv6_wkv: logw {logw.dtype} and u {u.dtype} must "
                        "be float32")
    if any(a.device != r.device for a in (k, v, logw, u)):
        raise ValueError("rwkv6_wkv: inputs on different devices")
    if any(a.stride(3) != 1 for a in (r, k, v, logw)) or \
            not u.is_contiguous():
        raise ValueError("rwkv6_wkv: hd must be the contiguous axis and u "
                         "contiguous")
    if chunk <= 0:
        raise ValueError(f"rwkv6_wkv: chunk {chunk} <= 0")
    ch = max(min(int(chunk), S), 1)
    if smem_bytes(ch, hd) > kbuild.MAX_SMEM:
        raise ValueError(f"rwkv6_wkv: chunk {ch} at hd {hd} needs "
                         f"{smem_bytes(ch, hd)} bytes of shared memory, more "
                         f"than a block's {kbuild.MAX_SMEM}")
    lib = _library()
    o = torch.empty((B, H, S, hd), dtype=r.dtype, device=r.device)
    sfin = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.rwkv6_wkv_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), o.data_ptr(), sfin.data_ptr(),
            kbuild.DTYPE_CODES[r.dtype], B, H, S, hd, ch, *r.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *logw.stride()[:3], stream)
    if rc != 0:
        raise RuntimeError(f"rwkv6_wkv kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return o, sfin
