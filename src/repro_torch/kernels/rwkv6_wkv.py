"""The RWKV-6 (Finch) wkv recurrence: rwkv6-7b's time-mix hot-spot.

Replaces the TPU kernel ``repro.kernels.rwkv6_wkv.rwkv6_wkv``
(``pl.pallas_call`` of ``_wkv_kernel``) with a CUDA C++ kernel written by
hand for Hopper, ``csrc/rwkv6_wkv.cu``, with the same contract: r/k/v/logw
(B, H, S, hd), u (H, hd) -> o (B, H, S, hd) in r's dtype and the final
state S_fin (B, H, hd, hd) in f32, from a zero state; f32 accumulation on
f32 or bf16 r/k/v, with logw and u in f32.

* ``rwkv6_wkv`` is the wrapper. On a CUDA tensor it checks dtypes, shapes,
  devices and the launch layout, allocates o and S_fin with
  ``torch.empty``, launches the kernel on the current stream and counts the
  launch in ``LAUNCHES``; a failed build or launch raises. On a CPU tensor
  it runs the plain version.
* ``rwkv6_wkv_ref`` is the plain PyTorch version: the sequential
  recurrence of the reference's oracle ``kernels/ref.py::rwkv6_wkv_ref``,
  in f32, with o cast to r's dtype.

bf16 r/k/v run on the tensor cores: the chunked form of the Pallas body
(inter-chunk ``(r ⊙ decay)·S``, intra-chunk scores, state update
``diag(decay) S + (k ⊙ decay)ᵀ v``) on ``mma.sync`` tiles of 16-token
sub-chunks, every decay factor a running product of ``exp(logw)`` inside
one sub-chunk (so in [0, 1] for any logw ≤ 0), every f32 operand split into
bf16 hi + lo so that the products keep ~2⁻¹⁶ of each term, the state in f32
accumulators throughout. Its tile is fixed in the source (32 tokens staged,
16 a sub-chunk): ``chunk`` does not reach it. f32 r/k/v keep the
token-by-token kernel on the CUDA cores, whose staging tile is ``chunk``
tokens, a speed lever that does not change the result. The source's header
says why each design is what it is. Bound on an H100 at the rwkv6-7b train
shape (B=4, H=64, S=4096, hd=64, bf16 r/k/v): 0.81 GB, ~0.24 ms at 3.35
TB/s, against 17.2 GFLOP of recurrence, ~0.017 ms at the 989 TFLOP/s of
the bf16 tensor cores (~0.26 ms at the 67 TFLOP/s of f32: ``wkv_cost``).

The bf16 kernel stages rows with 16-byte ``cp.async``, so every row start
must be 16-byte aligned; ``_launch_layout`` checks that and raises.

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
#: value columns a block of the bf16 kernel takes at most (min(hd, 64));
#: value columns are independent, so hd 128 runs two blocks a (b, head)
MMA_VALUE_COLUMNS = 64
#: tokens the bf16 kernel stages at a time, and a sub-chunk of them
MMA_CHUNK, MMA_SUB = 32, 16
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
    """Dynamic shared memory the f32 kernel takes for a tile of ``chunk``
    tokens: r, k, exp(logw) and v as f32, u and one bonus per token."""
    return 4 * (4 * chunk * hd + hd + chunk)


def mma_smem_bytes(hd: int, dv: int) -> int:
    """Dynamic shared memory of the bf16 kernel (``Geo::BYTES`` in the
    source) for hd key channels and dv value columns a block: raw r, k
    (bf16) and logw (f32, then w = exp(logw) in place) of one staged
    chunk, v in two buffers, the decayed r and k as hi/lo bf16, the state
    as hi/lo bf16 in two buffers, the diagonal scores as hi/lo bf16, the
    sub-chunk decays and u; the bf16 rows that ldmatrix reads padded by
    8. The wrapper passes it to the launch, which refuses a size that is not
    the kernel's own."""
    C, ldx, ldv = MMA_CHUNK, hd + 8, dv + 8
    return (C * hd * 2 * 2 + C * hd * 4 + 2 * C * ldv * 2
            + 4 * C * ldx * 2 + 4 * hd * ldv * 2 + 2 * C * 24 * 2
            + (C // MMA_SUB) * hd * 4 + hd * 4)


def _launch_layout(r, k, v, logw) -> tuple:
    """The twelve (b, h, s) element strides of r, k, v and logw that the
    kernel is launched with, or a ValueError naming what it cannot take:
    hd not contiguous and, for bf16 r/k/v (16-byte ``cp.async`` rows), a
    stride that is not a multiple of 16 bytes or a base pointer that is not
    16-byte aligned. The stride of a size-1 axis is never used, so it is
    passed as 0. Runs on any device: it only reads metadata."""
    aligned = r.dtype == torch.bfloat16
    strides = ()
    for name, x in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        if x.stride(3) != 1:
            raise ValueError(f"rwkv6_wkv: {name}'s hd is not the contiguous "
                             f"axis (strides {x.stride()})")
        st = tuple(s if n > 1 else 0 for s, n in zip(x.stride()[:3],
                                                      x.shape[:3]))
        if aligned:
            per16 = 16 // x.element_size()
            if (st[0] | st[1] | st[2]) % per16:
                raise ValueError(f"rwkv6_wkv: {name}'s strides {x.stride()}"
                                 f" are not multiples of {per16} elements")
            if x.data_ptr() % 16:
                raise ValueError(f"rwkv6_wkv: {name}'s data is not 16-byte "
                                 "aligned")
        strides += st
    return strides


def _library():
    global _LIB
    if _LIB is None:
        lib = kbuild.load(SOURCE, NVCC_FLAGS)
        fn = lib.rwkv6_wkv_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 12 + [ctypes.c_int]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def rwkv6_wkv(r, k, v, logw, u, *, chunk: int = DEFAULT_CHUNK):
    """r/k/v/logw (B,H,S,hd), u (H,hd) -> (o (B,H,S,hd) in r's dtype,
    S_fin (B,H,hd,hd) f32).

    The inputs may be strided views (hd contiguous; for bf16 every row
    start 16-byte aligned, see ``_launch_layout``); o is contiguous.
    ``chunk`` is the f32 kernel's staging tile, clipped to S as in the
    reference; the bf16 kernel's tile is its own (``MMA_CHUNK``)."""
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
    if not u.is_contiguous():
        raise ValueError("rwkv6_wkv: u must be contiguous")
    strides = _launch_layout(r, k, v, logw)
    if chunk <= 0:
        raise ValueError(f"rwkv6_wkv: chunk {chunk} <= 0")
    ch = max(min(int(chunk), S), 1)
    smem = smem_bytes(ch, hd) if r.dtype == torch.float32 else \
        mma_smem_bytes(hd, min(hd, MMA_VALUE_COLUMNS))
    if smem > kbuild.MAX_SMEM:
        raise ValueError(f"rwkv6_wkv: chunk {ch} at hd {hd} needs {smem} "
                         f"bytes of shared memory, more than a block's "
                         f"{kbuild.MAX_SMEM}")
    lib = _library()
    o = torch.empty((B, H, S, hd), dtype=r.dtype, device=r.device)
    sfin = torch.empty((B, H, hd, hd), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.rwkv6_wkv_launch(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
            u.data_ptr(), o.data_ptr(), sfin.data_ptr(),
            kbuild.DTYPE_CODES[r.dtype], B, H, S, hd, ch, *strides, smem,
            stream)
    if rc != 0:
        raise RuntimeError(f"rwkv6_wkv kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return o, sfin
