"""The Mamba2 SSD scan: the scan behind ``ops.mamba2_ssd``.

Replaces the TPU kernel ``repro.kernels.mamba2_ssd.mamba2_ssd``
(``pl.pallas_call`` of ``_ssd_kernel``) with a CUDA C++ kernel written by
hand for Hopper, ``csrc/mamba2_ssd.cu``, with the same contract: x
(B, nh, S, hd) Δ-scaled inputs, bm/cm (B, S, ns) shared by all heads, loga
(B, nh, S) per-step log decay (<= 0) -> y (B, nh, S, hd) in x's dtype,
from a zero state, with no D term and no state returned; f32 math on f32
or bf16 x/bm/cm, with loga in f32.

* ``mamba2_ssd`` is the wrapper. On a CUDA tensor it checks dtypes,
  shapes, devices and the innermost strides, allocates y with
  ``torch.empty``, launches the kernel on the current stream and counts the
  launch in ``LAUNCHES``; a failed build or launch raises. On a CPU tensor
  it runs the plain version.
* ``mamba2_ssd_ref`` is the plain PyTorch version: the sequential scan of
  the reference's oracle ``kernels/ref.py::mamba2_ssd_ref``.
* ``mamba2_ssd_chunked`` is the plain chunked form that the TPU kernel
  computes (inclusive decay, s <= t mask on the exponent, padded steps
  with loga = 0 and x = 0); the checks on the card hold the kernel against
  it and time it.

The kernel runs the scan token by token (the source's header says why);
``chunk`` is the number of tokens it stages in shared memory at a time, a
speed lever that does not change the result. Bound on an H100 at
zamba2-2.7b's mixer shape (B=4, nh=80, S=4096, hd=64, ns=64, f32): 0.69 GB,
~0.20 ms at 3.35 TB/s, against 21.5 GFLOP, ~0.32 ms at the 67 TFLOP/s of
f32 (``ssd_cost``).

The library is compiled with ``nvcc`` into ``build/kernels/`` at first use
(through ``kernels/build.py``), never at import.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build as kbuild

#: kernel launches (the SSD path's proof that it ran on the kernel)
LAUNCHES = 0

DEFAULT_CHUNK = 128
SOURCE = "mamba2_ssd.cu"
NVCC_FLAGS = kbuild.FLAGS
#: head widths and state widths the kernel is instantiated for
HEAD_DIMS = (32, 64, 128)
STATE_DIMS = (16, 32, 64, 128)
_LIB = None


def mamba2_ssd_ref(x, bm, cm, loga):
    """Sequential SSD recurrence. x (B,nh,S,hd), bm/cm (B,S,ns), loga
    (B,nh,S) -> y (B,nh,S,hd) in x's dtype."""
    B, nh, S, hd = x.shape
    ns = bm.shape[-1]
    xf, bf, cf, la = x.float(), bm.float(), cm.float(), loga.float()
    h = torch.zeros((B, nh, hd, ns), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = h * torch.exp(la[:, :, t])[..., None, None] + \
            torch.einsum("bnh,bs->bnhs", xf[:, :, t], bf[:, t])
        ys.append(torch.einsum("bnhs,bs->bnh", h, cf[:, t]))
    y = torch.stack(ys, dim=2) if ys else torch.zeros_like(xf)
    return y.to(x.dtype)


def mamba2_ssd_chunked(x, bm, cm, loga, *, chunk: int = DEFAULT_CHUNK):
    """The chunked form of the TPU kernel, in plain PyTorch: per chunk the
    inter-chunk term ``(C_t · h_in) e^{cum_t}`` (inclusive decay), the
    intra-chunk ``((C Bᵀ) ⊙ e^{cum_t − cum_s}) x`` for s <= t (the exponent
    masked before ``exp``) and the state update. Same contract as
    ``mamba2_ssd``."""
    B, nh, S, hd = x.shape
    ch = min(chunk, S)
    nch = -(-S // ch)
    pad = nch * ch - S
    # padded steps: decay 1 (loga = 0) and no input (x = 0)
    xf = F.pad(x.float(), (0, 0, 0, pad))
    bf = F.pad(bm.float(), (0, 0, 0, pad))
    cf = F.pad(cm.float(), (0, 0, 0, pad))
    la = F.pad(loga.float(), (0, pad))
    tri = torch.ones((ch, ch), dtype=torch.bool, device=x.device).tril()
    h = torch.zeros((B, nh, hd, bm.shape[-1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for c in range(nch):
        sl = slice(c * ch, (c + 1) * ch)
        xc, bc, cc = xf[:, :, sl], bf[:, sl], cf[:, sl]
        cum = la[:, :, sl].cumsum(-1)                       # (B,nh,C)
        y_inter = torch.einsum("bcs,bnhs->bnch", cc, h) * cum.exp()[..., None]
        scores = torch.einsum("bcs,bds->bcd", cc, bc)       # (B,C,C)
        lmat = (cum[..., :, None] - cum[..., None, :]).masked_fill(
            ~tri, float("-inf")).exp()                      # (B,nh,C,C)
        y_intra = (scores[:, None] * lmat) @ xc
        tot = cum[..., -1:]                                 # (B,nh,1)
        upd = torch.einsum("bnch,bcs->bnhs",
                           xc * (tot - cum).exp()[..., None], bc)
        h = h * tot.exp()[..., None] + upd
        ys.append(y_inter + y_intra)
    return torch.cat(ys, dim=2)[:, :, :S].to(x.dtype)


def ssd_cost(B: int, nh: int, S: int, hd: int, ns: int, *, itemsize: int):
    """(bytes, flops) the function must move and do: x, bm, cm
    (``itemsize`` bytes each) and loga (f32) read once, y written once in
    x's dtype; ~4·hd·ns flops per token and head (the state's decay and
    x Bᵀ update, and C·h)."""
    nbytes = (B * nh * S * (2 * hd * itemsize + 4)
              + 2 * B * S * ns * itemsize)
    return nbytes, 4 * hd * ns * B * nh * S


def smem_bytes(chunk: int, hd: int, ns: int) -> int:
    """Dynamic shared memory the kernel takes for a tile of ``chunk``
    tokens: x, B and C as f32 and one decay per token."""
    return 4 * (chunk * (2 * ns + hd) + chunk)


def _library():
    global _LIB
    if _LIB is None:
        lib = kbuild.load(SOURCE, NVCC_FLAGS)
        fn = lib.mamba2_ssd_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                       + [ctypes.c_longlong] * 10 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def mamba2_ssd(x, bm, cm, loga, *, chunk: int = DEFAULT_CHUNK):
    """x (B,nh,S,hd), bm/cm (B,S,ns), loga (B,nh,S) -> y (B,nh,S,hd) in x's
    dtype (the D residual and the gating are the caller's).

    The inputs may be strided (only the last axis of x, bm and cm must be
    contiguous); y is contiguous. ``chunk`` is clipped to S, as in the
    reference."""
    global LAUNCHES
    if not x.is_cuda:
        return mamba2_ssd_ref(x, bm, cm, loga)
    if x.dim() != 4 or bm.dim() != 3 or cm.dim() != 3 or loga.dim() != 3:
        raise ValueError("mamba2_ssd: x must be (B, nh, S, hd), bm/cm "
                         "(B, S, ns) and loga (B, nh, S)")
    B, nh, S, hd = x.shape
    ns = bm.shape[-1]
    if tuple(bm.shape) != (B, S, ns) or tuple(cm.shape) != (B, S, ns) or \
            tuple(loga.shape) != (B, nh, S):
        raise ValueError(f"mamba2_ssd: shapes x {tuple(x.shape)}, bm "
                         f"{tuple(bm.shape)}, cm {tuple(cm.shape)}, loga "
                         f"{tuple(loga.shape)} disagree")
    if hd not in HEAD_DIMS or ns not in STATE_DIMS:
        raise ValueError(f"mamba2_ssd: head_dim {hd} / state {ns} not in "
                         f"{HEAD_DIMS} / {STATE_DIMS}")
    if x.dtype not in kbuild.DTYPE_CODES or bm.dtype != x.dtype \
            or cm.dtype != x.dtype:
        raise TypeError(f"mamba2_ssd: x/bm/cm dtypes {x.dtype}, {bm.dtype}, "
                        f"{cm.dtype}; the kernel takes float32 or bfloat16")
    if loga.dtype != torch.float32:
        raise TypeError(f"mamba2_ssd: loga {loga.dtype} must be float32")
    if any(a.device != x.device for a in (bm, cm, loga)):
        raise ValueError("mamba2_ssd: inputs on different devices")
    if x.stride(3) != 1 or bm.stride(2) != 1 or cm.stride(2) != 1:
        raise ValueError("mamba2_ssd: the last axis of x, bm and cm must be "
                         "contiguous")
    if chunk <= 0:
        raise ValueError(f"mamba2_ssd: chunk {chunk} <= 0")
    ch = max(min(int(chunk), S), 1)
    if smem_bytes(ch, hd, ns) > kbuild.MAX_SMEM:
        raise ValueError(f"mamba2_ssd: chunk {ch} at hd {hd}, ns {ns} needs "
                         f"{smem_bytes(ch, hd, ns)} bytes of shared memory, "
                         f"more than a block's {kbuild.MAX_SMEM}")
    lib = _library()
    y = torch.empty((B, nh, S, hd), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mamba2_ssd_launch(
            x.data_ptr(), bm.data_ptr(), cm.data_ptr(), loga.data_ptr(),
            y.data_ptr(), kbuild.DTYPE_CODES[x.dtype], B, nh, S, hd, ns,
            ch,
            *x.stride()[:3], bm.stride(0), bm.stride(1), cm.stride(0),
            cm.stride(1), *loga.stride(), stream)
    if rc != 0:
        raise RuntimeError(f"mamba2_ssd kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return y
