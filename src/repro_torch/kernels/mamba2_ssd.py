"""The Mamba2 SSD scan: the scan behind ``ops.mamba2_ssd``.

Replaces the TPU kernel ``repro.kernels.mamba2_ssd.mamba2_ssd``
(``pl.pallas_call`` of ``_ssd_kernel``) with a CUDA C++ kernel written by
hand for Hopper, ``csrc/mamba2_ssd.cu``, with the same contract: x
(B, nh, S, hd) Δ-scaled inputs, bm/cm (B, S, ns) shared by all heads, loga
(B, nh, S) per-step log decay (<= 0) -> y (B, nh, S, hd) in x's dtype,
from a zero state, with no D term and no state returned; f32 sums on f32
or bf16 x/bm/cm, with loga in f32.

* ``mamba2_ssd`` is the wrapper. On a CUDA tensor it checks dtypes,
  shapes, devices and the launch layout, allocates y with ``torch.empty``,
  launches the kernel on the current stream and counts the launch in
  ``LAUNCHES``; a failed build or launch raises. On a CPU tensor it runs
  the plain version.
* ``mamba2_ssd_ref`` is the plain PyTorch version: the sequential scan of
  the reference's oracle ``kernels/ref.py::mamba2_ssd_ref``.
* ``mamba2_ssd_chunked`` is the plain chunked form that the TPU kernel
  computes (inclusive decay, s <= t mask on the exponent, padded steps
  with loga = 0 and x = 0); the checks on the card hold the kernel against
  it and time it.

The kernel runs the chunked form on the tensor cores: 16-token sub-chunks
on ``mma.sync`` TF32 tiles, every decay factor the exponent of a masked
difference (so in [0, 1] for any loga <= 0), every f32 operand split into
TF32 hi + lo (~2⁻²¹ a term; bf16 x/bm/cm are exact and not split), the
state in f32 accumulators throughout. Its tile is fixed in the source
(``STAGED`` tokens staged, ``SUB`` a sub-chunk): ``chunk`` does not reach
it, so it does not change the result. The source's header says why. Bound
on an H100 at zamba2-2.7b's mixer shape (B=4, nh=80, S=4096, hd=64, ns=64):
0.685 GB in f32, 0.2044 ms at 3.35 TB/s (0.345 GB, 0.1030 ms in bf16),
against 21.5 GFLOP, 0.043 ms at the 495 TFLOP/s of TF32 (``ssd_cost``).

The kernel stages rows with 16-byte ``cp.async``, so every row start of x,
bm and cm must be 16-byte aligned; ``_launch_layout`` checks that and
raises. ``launch_geometry`` gives the launch (grid, warps, shared memory,
blocks an SM).

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
#: tokens the kernel stages at a time, and a sub-chunk of them
STAGED, SUB = 32, 16
#: rows of h a block takes at most (min(hd, 64)); rows are independent,
#: so hd 128 runs two blocks a (b, head)
BLOCK_ROWS = 64
#: SMs of an H100 and the shared memory one SM holds (228 KB, 1 KB of it
#: reserved per block)
SMS, SM_SMEM, BLOCK_RESERVED = 132, 233_472, 1024
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


def smem_bytes(hd: int, ns: int, itemsize: int) -> int:
    """Dynamic shared memory of the kernel (``Geo::BYTES`` in the source)
    for head width hd, state width ns and x/bm/cm of ``itemsize`` bytes:
    two stages of ``STAGED`` tokens (x's rows of the block, padded by 16
    bytes; bm and cm rows padded by 8 elements; loga in f32), then the
    per-token cum, e^cum and e^(tot - cum) in f32, then the staged
    sub-chunks' decayed scores as hi and lo f32 (rows of ``SUB`` padded by
    8), then for f32 x/bm/cm the lo parts of the staged cm (its hi parts
    in place). The wrapper passes it to the launch, which refuses a size
    that is not the kernel's own."""
    dv = min(hd, BLOCK_ROWS)
    ldx, ldb = dv + 16 // itemsize, ns + 8
    stage = STAGED * (ldx + 2 * ldb) * itemsize + 4 * STAGED
    c_lo = STAGED * ldb * 4 if itemsize == 4 else 0
    return 2 * stage + 3 * 4 * STAGED + 2 * STAGED * (SUB + 8) * 4 + c_lo


def launch_geometry(B: int, nh: int, hd: int, ns: int, itemsize: int) -> dict:
    """The kernel's launch for x of (B, nh, ·, hd), state width ns and
    ``itemsize``-byte x/bm/cm: ``grid`` (hd / rows, nh, B), ``warps`` and
    ``threads`` a block (16 rows of h a warp), ``smem`` (``smem_bytes``),
    ``min_blocks_per_sm`` (the source's ``__launch_bounds__``: the
    registers allow at least that many), ``smem_blocks_per_sm`` (what the
    shared memory allows) and ``waves``: the blocks over what 132 SMs hold
    at the smaller of the two. The card's own count comes from
    ``mamba2_ssd_geometry``."""
    dv = min(hd, BLOCK_ROWS)
    warps = dv // 16
    smem = smem_bytes(hd, ns, itemsize)
    min_blocks = (3 if ns <= 64 else 2) * 4 // warps
    smem_blocks = SM_SMEM // (smem + BLOCK_RESERVED)
    grid = (hd // dv, nh, B)
    blocks = grid[0] * grid[1] * grid[2]
    return {"grid": grid, "blocks": blocks, "warps": warps,
            "threads": 32 * warps, "smem": smem,
            "min_blocks_per_sm": min_blocks,
            "smem_blocks_per_sm": smem_blocks,
            "waves": blocks / (SMS * min(min_blocks, smem_blocks))}


def _launch_layout(x, bm, cm, loga) -> tuple:
    """The ten element strides (x: b, h, s; bm, cm: b, s; loga: b, h, s)
    that the kernel is launched with, or a ValueError naming what it
    cannot take: a last axis of x, bm or cm that is not contiguous, or (16-
    byte ``cp.async`` rows) one of their strides that is not a multiple of
    16 bytes or a base pointer that is not 16-byte aligned. loga is read
    4 bytes at a time, at any stride. The stride of a size-1 axis is never
    used, so it is passed as 0. Runs on any device: it only reads
    metadata."""
    strides = ()
    for name, a in (("x", x), ("bm", bm), ("cm", cm)):
        if a.stride(-1) != 1:
            raise ValueError(f"mamba2_ssd: {name}'s last axis is not "
                             f"contiguous (strides {a.stride()})")
        st = tuple(s if n > 1 else 0 for s, n in zip(a.stride()[:-1],
                                                      a.shape[:-1]))
        per16 = 16 // a.element_size()
        if any(s % per16 for s in st):
            raise ValueError(f"mamba2_ssd: {name}'s strides {a.stride()} "
                             f"are not multiples of {per16} elements")
        if a.data_ptr() % 16:
            raise ValueError(f"mamba2_ssd: {name}'s data is not 16-byte "
                             "aligned")
        strides += st
    return strides + tuple(s if n > 1 else 0 for s, n in zip(loga.stride(),
                                                             loga.shape))


def _library():
    global _LIB
    if _LIB is None:
        lib = kbuild.load(SOURCE, NVCC_FLAGS)
        fn = lib.mamba2_ssd_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 10 + [ctypes.c_int]
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        geo = lib.mamba2_ssd_geometry
        geo.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
        geo.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def card_geometry(dtype, hd: int, ns: int) -> dict:
    """The built kernel's launch on the current card, for x/bm/cm of
    ``dtype``: threads and dynamic shared memory a block, the blocks an SM
    holds (the occupancy calculator), registers and local memory a
    thread. Needs the card; builds the library if needed."""
    out = (ctypes.c_int * 5)()
    rc = _library().mamba2_ssd_geometry(kbuild.DTYPE_CODES[dtype], hd, ns,
                                        out)
    if rc != 0:
        raise RuntimeError(f"mamba2_ssd_geometry failed: CUDA error {rc}")
    return dict(zip(("threads", "smem", "blocks_per_sm", "registers",
                     "local_bytes"), out))


def mamba2_ssd(x, bm, cm, loga, *, chunk: int = DEFAULT_CHUNK):
    """x (B,nh,S,hd), bm/cm (B,S,ns), loga (B,nh,S) -> y (B,nh,S,hd) in x's
    dtype (the D residual and the gating are the caller's).

    The inputs may be strided views (the last axis of x, bm and cm
    contiguous, their row starts 16-byte aligned: ``_launch_layout``); y is
    contiguous. ``chunk`` must be positive, as in the reference; the
    kernel's tile is its own (``STAGED``, ``SUB``), so it does not change
    the result."""
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
    strides = _launch_layout(x, bm, cm, loga)
    if chunk <= 0:
        raise ValueError(f"mamba2_ssd: chunk {chunk} <= 0")
    lib = _library()
    y = torch.empty((B, nh, S, hd), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.mamba2_ssd_launch(
            x.data_ptr(), bm.data_ptr(), cm.data_ptr(), loga.data_ptr(),
            y.data_ptr(), kbuild.DTYPE_CODES[x.dtype], B, nh, S, hd, ns,
            *strides, smem_bytes(hd, ns, x.element_size()), stream)
    if rc != 0:
        raise RuntimeError(f"mamba2_ssd kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return y
