"""The Lasso path's coordinate descent: the loop behind ``core.lasso``.

Replaces the reference's jitted ``repro.core.lasso._cd_epoch`` (one XLA
program per epoch, driven from a host loop over lambdas and epochs) with a
CUDA C++ kernel written by hand for Hopper, ``csrc/lasso_cd.cu``: one launch
runs a whole warm-started path, every lambda of the grid and up to
``epochs`` cycles of sequential coordinate updates at each, on the
normal-equations form (A = X'X, b = X'y, both f32). It is not a Pallas
kernel; in eager PyTorch the path would take ~12 launches a coordinate
update, ~9.4 M for the tuner's path.

* ``lasso_cd`` is the wrapper. On a CUDA tensor it checks dtypes, shapes,
  devices and contiguity, allocates the (n_lam, p) coefficients with
  ``torch.empty``, launches the kernel on the current stream and counts the
  launch in ``LAUNCHES``; a failed build or launch raises. On a CPU tensor
  it runs the plain version.
* ``lasso_cd_ref`` is the plain version: the sequential loop of the
  reference's ``_cd_epoch``, coordinate by coordinate, each update's dot
  taken afresh, with the update's scalar arithmetic in f32 in the
  reference's order.
* ``lasso_cd_mirror`` runs the kernel's own order in numpy f32: the
  gradient c = b - A w formed afresh at each lambda's start and changed by
  a row of A only when a coordinate moves. The kernel is bitwise equal to it (the
  tests and chip_smoke.py hold it so); it also counts the epochs run and
  the updates that moved. The main path never calls it.

What bounds the kernel is its dependency chain, not the roofline: every
update reads the w the previous one wrote. ``cd_cost`` gives the roofline
of one run from its counts (A and the inputs read once, the coefficients
written once, the operations of the updates and moves it made);
``chain_updates`` the longest chain the path can take. The source's header
says how the design shortens an update.

The library is compiled with ``nvcc`` into ``build/kernels/`` at first use
(through ``kernels/build.py``), never at import.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import build as kbuild

#: kernel launches (the tuner path's proof that it ran on the kernel)
LAUNCHES = 0

SOURCE = "lasso_cd.cu"
#: -fmad=false: the update's arithmetic and the carry are the mirror's f32
#: operations in its order (no contracted multiply-add)
NVCC_FLAGS = (*kbuild.ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LIB = None
#: ``lasso_cd_launch``'s arguments: xtx, xty, w0, lams, coefs, p, n_lam,
#: epochs, n, a_in_smem, smem, stream
ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float]
            + [ctypes.c_int] * 2 + [ctypes.c_void_p])
#: coordinates a lane holds in registers: 8 chunks of 32 (p <= 256)
MAX_REG_CHUNKS = 8
#: f32 operations of one coordinate update (r, the threshold, the
#: division, the move delta)
UPDATE_FLOPS = 7


def smem_bytes(p: int, a_in_smem: bool) -> int:
    """Dynamic shared memory of a launch (``lasso_cd_smem`` in the source):
    c, w and diag(A) at 32 ceil(p / 32) floats each (used past
    ``MAX_REG_CHUNKS`` chunks, reserved at every p), and A itself when it
    sits in shared memory."""
    return 4 * (3 * 32 * (-(-p // 32)) + (p * p if a_in_smem else 0))


def a_in_smem(p: int) -> bool:
    """Whether A fits in shared memory beside c, w and diag(A) (p <= 239
    in the 227 KB a block may take); past that the kernel reads its rows
    from global memory."""
    return smem_bytes(p, True) <= kbuild.MAX_SMEM


def cd_cost(p: int, n_lam: int, updates: int, moves: int,
            terms: int = 0) -> tuple[int, int]:
    """(bytes, flops) a path from w0 = 0 must move and do, from the counts
    of its run (``lasso_cd_mirror``): A, b, w0 and the lambdas read once,
    the (n_lam, p) coefficients written once, all f32; ``UPDATE_FLOPS`` an
    update, 2 p a move (c -= delta A[j]), 2 p a term of the lambdas'
    refreshes of c (a nonzero w_m at a lambda's start) and one n lam
    product a lambda."""
    nbytes = 4 * (p * p + 2 * p + n_lam + n_lam * p)
    flops = UPDATE_FLOPS * updates + 2 * p * (moves + terms) + n_lam
    return nbytes, flops


def chain_updates(p: int, n_lam: int, epochs: int) -> int:
    """Coordinate updates on the path's chain when no epoch is skipped."""
    return p * n_lam * epochs


def lasso_cd_ref(xtx, xty, w0, lams, n: float, *, epochs: int):
    """The sequential coordinate descent of the reference's ``_cd_epoch``,
    warm-started along ``lams``: the (n_lam, p) f32 coefficients after
    each lambda, on the inputs' device.

    The loop runs on the host over a CPU copy: the dot of each update is
    ``torch.dot`` on a row of A, the rest is f32 scalar arithmetic in the
    reference's order. A cycle that leaves w bitwise unchanged would repeat
    itself, so the remaining cycles at that lambda are skipped: the result
    is the same as running them."""
    A = xtx.detach().to("cpu", torch.float32).contiguous()
    p = A.shape[0]
    rows = A.unbind(0)
    b = xty.detach().to("cpu", torch.float32).numpy()
    d = A.diagonal().numpy().copy()
    den = np.maximum(d, np.float32(1e-12))
    w = w0.detach().to("cpu", torch.float32).clone()
    wn = w.numpy()                      # shares w's memory
    lam_np = lams.detach().to("cpu", torch.float32).numpy()
    nf = np.float32(n)
    out = np.empty((len(lam_np), p), np.float32)
    zero = np.float32(0.0)
    for li, lam in enumerate(lam_np):
        nl = nf * lam
        for _ in range(epochs):
            before = wn.copy()
            for j in range(p):
                dot = np.float32(float(torch.dot(rows[j], w)))
                r = (b[j] - dot) + d[j] * wn[j]
                wn[j] = np.sign(r) * max(abs(r) - nl, zero) / den[j]
            if np.array_equal(wn, before):
                break
        out[li] = wn
    return torch.from_numpy(out).to(xtx.device)


def lasso_cd_mirror(xtx, xty, w0, lams, n: float, *, epochs: int,
                    carry: bool = True):
    """The kernel's order of operations in numpy f32, on the host: the
    (n_lam, p) coefficients after each lambda on the inputs' device, and
    the run's counts ``{"epochs", "updates", "moves", "rounds", "terms"}``
    (epochs run, coordinate updates, updates that moved w, the kernel's
    rounds: one a move, and one more a chunk of 32 coordinates whose last
    one does not move; and the nonzero w_m summed into the refreshes of c).

    At each lambda's start c = b - A w is summed a row of A at a time (A is
    symmetric), the nonzero w_m in order (so w0 = 0 gives c = b exactly);
    an update reads r_j = c_j + A_jj w_j and, when it moves w_j by delta !=
    0, takes c -= delta A[j] (row j, a product then a difference); an epoch
    that moves nothing ends the lambda. Every step is elementwise f32, as
    in the kernel, so the two agree to the bit. ``carry=False`` leaves c as
    the first lambda's start formed it (the row update and the later
    refreshes cut out, as ``tools/lasso_probe.py``'s no-carry variant
    does)."""
    host = lambda t: np.array(t.detach().to("cpu", torch.float32).numpy()
                              if torch.is_tensor(t) else t, np.float32)
    A, b, w, lam_np = host(xtx), host(xty), host(w0), host(lams)
    p = A.shape[0]
    d = A.diagonal().copy()
    den = np.maximum(d, np.float32(1e-12))
    nf = np.float32(n)
    zero = np.float32(0.0)
    out = np.empty((len(lam_np), p), np.float32)
    runs = moves = rounds = terms = 0
    for li, lam in enumerate(lam_np):
        nl = nf * lam
        if carry or li == 0:
            s = np.zeros(p, np.float32)
            for m in np.flatnonzero(w):
                s += A[m] * w[m]
                terms += 1
            c = b - s
        for _ in range(epochs):
            runs += 1
            moved = False
            for j in range(p):
                wq = w[j]
                r = c[j] + d[j] * wq
                wj = np.sign(r) * max(abs(r) - nl, zero) / den[j]
                w[j] = wj
                delta = wj - wq
                if delta != 0:
                    moved = True
                    moves += 1
                    if carry:
                        c -= delta * A[j]
                elif j % 32 == 31 or j == p - 1:
                    rounds += 1
            if not moved:
                break
        out[li] = w
    dev = xtx.device if torch.is_tensor(xtx) else "cpu"
    counts = {"epochs": runs, "updates": runs * p, "moves": moves,
              "rounds": rounds + moves, "terms": terms}
    return torch.from_numpy(out).to(dev), counts


def _library():
    global _LIB
    if _LIB is None:
        lib = kbuild.load(SOURCE, NVCC_FLAGS)
        fn = lib.lasso_cd_launch
        fn.argtypes = ARGTYPES
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def lasso_cd(xtx, xty, w0, lams, n: float, *, epochs: int):
    """Coordinate descent along ``lams`` from ``w0``: xtx (p, p), xty (p,),
    w0 (p,) and lams (n_lam,), all f32 on one device, ``n`` the number of
    rows of X -> the (n_lam, p) f32 coefficients after each lambda. On a
    CUDA tensor one kernel launch runs the whole path; on a CPU tensor the
    plain version does."""
    global LAUNCHES
    if not xtx.is_cuda:
        return lasso_cd_ref(xtx, xty, w0, lams, n, epochs=epochs)
    if xtx.dim() != 2 or xtx.shape[0] != xtx.shape[1]:
        raise ValueError(f"lasso_cd: xtx {tuple(xtx.shape)} is not (p, p)")
    p = xtx.shape[0]
    if tuple(xty.shape) != (p,) or tuple(w0.shape) != (p,) or lams.dim() != 1:
        raise ValueError(f"lasso_cd: xty {tuple(xty.shape)}, w0 "
                         f"{tuple(w0.shape)}, lams {tuple(lams.shape)} do "
                         f"not fit p = {p}")
    ts = (xtx, xty, w0, lams)
    if any(t.dtype != torch.float32 for t in ts):
        raise TypeError("lasso_cd: every input must be float32")
    if any(t.device != xtx.device for t in ts):
        raise ValueError("lasso_cd: inputs on different devices")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("lasso_cd: inputs must be contiguous")
    if epochs < 0 or p == 0:
        raise ValueError(f"lasso_cd: epochs {epochs}, p {p}")
    in_smem = a_in_smem(p)
    smem = smem_bytes(p, in_smem)
    if smem > kbuild.MAX_SMEM:
        raise ValueError(f"lasso_cd: p = {p} needs {smem} B of shared "
                         f"memory for c, w and diag(A)")
    lib = _library()
    n_lam = lams.shape[0]
    coefs = torch.empty((n_lam, p), dtype=torch.float32, device=xtx.device)
    with torch.cuda.device(xtx.device):
        stream = torch.cuda.current_stream(xtx.device).cuda_stream
        rc = lib.lasso_cd_launch(
            xtx.data_ptr(), xty.data_ptr(), w0.data_ptr(), lams.data_ptr(),
            coefs.data_ptr(), p, n_lam, int(epochs), float(n), int(in_smem),
            smem, stream)
    if rc != 0:
        raise RuntimeError(f"lasso_cd kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return coefs
