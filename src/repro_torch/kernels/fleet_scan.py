"""Lean tick scan: one observation window of the queueing recurrence for N
clusters, without latency lanes (DESIGN.md §9).

Replaces the reference's lean scan, ``repro.engine.fleet_jax._tick_body``
under ``lax.scan`` (fleet_jax.py:194, scanned at :315 and :1012), with the
state-independent (T, N) terms prepared around it, by a CUDA C++ kernel
written by hand for Hopper, ``csrc/fleet_scan.cu``. It has no Pallas twin:
the reference leaves this path to XLA, and in eager PyTorch a tick would
take ~17 launches. The random draws stay inputs, as for ``fleet_tick``.

* ``fleet_scan`` is the wrapper: ``fleet_tick_window``'s raw operands
  without the lanes, the outputs in its layout (state (2, N), ys (7, T,
  N)). On a CUDA tensor it checks dtype, contiguity and shapes, allocates
  the outputs with ``torch.empty``, launches the kernel on the current
  stream and counts the launch in ``LAUNCHES``; a failed build or launch
  raises. On a CPU tensor it runs the plain version. Under CUDA-graph
  capture the call counts in ``CAPTURED``, and the graph's owner
  (``repro_torch.core.graphs.Program``) adds the launches a graph holds to
  ``LAUNCHES`` at every replay.
* ``tick_scan_ref`` is the plain PyTorch version: the (T, N) prep as
  tensor ops, then a loop over the T ticks in the op order of the
  reference's ``_tick_body`` (``backlog * inv_maxr``, ``batch · (size ·
  TOKENS_PER_MB)``, arrivals clamped before the add, ``processed`` not
  gated by ``active``) — not ``fleet_tick``'s ``_tick_step``, which orders
  them otherwise.

The chain of T dependent ticks of each cluster bounds the kernel, not the
roofline: ``scan_cost`` gives the bytes one launch must move (~60 T N) and
its operations, ``CHAIN_OPS`` the dependent operations of one tick.

The library is compiled with ``nvcc`` into ``build/kernels/`` at first use
(one file with a plain C interface, loaded with ``ctypes`` through
``kernels/build.py``), never at import.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.engine.simcluster import TOKENS_PER_MB
from repro_torch.kernels import build as kbuild
# the module, not its names: importing fleet_tick first imports the core,
# whose captured programs import this module before fleet_tick is complete
from repro_torch.kernels import fleet_tick as _ft

#: kernel launches (the scan path's proof that it ran on the kernel)
LAUNCHES = 0
#: launches recorded into CUDA graphs during their capture (made at replay)
CAPTURED = 0

SOURCE = "fleet_scan.cu"
#: -fmad=false: nvcc contracts no multiply-add the plain version does not
NVCC_FLAGS = (*kbuild.ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: f32 operations of one (tick, cluster): the prep (compares, selects and
#: the slow factor ~9, arrivals 5, retention 1, tokens 1, reciprocal 2) and
#: the chain (~18), plus the carry's two selects
TICK_OPS = 40
#: dependent operations on one tick's chain (backlog -> age, blg, batch,
#: tokens, mem_frac, pen, service, processed with its division, blg_after,
#: the carry's select)
CHAIN_OPS = 17
_LIB = None


def scan_cost(T: int, N: int, fmult: bool = True) -> tuple[int, int]:
    """(bytes, ops) one launch must move and compute: the state in and out,
    the ``CONSTS_USED`` coefficient rows it reads, seven or eight (T, N)
    grids in and the 7 ys rows out, all f32 (~60 T N bytes with
    ``fmult``); ``TICK_OPS`` a (tick, cluster)."""
    grids = 8 if fmult else 7
    words = 2 + _ft.CONSTS_USED + grids * T + 7 * T + 2
    return 4 * N * words, T * N * TICK_OPS


# --------------------------------------------------------------------------
# the plain PyTorch version
# --------------------------------------------------------------------------

def tick_scan_ref(state, consts, rate, size, z, u_strag, u_raw, u_fail,
                  active, fmult=None, *, noise, retention_s, straggler_prob,
                  slo, shi):
    """The plain version of ``fleet_scan`` (same signature and outputs), on
    any device."""
    (T_b, max_b, a_comp, c_coll, b_mem, kvp, ovh, slow_cap, backup,
     fail_frac, inflight) = tuple(consts[i] for i in range(_ft.CONSTS_USED))
    # the state-independent (T, N) terms, outside the tick loop
    smask = u_strag < straggler_prob
    raw = slo + (shi - slo) * u_raw
    slow = torch.where(smask, torch.where(backup != 0, 1.1,
                                          torch.minimum(raw, slow_cap)), 1.0)
    fmask = u_fail < fail_frac
    slow = torch.where(fmask, slow * 2.0, slow)
    if fmult is not None:
        slow = slow * fmult
    arr = torch.clamp(rate * T_b * (1.0 + noise * z), min=0.0)
    ret_ev = rate * retention_s
    sz16 = size * TOKENS_PER_MB
    inv_maxr = 1.0 / torch.clamp(rate, min=1.0)
    act = active != 0
    backlog, sfree = state[0], state[1]
    ys = []
    for t in range(rate.shape[0]):
        backlog_age = backlog * inv_maxr[t]
        blg = torch.minimum(backlog + arr[t], ret_ev[t])     # Kafka retention
        batch = torch.minimum(blg, max_b)
        tokens = batch * sz16[t]
        mem_frac = torch.clamp(tokens * b_mem + kvp, max=1.5)
        pen = 1.0 + 2.0 * torch.clamp(mem_frac - 1.0, min=0.0)  # spill cliff
        service = (ovh + tokens * a_comp * pen + tokens * c_coll) * slow[t]
        start_rel = torch.maximum(T_b, sfree)
        sfree_new = torch.minimum(start_rel + service, T_b + inflight) - T_b
        processed = torch.where(service <= T_b, batch,
                                batch * (T_b / service))
        blg_after = torch.clamp(blg - processed, min=0.0)
        qd = (start_rel - T_b) + backlog_age
        backlog = torch.where(act[t], blg_after, backlog)
        sfree = torch.where(act[t], sfree_new, sfree)
        ys.append(torch.stack([service, qd, batch, processed, blg_after]))
    ys = torch.stack(ys, dim=1)                          # (5, T, N)
    ys = torch.stack([ys[0], ys[1], ys[2], ys[3], smask.to(torch.float32),
                      fmask.to(torch.float32), ys[4]])
    return torch.stack([backlog, sfree]), ys


# --------------------------------------------------------------------------
# the CUDA kernel
# --------------------------------------------------------------------------

def _library():
    global _LIB
    if _LIB is None:
        lib = kbuild.load(SOURCE, NVCC_FLAGS)
        used = lib.fleet_scan_consts_used()
        if used != _ft.CONSTS_USED:
            raise RuntimeError(f"fleet_scan: the kernel reads {used} "
                               f"coefficient rows, pack_tick_consts packs "
                               f"{_ft.CONSTS_USED}")
        fn = lib.fleet_scan_launch
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 2
                       + [ctypes.c_float] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(name, x, shape, device):
    if x.dtype != torch.float32:
        raise TypeError(f"fleet_scan: {name} must be float32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"fleet_scan: {name} has shape {tuple(x.shape)}, "
                         f"expected {shape}")
    if x.device != device:
        raise ValueError(f"fleet_scan: {name} is on {x.device}, not {device}")
    if not x.is_contiguous():
        raise ValueError(f"fleet_scan: {name} must be contiguous")


def fleet_scan(state, consts, rate, size, z, u_strag, u_raw, u_fail, active,
               fmult=None, *, noise, retention_s, straggler_prob, slo, shi):
    """Run one window's lean tick scan.

    state (2, N) [backlog, server_free_rel]; consts (CONSTS_ROWS, N) from
    ``pack_tick_consts``; rate/size/z/u_strag/u_raw/u_fail/active (T, N)
    (``z`` the standard normals of ``norm16``, the u_* 16-bit uniforms,
    ``active`` 1 where the tick evolves the state); ``fmult`` an optional
    (T, N) chaos service multiplier.

    Returns (state' (2, N), ys (7, T, N)): ys rows = service, queue_delay,
    batch, processed, straggler, failure, backlog_after (``processed`` not
    gated by ``active``: the window sum gates it by its mask)."""
    global LAUNCHES, CAPTURED
    kw = dict(noise=noise, retention_s=retention_s,
              straggler_prob=straggler_prob, slo=slo, shi=shi)
    if not state.is_cuda:
        return tick_scan_ref(state, consts, rate, size, z, u_strag, u_raw,
                             u_fail, active, fmult, **kw)
    T, N = rate.shape
    dev = state.device
    _check("state", state, (2, N), dev)
    _check("consts", consts, (_ft.CONSTS_ROWS, N), dev)
    grids = dict(rate=rate, size=size, z=z, u_strag=u_strag, u_raw=u_raw,
                 u_fail=u_fail, active=active, fmult=fmult)
    for name, x in grids.items():
        if x is not None:
            _check(name, x, (T, N), dev)
    lib = _library()
    state_out = torch.empty((2, N), dtype=torch.float32, device=dev)
    ys = torch.empty((7, T, N), dtype=torch.float32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fleet_scan_launch(
            ptr(state), ptr(consts), ptr(rate), ptr(size), ptr(z),
            ptr(u_strag), ptr(u_raw), ptr(u_fail), ptr(active), ptr(fmult),
            ptr(state_out), ptr(ys), N, T, noise, retention_s,
            straggler_prob, slo, shi - slo, stream)
    if rc != 0:
        raise RuntimeError(f"fleet_scan kernel launch failed: CUDA error {rc}")
    if torch.cuda.is_current_stream_capturing():
        CAPTURED += 1
    else:
        LAUNCHES += 1
    return state_out, ys
