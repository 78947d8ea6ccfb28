"""Fused fleet-tick window: one observation window of the queueing recurrence
plus its latency-lane statistics, for N clusters at once (DESIGN.md §9, §14).

Replaces the TPU kernel ``repro.kernels.fleet_tick.fleet_tick_window``
(``pl.pallas_call`` of ``_tick_window_kernel``) with a CUDA C++ kernel
written by hand for Hopper, ``csrc/fleet_tick.cu``: the same contract —
same inputs, same outputs, same layouts — with the random draws kept as
inputs.

* ``fleet_tick_window`` is the wrapper. On a CUDA tensor it checks dtype,
  contiguity and shapes, allocates the outputs with ``torch.empty``, launches
  the kernel on the current stream and counts the launch in ``LAUNCHES``; a
  failed build or launch raises. On a CPU tensor it runs the plain version.
* ``fleet_tick_window_ref`` is the plain PyTorch version: the tick loop in
  torch ops, the lanes sorted with ``torch.sort`` (exact, so the order
  statistics equal the kernel's bitonic network value for value) and the
  lane sum in the reference's adjacent-pair order.

Bound on an H100 at the main path's shape (N=1024, T=48, S=32, K=32): one
launch moves ~16.9 MB (``window_cost``), ~5 us at 3.35 TB/s; its ~1k ops per
(tick, cluster) are ~0.8 us at 67 TFLOP/s f32, so memory bounds it. The
kernel puts a cluster's S lanes across the lanes of a warp (several
clusters a warp when S < 32): shuffle-tree lane sum, shuffle bitonic sort,
the head merged in registers (by rank, in shared or global memory, once
K + S passes 32 values a lane, as windows of ~3300 ticks make it), a block per tile of
8 adjacent clusters whose (T, N) and (T, S, N) rows are staged through
shared memory a few ticks ahead (the source's header has the details).
``launch_geometry`` computes the launch from (N, T, S, K) and refuses what
the kernel is not built for.

The library is compiled with ``nvcc`` into ``build/kernels/`` at first use
(one file with a plain C interface, loaded with ``ctypes`` through
``kernels/build.py``), never at import.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.engine.simcluster import PEAK_FLOPS, TOKENS_PER_MB
from repro_torch.kernels import build as kbuild

#: coefficient rows the kernel reads: the order of ``pack_tick_consts`` and
#: of the kernel's ``C_*`` enum, whose ``C_USED`` must equal it (checked when
#: the library loads)
CONSTS_USED = 11
#: rows of the (CONSTS_ROWS, N) coefficient array: the used rows padded like
#: the reference's sublane multiple
CONSTS_ROWS = 16

#: kernel launches (the main path's proof that it ran on the kernel)
LAUNCHES = 0

SOURCE = "fleet_tick.cu"
#: clusters a block takes (a tile: one 32-byte sector of every row), ticks
#: staged at once, and the (T, N) grids staged each tick
TILE_CLUSTERS, STAGES, GRIDS = 8, 4, 9
#: lanes per tick the kernel is built for (``window_lanes`` on CUDA gives
#: 8 to 64), and the most head ++ lanes values one warp lane holds in
#: registers (past it the head lives in memory, merged by rank)
LANE_COUNTS = (8, 16, 32, 64)
MAX_VALUES_PER_LANE = 32
#: -fmad=false: nvcc contracts no multiply-add the plain version does not
NVCC_FLAGS = (*kbuild.ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LIB = None


def head_budget(S: int, p99_k: int) -> int:
    """Streaming top-K head length for S lanes/tick and a ``p99_k``-deep
    caller interpolation: the smallest K with K ≥ p99_k and K+S a power of
    two (the per-tick head merge is a single bitonic merge of length K+S)."""
    P = 1
    while P < S + p99_k:
        P *= 2
    return P - S


def pack_tick_consts(cc: dict, mc: dict, spec, chips: int):
    """Fold the packed lever tensors + model constants into the per-cluster
    coefficient rows the kernel consumes. Same algebra as
    ``service_terms_arrays``, factored by what varies per tick:

        tokens   = batch · size · TOKENS_PER_MB
        service  = ovh + tokens·A·mem_penalty(tokens·B + kvp) + tokens·C
    """
    from repro_torch.utils import txp as xp

    eff = spec.base_mfu * cc["eff_block_q"] * cc["eff_block_k"] * cc["eff_dtype"]
    a0 = mc["flops_per_tok"] * cc["remat"] / (chips * PEAK_FLOPS * eff)
    moe = (mc["is_moe"] != 0) & (cc["expert_parallel"] != 0)
    a_comp = xp.where(moe, a0 * 0.92, a0) * cc["tp_compute"]
    c_coll = (a0 * spec.collective_frac * (cc["tp"] / 16.0) ** 0.5
              * cc["compression"] / (1.0 + 0.45 * (cc["mb"] - 1.0)))
    c_coll = xp.where(moe, c_coll * 1.15, c_coll)
    b_mem = mc["kv_per_tok"] / 1e9 / (chips * spec.hbm_gb_per_chip)
    ovh = spec.dispatch_overhead_s * (1.0 + 0.12 * (cc["mb"] - 1.0))
    ovh = ovh + spec.driver_gc_coeff / xp.maximum(cc["driver_memory_gb"], 1.0) * 0.1
    ovh = ovh + 0.12 * xp.maximum(
        xp.log2(512.0 / xp.maximum(cc["allocator_arena_mb"], 32.0)), 0.0)
    sink = cc["sink_partitions"]
    ovh = ovh + 0.25 / xp.maximum(sink, 1.0) + 0.004 * sink
    ovh = ovh * (0.45 + 0.55 / (1.0 + cc["prefetch_depth"]))
    T_b = cc["T_b"]
    slow_cap = xp.maximum(1.2, 1.0 + cc["straggler_timeout_s"]
                          / xp.maximum(T_b, 1e-3))
    rows = [T_b, cc["max_batch_events"], a_comp, c_coll, b_mem,
            cc["kv_pressure"], ovh, slow_cap,
            (cc["backup_tasks"] != 0).to(a0.dtype),
            cc["failure_inject_frac"],
            xp.maximum(cc["max_inflight_batches"], 1.0) * T_b]
    assert len(rows) == CONSTS_USED
    zeros = xp.zeros_like(T_b)
    rows += [zeros] * (CONSTS_ROWS - len(rows))
    return xp.stack(rows).to(torch.float32)


def launch_geometry(N: int, T: int, S: int, K: int) -> dict:
    """The kernel's launch for N clusters, T ticks, S lanes and a K-entry
    head, or a ValueError for what it is not built for. A cluster takes
    ``lanes`` = min(S, 32) warp lanes (``clusters_per_warp`` of them share a
    warp), each holding ``lane_values`` = S / lanes lane values and
    ``values_per_lane`` = (K + S) / lanes values of the head merge; a block
    takes ``TILE_CLUSTERS`` clusters (``threads`` = 8 · lanes) and stages
    ``STAGES`` ticks of their rows. Up to ``MAX_VALUES_PER_LANE`` the merge
    runs in registers (``head`` "registers"); past it each cluster keeps
    two K-float head buffers and its S sorted lanes, 2 (K + S) floats
    (padded by ``lanes``), in shared memory ("shared") or, when the tile's
    would take more than a block may have, in a global workspace of
    ``workspace_floats`` ("global").
    ``smem_bytes`` is the block's dynamic shared memory. S must be in
    ``LANE_COUNTS`` and K + S a power of two."""
    if S not in LANE_COUNTS:
        raise ValueError(f"fleet_tick: S={S} lanes; the kernel takes "
                         f"{LANE_COUNTS}")
    P = K + S
    if K < 1 or P & (P - 1):
        raise ValueError(f"fleet_tick: K={K}: K + S={P} must be a power of "
                         "two above S")
    if N < 0 or T < 1:
        raise ValueError(f"fleet_tick: N={N}, T={T}")
    lanes = min(S, 32)
    blocks = -(-N // TILE_CLUSTERS)
    smem = STAGES * (GRIDS * TILE_CLUSTERS + 2 * S * (TILE_CLUSTERS + 1)) * 4
    head, ws = "registers", 0
    if P // lanes > MAX_VALUES_PER_LANE:
        heads = TILE_CLUSTERS * (2 * P + lanes) * 4
        if smem + heads <= kbuild.MAX_SMEM:
            head, smem = "shared", smem + heads
        else:
            head, ws = "global", blocks * TILE_CLUSTERS * 2 * P
    return dict(lanes=lanes, clusters_per_warp=32 // lanes,
                lane_values=S // lanes, values_per_lane=P // lanes,
                threads=TILE_CLUSTERS * lanes, blocks=blocks,
                smem_bytes=smem, head=head, workspace_floats=ws)


def window_cost(T: int, S: int, K: int, N: int, fmult: bool = True):
    """(bytes, ops) one window must move and compute: each input read once
    (state 2, the CONSTS_USED coefficient rows the kernel reads — not the
    padding, eight or nine (T, N) grids, two (T, S, N) lane tiles), each
    output written once (state 2, ys 7T, stats 5T, head K), all
    f32; ops count the tick recurrence (~40), the lane formula and sum
    (~6 per lane), the bitonic sort (S·log S·(log S+1)/4 compare-exchanges)
    and merge ((K+S)/2·log(K+S)), two min/max ops per exchange."""
    grids = 9 if fmult else 8
    words = (2 + CONSTS_USED + grids * T + 2 * T * S) + (2 + 12 * T + K)
    lg = S.bit_length() - 1
    lp = (K + S).bit_length() - 1
    ce = S * lg * (lg + 1) // 4 + (K + S) // 2 * lp
    ops = T * N * (40 + 6 * S + 2 * ce + 12)
    return 4 * N * words, ops


# --------------------------------------------------------------------------
# the plain PyTorch version
# --------------------------------------------------------------------------

def _tick_step(backlog, sfree, rate, size, z, u_s, u_r, u_f, active, fm, cv,
               *, noise, retention_s, straggler_prob, slo, shi):
    """One micro-batch tick on (N,) tensors — the reference ``_tick_step``
    op for op. Returns the active-gated carry and the 7 ys channels."""
    (T_b, max_b, a_comp, c_coll, b_mem, kvp, ovh, slow_cap, backup,
     fail_frac, inflight) = cv
    arrivals = rate * T_b * (1.0 + noise * z)
    age = backlog / torch.clamp(rate, min=1.0)
    blg = backlog + torch.clamp(arrivals, min=0.0)
    blg = torch.minimum(blg, rate * retention_s)          # Kafka retention
    batch = torch.minimum(blg, max_b)
    tokens = batch * size * TOKENS_PER_MB
    mem_frac = torch.clamp(tokens * b_mem + kvp, max=1.5)
    pen = 1.0 + 2.0 * torch.clamp(mem_frac - 1.0, min=0.0)  # spill cliff
    service = ovh + tokens * a_comp * pen + tokens * c_coll
    smask = u_s < straggler_prob
    raw = slo + (shi - slo) * u_r
    slow = torch.where(smask, torch.where(backup != 0, 1.1,
                                          torch.minimum(raw, slow_cap)), 1.0)
    fmask = u_f < fail_frac
    slow = torch.where(fmask, slow * 2.0, slow)
    slow = slow * fm
    service = service * slow
    start_rel = torch.maximum(T_b, sfree)
    sfree_new = torch.minimum(start_rel + service, T_b + inflight) - T_b
    processed = torch.where(service <= T_b, batch, batch * (T_b / service))
    blg_after = torch.clamp(blg - processed, min=0.0)
    qd = (start_rel - T_b) + age
    act = active != 0
    carry = (torch.where(act, blg_after, backlog),
             torch.where(act, sfree_new, sfree))
    ys = (service, qd, batch, torch.where(act, processed, 0.0),
          smask.to(torch.float32), fmask.to(torch.float32), blg_after)
    return carry, ys


def _sum0(x):
    """Pairwise sum along dim 0 (power-of-two length) in the reference
    ``_sum0``'s adjacent-pair order, so the lane sum rounds the same way."""
    assert x.shape[0] & (x.shape[0] - 1) == 0, x.shape
    while x.shape[0] > 1:
        x = x[0::2] + x[1::2]
    return x[0]


def _lane_stats(uw, z2, T_b, qd, service, batch, wm, S):
    """Latency lanes of a whole window, (S, T, N): ``stats5`` = (lane_sum,
    p50, p95, p99, max) per tick and the ascending sorted lanes, with invalid
    lanes (lane ≥ n_s, or a tick outside the window) sorted to the front as
    -inf, so the ascending rank r of a valid lane sits at S - n_s + r."""
    lat = uw * T_b + qd + service * (1.0 + 0.1 * z2)
    n_s = torch.clamp(batch.to(torch.int32), 1, S)
    lane = torch.arange(S, device=uw.device)[:, None, None]
    valid = (lane < n_s) & (wm > 0.0)
    lane_sum = _sum0(torch.where(valid, lat, 0.0))
    srt = torch.sort(torch.where(valid, lat, float("-inf")), dim=0).values
    base = S - n_s

    def q_at(q):
        pos = (n_s - 1).to(torch.float32) * (q / 100.0)
        lo = torch.floor(pos).to(torch.int64)
        hi = torch.ceil(pos).to(torch.int64)
        a = torch.gather(srt, 0, (base + lo)[None])[0]
        b = torch.gather(srt, 0, (base + hi)[None])[0]
        return a + (pos - lo.to(torch.float32)) * (b - a)

    return (lane_sum, q_at(50.0), q_at(95.0), q_at(99.0), srt[-1]), srt


def fleet_tick_window_ref(state, consts, rate, size, z, u_strag, u_raw,
                          u_fail, active, u_wait, z2a, fmult=None, wmask=None,
                          *, noise, retention_s, straggler_prob, slo, shi,
                          p99_k=2):
    """The plain version of ``fleet_tick_window`` (same signature and
    outputs), on any device."""
    T, S, N = u_wait.shape
    K = head_budget(S, p99_k)
    if fmult is None:
        fmult = torch.ones_like(rate)
    if wmask is None:
        wmask = active
    cv = tuple(consts[i] for i in range(CONSTS_USED))
    backlog, sfree = state[0], state[1]
    ys = []
    for t in range(T):
        (backlog, sfree), y = _tick_step(
            backlog, sfree, rate[t], size[t], z[t], u_strag[t], u_raw[t],
            u_fail[t], active[t], fmult[t], cv, noise=noise,
            retention_s=retention_s, straggler_prob=straggler_prob, slo=slo,
            shi=shi)
        ys.append(torch.stack(y))
    ys = torch.stack(ys, dim=1)                          # (7, T, N)
    stats5, srt = _lane_stats(u_wait.transpose(0, 1), z2a.transpose(0, 1),
                              cv[0], ys[1], ys[0], ys[2], wmask, S)
    # the streaming head after T merges is the top K of every window lane
    # (padded with the K initial -inf entries), ascending
    lanes = torch.sort(srt.reshape(S * T, N), dim=0).values
    if S * T < K:
        lanes = torch.cat([torch.full((K - S * T, N), float("-inf"),
                                      device=lanes.device), lanes])
    return (torch.stack([backlog, sfree]), ys, torch.stack(stats5),
            lanes[-K:].contiguous())


# --------------------------------------------------------------------------
# the CUDA kernel
# --------------------------------------------------------------------------

def _library():
    global _LIB
    if _LIB is None:
        lib = kbuild.load(SOURCE, NVCC_FLAGS)
        used = lib.fleet_tick_consts_used()
        if used != CONSTS_USED:
            raise RuntimeError(f"fleet_tick: the kernel reads {used} "
                               f"coefficient rows, pack_tick_consts packs "
                               f"{CONSTS_USED}")
        fn = lib.fleet_tick_window_launch
        fn.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 7
                       + [ctypes.c_float] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(name, x, shape, device):
    if x.dtype != torch.float32:
        raise TypeError(f"fleet_tick: {name} must be float32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"fleet_tick: {name} has shape {tuple(x.shape)}, "
                         f"expected {shape}")
    if x.device != device:
        raise ValueError(f"fleet_tick: {name} is on {x.device}, not {device}")
    if not x.is_contiguous():
        raise ValueError(f"fleet_tick: {name} must be contiguous")


def fleet_tick_window(state, consts, rate, size, z, u_strag, u_raw, u_fail,
                      active, u_wait, z2a, fmult=None, wmask=None, *, noise,
                      retention_s, straggler_prob, slo, shi, p99_k=2):
    """Run one window's fused tick recurrence + lane statistics.

    state (2, N) [backlog, server_free_rel]; consts (CONSTS_ROWS, N) from
    ``pack_tick_consts``; rate/size/z/u_*/active (T, N); u_wait/z2a
    (T, S, N); ``fmult`` an optional (T, N) chaos service multiplier
    (all-ones when None); ``wmask`` the (T, N) window mask gating which
    ticks' lanes feed the statistics (``active`` when None). ``p99_k`` is
    the caller's p99 interpolation depth; the head is sized by
    ``head_budget``. On a CUDA tensor S and K+S must be what
    ``launch_geometry`` takes.

    Returns (state' (2, N), ys (7, T, N), stats (5, T, N), head (K, N)):
    ys rows = service, queue_delay, batch, processed, straggler, failure,
    backlog_after; stats rows = lane_sum, p50, p95, p99, max (seconds, valid
    at window ticks); head = ascending top-K window lane latencies."""
    global LAUNCHES
    kw = dict(noise=noise, retention_s=retention_s,
              straggler_prob=straggler_prob, slo=slo, shi=shi)
    if not state.is_cuda:
        return fleet_tick_window_ref(state, consts, rate, size, z, u_strag,
                                     u_raw, u_fail, active, u_wait, z2a,
                                     fmult, wmask, p99_k=p99_k, **kw)
    T, S, N = u_wait.shape
    K = head_budget(S, p99_k)
    geo = launch_geometry(N, T, S, K)
    dev = state.device
    _check("state", state, (2, N), dev)
    _check("consts", consts, (CONSTS_ROWS, N), dev)
    grids = dict(rate=rate, size=size, z=z, u_strag=u_strag, u_raw=u_raw,
                 u_fail=u_fail, active=active, wmask=wmask, fmult=fmult)
    for name, x in grids.items():
        if x is not None:
            _check(name, x, (T, N), dev)
    _check("u_wait", u_wait, (T, S, N), dev)
    _check("z2a", z2a, (T, S, N), dev)
    lib = _library()
    state_out = torch.empty((2, N), dtype=torch.float32, device=dev)
    ys = torch.empty((7, T, N), dtype=torch.float32, device=dev)
    stats = torch.empty((5, T, N), dtype=torch.float32, device=dev)
    head = torch.empty((K, N), dtype=torch.float32, device=dev)
    ws = torch.empty(geo["workspace_floats"], dtype=torch.float32,
                     device=dev) if geo["workspace_floats"] else None
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fleet_tick_window_launch(
            ptr(state), ptr(consts), ptr(rate), ptr(size), ptr(z),
            ptr(u_strag), ptr(u_raw), ptr(u_fail), ptr(active), ptr(wmask),
            ptr(fmult), ptr(u_wait), ptr(z2a), ptr(state_out), ptr(ys),
            ptr(stats), ptr(head), ptr(ws), N, T, geo["lanes"], geo["lane_values"],
            geo["values_per_lane"], geo["blocks"], geo["smem_bytes"], noise,
            retention_s, straggler_prob, slo, shi - slo, stream)
    if rc != 0:
        raise RuntimeError(f"fleet_tick kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return state_out, ys, stats, head


def window_recurrence(backlog, sfree_rel, consts, rate, size, z, u_strag,
                      u_raw, u_fail, active, u_wait, z2a, fmult=None,
                      wmask=None, *, noise, retention_s, straggler_prob,
                      slo, shi, p99_k=2):
    """The fused window with the tick scan's carry contract:

        (backlog, sfree_rel) -> (backlog', sfree_rel'),
        (service, queue_delay, batch, processed, straggler, failure,
         backlog_after), stats (5, T, N) seconds, head (K, N) seconds
    """
    state_out, ys, stats, head = fleet_tick_window(
        torch.stack([backlog, sfree_rel]), consts, rate, size, z, u_strag,
        u_raw, u_fail, active, u_wait, z2a, fmult, wmask, noise=noise,
        retention_s=retention_s, straggler_prob=straggler_prob, slo=slo,
        shi=shi, p99_k=p99_k)
    return (state_out[0], state_out[1]), tuple(ys), stats, head
