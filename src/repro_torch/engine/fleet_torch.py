"""Device-resident fleet engine on PyTorch: the ``backend="torch"`` engine of
``FleetCore`` (DESIGN.md §9) — the port of ``repro.engine.fleet_jax``'s
fused-kernel (``pallas``) path.

Every observation window is ONE launch of the hand-written CUDA kernel
``repro_torch.kernels.fleet_tick.fleet_tick_window``: the T-tick queueing
recurrence and the latency-lane statistics (per-tick lane sums and
quantiles plus a streaming top-K head), with the lanes reduced in place.
Around it, plain torch ops on the card do what the reference's jitted
program did around its kernel: the 16-bit RNG transforms, the in-trace
workload rate grid, the window mean/p99 and the metric emission.

* Random draws come from a draw source (``repro_torch.engine.draws``), by
  the reference's addresses, so a test can replay the reference's threefry
  bits through the port; the default is a ``torch.Generator``.
* State lives on the device between calls; the host keeps an exact clock
  shadow (the clock advances by ``n_ticks · T_b``), like the reference.
* Lanes per tick follow the reference's tiers: the kernel's full tile
  (``lane_budget``) on CUDA, the compiled tier's ~1k-sample budget
  (``compiled_lane_budget``) on CPU, so CPU tests see the reference's CPU
  shapes.
* PyTorch runs eagerly, so there is no jit cache and no shape ladder to
  compile; the padded tick and emission counts still follow the reference's
  buckets, which keeps the shapes (and the statistics) equal to its own.

Not ported yet (ROADMAP queue 1, item 2): the lean ``_tick_body`` scan arm,
``fault_effect_grid`` and the kernel-vs-scan calibration.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.engine.draws import PhiloxDraws
from repro_torch.engine.simcluster import (_MAX_LAT_SAMPLES,
                                           _emission_constants, LazyPerNode,
                                           service_terms_arrays)
from repro_torch.utils import txp

#: shape ladder for the padded tick length / emission-slot count (the
#: reference's: ticks past a cluster's own n_ticks are masked inactive)
_SHAPE_BUCKETS = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768,
                  1024)


#: E|N(0,1)| — the half-normal mean, for the analytic tick mean latency
_R2PI = float(np.sqrt(2.0 / np.pi))


def _bucket(n: int, ladder: tuple = _SHAPE_BUCKETS) -> int:
    for b in ladder:
        if n <= b:
            return b
    return -256 * (-n // 256)


def resolve_device(device=None) -> torch.device:
    """The fleet's device: ``cuda`` unless the caller asks for another one.
    Without a card, ``device=None`` raises — the CPU runs only on request."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "backend='torch' runs on a CUDA card and none is available; "
                "pass device='cpu' to run the kernels' plain versions")
        device = "cuda"
    return torch.device(device)


# --------------------------------------------------------------------------
# device-side helpers
# --------------------------------------------------------------------------

def split16(bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One uint32 draw (held in int64) -> two U(0,1) at 16-bit resolution
    (hi, lo halves), centred +0.5 so they stay strictly inside (0, 1)."""
    u_hi = ((bits >> 16).to(torch.float32) + 0.5) / 65536.0
    u_lo = ((bits & 0xFFFF).to(torch.float32) + 0.5) / 65536.0
    return u_hi, u_lo


def norm16(u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF standard normal from a 16-bit uniform (|z| ≤ ~4.2)."""
    return float(np.float32(np.sqrt(2.0))) * torch.special.erfinv(2.0 * u - 1.0)


def split_lane_bits(bits: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One uint32 draw per latency lane -> (uniform wait, |normal| jitter)."""
    u_wait, u_z = split16(bits)
    return u_wait, torch.abs(norm16(u_z))


def normals_16bit(bits: torch.Tensor) -> torch.Tensor:
    """Standard normals at 16-bit resolution, two per uint32 draw: bits of
    shape (..., M/2) -> (..., M)."""
    return norm16(torch.cat(split16(bits), dim=-1))


def lane_budget(T: int, cap: int = _MAX_LAT_SAMPLES) -> int:
    """Latency lanes per tick for a T-tick window on the kernel's full tile:
    the oracle's 64-lane cap, throttled so ticks × lanes stays ≤ ~2k."""
    if T * cap <= 2048:
        return cap
    for s in (32, 16, 8):
        if T * s <= 2048:
            return s
    return 8


def compiled_lane_budget(T: int, cap: int = _MAX_LAT_SAMPLES) -> int:
    """Latency lanes per tick on the reference's compiled CPU tier: the
    largest power of two with ticks × lanes ≤ ~1024 samples."""
    s = 8
    while s * 2 <= cap and T * (s * 2) <= 1024:
        s *= 2
    return s


def window_lanes(T: int, device: torch.device) -> int:
    """Lanes per tick on ``device``: the kernel's tile on CUDA, the
    reference's CPU-tier budget elsewhere."""
    return lane_budget(T) if device.type == "cuda" else compiled_lane_budget(T)


def p99_depth(T: int, S: int) -> int:
    """The window p99's interpolation depth over T·S lanes (the head must
    hold at least this many of the largest lanes)."""
    return min(T * S, int(np.ceil(0.01 * (T * S - 1)))) + 2


def _lerp_quantile(sorted_x: torch.Tensor, cnt: torch.Tensor, q: float,
                   descending: bool = False) -> torch.Tensor:
    """Linear-interpolated q-th percentile of the first ``cnt`` entries of a
    (..., L) ascending sort (or a (..., K) descending head when
    ``descending``), matching the oracle's ``_row_percentiles``."""
    pos = (cnt - 1).to(torch.float32) * (q / 100.0)
    lo = torch.floor(pos).to(torch.int64)
    hi = torch.ceil(pos).to(torch.int64)
    if descending:  # index r ascending lives at cnt-1-r in the descending head
        ia, ib = cnt - 1 - lo, cnt - 1 - hi
    else:
        ia, ib = lo, hi
    L = sorted_x.shape[-1]
    a = torch.gather(sorted_x, -1, ia.clamp(0, L - 1)[..., None])[..., 0]
    b = torch.gather(sorted_x, -1, ib.clamp(0, L - 1)[..., None])[..., 0]
    return a + (pos - lo) * (b - a)


def workload_rate_grid(wl: dict, times) -> tuple[torch.Tensor, torch.Tensor]:
    """Evaluate a packed ``DeviceWorkloadTable`` (a dict of device tensors)
    at ``times`` of shape (..., N) -> (rate, mean_size), both (..., N).

    Every leaf law (the shared ``device_rate`` staticmethods the numpy
    ``Workload.rate`` methods also call) is evaluated and the cluster's own
    is SELECTED by kind code — never multiplied by a mask, since another
    kind's law on this row's parameters may give inf/NaN (a sine of period
    0). The SwitchingWorkload regime flip selects between the two slots from
    the clock, ``(t // period) % 2``; non-switching rows carry
    ``period = inf`` (``t // inf == 0``)."""
    from repro_torch.data.workloads import DEVICE_LEAF_CLASSES

    t = torch.as_tensor(times, dtype=torch.float32)

    def leaf(kind, params):
        out = torch.zeros_like(t)
        for code, cls in sorted(DEVICE_LEAF_CLASSES.items()):
            out = torch.where(kind == code, cls.device_rate(params, t, xp=txp),
                              out)
        return out

    ra = leaf(wl["kind_a"], wl["params_a"])
    rb = leaf(wl["kind_b"], wl["params_b"])
    use_a = (t // wl["period_s"]) % 2.0 < 0.5
    return (torch.where(use_a, ra, rb),
            torch.where(use_a, wl["size_a"], wl["size_b"]))


class _Emission:
    """Metric emission at the paper cadence for one window (the reference's
    emission block): the factor model at the emission ticks, 16-bit metric
    noise, and the latency/queue columns grounded in the simulated mixture
    (the kernel's per-tick lane statistics gathered at the emission ticks).
    ``cols`` picks the emitted metric columns (all 90 on the observe path,
    the encoder's selection in the fused loop)."""

    def __init__(self, core, cols, device):
        emc = _emission_constants()
        cols = np.asarray(cols, np.int64)
        f32 = dict(dtype=torch.float32, device=device)
        self.spec, self.chips, self.nodes = core.spec, core.chips, core.n_nodes
        self.W = torch.as_tensor(emc["W"][:, cols], **f32)        # (8, M)
        self.bias = torch.as_tensor(emc["bias"][cols], **f32)
        self.noise_v = torch.as_tensor(emc["noise_v"][cols], **f32)
        self.M = len(cols)
        self.M_pad = self.M + (self.M % 2)   # two normals per uint32 draw
        #: emitted columns the oracle grounds in the latency mixture / the
        #: queue depth instead of the factor model
        self.lat_overwrite = [(j, int(np.nonzero(emc["lat_cols"] == c)[0][0]))
                              for j, c in enumerate(cols)
                              if c in emc["lat_cols"]]
        self.queue_overwrite = [j for j, c in enumerate(cols)
                                if c == emc["queue_col"]]

    def __call__(self, wdraws, *, cc, mc, F, rg, sg, ys, reconfigs, etick,
                 evalid, n_s, lane_sum_ms, tickq_ms, node_noise):
        service, qd, batch, _, smask_f, fmask_f, blg_e = ys
        E, N = etick.shape
        g = lambda a: torch.gather(a, 0, etick)                 # (E, N)
        srv_e, qd_e, batch_e = g(service), g(qd), g(batch)
        rho_e = srv_e / cc["T_b"]
        terms_e = service_terms_arrays(cc, mc, self.spec, self.chips,
                                       g(rg), g(sg), batch_e, xp=txp)
        s_safe = torch.clamp(srv_e, min=1e-6)
        lvec = torch.stack([
            torch.clamp(rho_e, max=3.0) + 0.2 * torch.log1p(qd_e),
            torch.clamp(terms_e["t_compute"] / s_safe, max=1.0)
            * torch.clamp(rho_e, max=1.0),
            terms_e["mem_frac"],
            terms_e["t_collective"] / s_safe,
            terms_e["t_overhead"] / s_safe,
            terms_e["eff"] / self.spec.base_mfu,
            g(smask_f) + g(fmask_f) + 0.1 * reconfigs[None, :],
            0.6 * torch.clamp(rho_e, max=1.0) + 0.4 * terms_e["eff"],
        ], dim=-1)                                              # (E, N, 8)
        base = torch.einsum("enf,fk->enk", lvec, self.W) + self.bias
        lead = (E, N, self.nodes if node_noise else 1)
        noise = normals_16bit(
            wdraws.emit_bits(lead + (self.M_pad // 2,)))[..., :self.M]
        noisy = base[:, :, None, :] * (1.0 + noise * self.noise_v)
        ecnt = torch.clamp(evalid.sum(dim=0), min=1)            # (N,)
        emean = torch.where(evalid[:, :, None, None], noisy, 0.0).sum(dim=0) \
            / ecnt[:, None, None]                               # (N, nodes|1, M)
        per_node = F * emean
        if self.lat_overwrite or self.queue_overwrite:
            n_s_e = g(n_s)
            st = [g(lane_sum_ms) / n_s_e]
            st += [g(tickq_ms[i]) for i in range(4)]
            stats5 = torch.stack(st, dim=-1)                    # (E, N, 5)
            ew = torch.where(evalid[:, :, None], stats5, 0.0).sum(dim=0) \
                / ecnt[:, None]                                 # (N, 5)
            for j, stat_i in self.lat_overwrite:
                per_node[:, :, j] = ew[:, stat_i][:, None]
            if self.queue_overwrite:
                qmean = torch.where(evalid, g(blg_e), 0.0).sum(dim=0) / ecnt
                for j in self.queue_overwrite:
                    per_node[:, :, j] = qmean[:, None]
        return per_node


def _window_core(wdraws, T, S, backlog, sfree_rel, consts, rg, sg, tmask,
                 wmask, spec):
    """Draw the window's tick and lane noise and run the ``fleet_tick``
    kernel. Returns the carry, ys (7 × (T, N)), the per-tick lane sums and
    quantiles in ms, the head in ms, n_s and the valid-lane count."""
    from repro_torch.kernels.fleet_tick import window_recurrence

    N = backlog.shape[0]
    tick = wdraws.tick_bits(T, N)
    u0, l0 = split16(tick[:, 0])
    u1, l1 = split16(tick[:, 1])
    z = norm16(u0)
    u_wait, z2a = split_lane_bits(wdraws.lane_bits(T, S, N))
    slo, shi = spec.straggler_slow
    (backlog, sfree_rel), ys, kstats, head = window_recurrence(
        backlog, sfree_rel, consts, rg.contiguous(), sg.contiguous(),
        z.contiguous(), l0.contiguous(), u1.contiguous(), l1.contiguous(),
        tmask.to(torch.float32), u_wait, z2a, None,
        wmask.to(torch.float32), noise=spec.noise,
        retention_s=spec.retention_s, straggler_prob=spec.straggler_prob,
        slo=slo, shi=shi, p99_k=p99_depth(T, S))
    n_s = torch.clamp(ys[2].to(torch.int32), 1, S)              # (T, N)
    cnt = (n_s * wmask).sum(dim=0)                              # (N,)
    return ((backlog, sfree_rel), ys, kstats[0] * 1000.0,
            kstats[1:] * 1000.0, head * 1000.0, n_s, cnt)


def _window_summary(ys, wmask, lane_sum_ms, head_ms, cnt):
    """Window mean (masked cross-tick sum of the per-tick lane sums), p99
    (interpolated in the streaming head) and processed events."""
    processed_sum = (ys[3] * wmask).sum(dim=0)
    mean_ms = lane_sum_ms.sum(dim=0) / torch.clamp(cnt, min=1)
    top = torch.flip(head_ms.T, dims=(-1,))                     # descending
    p99 = _lerp_quantile(top, cnt, 99.0, descending=True)
    return mean_ms, p99, processed_sum


# --------------------------------------------------------------------------
# lazy window views (protocol-compatible with the reference's
# MetricsWindowData)
# --------------------------------------------------------------------------

class _WindowBatch:
    """Holds one observe call's device results; converts to numpy lazily and
    at most once, shared by all N window views."""

    def __init__(self, dev: dict, n_ticks: np.ndarray, clock: np.ndarray,
                 index: dict, lane_seed: int = 0,
                 n_skip: Optional[np.ndarray] = None):
        self._dev = dev
        self._np: dict = {}
        self.n_ticks = n_ticks
        self.n_skip = np.zeros_like(n_ticks) if n_skip is None else n_skip
        self.clock = clock
        self.index = index
        self.lane_seed = lane_seed

    def arr(self, name: str) -> np.ndarray:
        if name not in self._np:
            v = self._dev[name]
            self._np[name] = (v.cpu().numpy() if isinstance(v, torch.Tensor)
                              else np.asarray(v))
        return self._np[name]

    def latencies_of(self, i: int) -> np.ndarray:
        """Cluster i's per-event latency sample, drawn host-side from the
        window's per-tick mixture (the kernel reduces its lanes in place and
        never emits them) — deterministic per (window ordinal, cluster)."""
        n_s = self.arr("n_s")
        t0, t1 = int(self.n_skip[i]), int(self.n_ticks[i])
        qd, sv = self.arr("qd")[t0:t1, i], self.arr("service")[t0:t1, i]
        counts = n_s[t0:t1, i].astype(np.int64)
        rng = np.random.default_rng((self.lane_seed << 20) ^ i)
        u = rng.random(int(counts.sum()))
        z = np.abs(rng.standard_normal(int(counts.sum())))
        base = np.repeat((qd + sv) * 1000.0, counts)
        a = np.repeat(np.full(t1 - t0, float(self.arr("T_b")[i]) * 1000.0),
                      counts)
        c = np.repeat(100.0 * sv, counts)
        return base + a * u + c * z


class DeviceMetricsWindow:
    """One cluster's window view over a ``_WindowBatch`` — same attributes as
    the reference's ``MetricsWindowData``, but nothing leaves the device
    until accessed."""

    __slots__ = ("_b", "_i", "_lat")

    def __init__(self, batch: _WindowBatch, i: int):
        self._b = batch
        self._i = i
        self._lat: Optional[np.ndarray] = None

    @property
    def per_node(self) -> LazyPerNode:
        return LazyPerNode(self._b.arr("per_node")[self._i], self._b.index)

    @property
    def node_matrix(self) -> np.ndarray:
        return self._b.arr("per_node")[self._i]

    @property
    def latencies_ms(self) -> np.ndarray:
        if self._lat is None:
            self._lat = self._b.latencies_of(self._i)
        return self._lat

    @property
    def p99_ms(self) -> float:
        return float(self._b.arr("p99_ms")[self._i])

    @property
    def mean_ms(self) -> float:
        return float(self._b.arr("mean_ms")[self._i])

    @property
    def clock_s(self) -> float:
        return float(self._b.clock[self._i])

    @property
    def processed_events(self) -> float:
        return float(self._b.arr("processed")[self._i])


# --------------------------------------------------------------------------
# the engine
# --------------------------------------------------------------------------

class DeviceFleetEngine:
    """Owns the device-resident state of one ``FleetCore`` (DESIGN.md §9).
    Host-side concerns — config dicts, the allow-list, stabilisation, the
    clock shadow — stay on the core."""

    def __init__(self, core, *, device: torch.device):
        self.core = core
        self.device = device
        # per-node metric noise matches the oracle's iid draw at tuning
        # scales; huge exploration fleets share the draw across nodes (the
        # tuner mean-reduces the node axis anyway) — DESIGN.md §9
        self.node_noise = core.n <= 256
        seed = int(np.bitwise_xor.reduce(
            np.asarray(core.seeds, np.uint64) * np.uint64(0x9E3779B9)
            + np.arange(core.n, dtype=np.uint64)) & np.uint64(0x7FFFFFFF))
        #: the draw source every window and fused episode step reads
        self.draws = PhiloxDraws(seed, device)
        self._windows = 0
        #: bulk host RNG for loading-time noise on the host apply path
        self.host_rng = np.random.default_rng(
            np.asarray(core.seeds, np.uint64))
        self._backlog = None          # device (N,) f32
        self._sfree_rel = None        # device (N,) f32, relative to clock
        self._pending_arrivals = np.zeros(core.n)
        self._pending_gap = np.zeros(core.n)
        #: high-water marks of the padded tick / emission counts, per
        #: (summarise,) kind — buckets only grow, like the reference's
        self._hw: dict = {}
        self._cc_dev: Optional[dict] = None
        self._mc_dev = {k: torch.as_tensor(
            v, dtype=torch.bool if v.dtype == bool else torch.float32,
            device=device) for k, v in core.mc.items()}
        self._emission = _Emission(core, range(len(core.metric_names)), device)
        self._emit_F = torch.as_tensor(core._emit_factor, dtype=torch.float32,
                                       device=device)
        self._index = {m: j for j, m in enumerate(core.metric_names)}
        self.last_stats: Optional[dict] = None

    # ------------------------------------------------------------- host hooks
    def reset(self) -> None:
        self._backlog = None
        self._sfree_rel = None
        self._pending_arrivals[:] = 0.0
        self._pending_gap[:] = 0.0
        self._cc_dev = None
        self._hw.clear()
        self.last_stats = None
        # the draw source keeps running: a reset fleet draws fresh randomness

    def invalidate_cc(self) -> None:
        self._cc_dev = None

    def buffer_during_load(self, i: int, load_s: float) -> None:
        """Kafka buffering while cluster i reconfigures — queued host-side,
        applied on device at the next observe (no device round-trip)."""
        core = self.core
        self._pending_arrivals[i] += core.workloads[i].rate(
            float(core.clock[i])) * load_s
        self._pending_gap[i] += load_s

    def buffer_during_load_batch(self, arrivals: np.ndarray,
                                 gaps: np.ndarray) -> None:
        self._pending_arrivals += arrivals
        self._pending_gap += gaps

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)

    def _device_state(self) -> tuple:
        """(backlog, sfree_rel) on device with any pending loading-time
        buffers folded in."""
        core = self.core
        if self._backlog is None:
            self._backlog = self._tensor(core.backlog)
            self._sfree_rel = self._tensor(
                np.maximum(core.server_free - core.clock, 0.0))
        backlog, sfree = self._backlog, self._sfree_rel
        if self._pending_arrivals.any() or self._pending_gap.any():
            backlog = backlog + self._tensor(self._pending_arrivals)
            sfree = torch.clamp(sfree - self._tensor(self._pending_gap),
                                min=0.0)
            self._pending_arrivals[:] = 0.0
            self._pending_gap[:] = 0.0
        return backlog, sfree

    # -------------------------------------------------- fused-loop state handoff
    def loop_state(self) -> tuple:
        """(backlog, sfree_rel, clock) device f32 tensors for the fused
        training loop (DESIGN.md §10) — the loop owns the queueing state
        until ``adopt_loop_state`` hands it back."""
        backlog, sfree = self._device_state()
        return backlog, sfree, self._tensor(self.core.clock)

    def adopt_loop_state(self, backlog, sfree_rel, clock) -> None:
        """Re-adopt the queueing state after a fused episode batch; the host
        clock shadow continues from the device f32 clock (§10)."""
        self._backlog = backlog
        self._sfree_rel = sfree_rel
        self.core.clock[:] = clock.cpu().numpy().astype(np.float64)

    # ----------------------------------------------------------------- cc
    def _cc(self) -> dict:
        if self._cc_dev is None:
            self._cc_dev = {k: self._tensor(v)
                            for k, v in self.core.packed().items()}
        return self._cc_dev

    # ------------------------------------------------------------ the windows
    def _rate_grids(self, T: int, T_b: np.ndarray) -> tuple:
        core = self.core
        cr = core._const_rates()
        if cr is not None:
            rate, size = cr
            return rate[None, :], size[None, :]
        times = core.clock[None, :] + np.arange(T)[:, None] * T_b[None, :]
        rate = np.empty((T, core.n))
        size = np.empty((T, core.n))
        for i, w in enumerate(core.workloads):
            rate[:, i] = w.rate(times[:, i])
            size[:, i] = w.mean_size(times[:, i])
        return rate, size

    def observe_fleet(self, win: np.ndarray, *, summarise: bool = True,
                      build_windows: bool = True,
                      preroll_s: Optional[np.ndarray] = None):
        """Advance every cluster by (an optional stabilisation preroll +)
        its window and summarise the window on device: ONE ``fleet_tick``
        kernel launch. ``preroll_s`` fuses the paper-§4.2 post-
        reconfiguration wait into the same launch — those ticks evolve state
        but emit nothing and are excluded from the window statistics."""
        core = self.core
        N = core.n
        packed = core.packed()
        T_b = packed["T_b"]
        ee = packed["emit_every"].astype(np.int64)
        n_win = np.maximum(1, np.round(win / T_b)).astype(np.int64)
        if preroll_s is None:
            n_skip = np.zeros(N, np.int64)
        else:
            n_skip = np.maximum(0, np.round(
                np.asarray(preroll_s, float) / T_b)).astype(np.int64)
        n_ticks = n_skip + n_win
        T = max(_bucket(int(n_ticks.max())), self._hw.get(("T", summarise), 0))
        self._hw[("T", summarise)] = T
        forced = n_win < ee
        if summarise:
            n_emit = n_win // ee + forced
            E = _bucket(int(n_emit.max()), (1, 2, 4, 6) + _SHAPE_BUCKETS)
            E = max(E, self._hw.get("E", 0))
            self._hw["E"] = E
            etick = n_skip[None, :] + np.where(
                forced[None, :], n_win[None, :] - 1,
                (np.arange(E)[:, None] + 1) * ee[None, :] - 1)
            evalid = np.arange(E)[:, None] < n_emit[None, :]
            etick = np.clip(etick, 0, T - 1)
        rate_g, size_g = self._rate_grids(T, T_b)
        S = window_lanes(T, self.device)
        backlog, sfree = self._device_state()
        sfree = torch.clamp(sfree, min=0.0)      # server_free = max(·, clock)
        cc = self._cc()
        from repro_torch.kernels.fleet_tick import pack_tick_consts

        consts = pack_tick_consts(cc, self._mc_dev, core.spec, core.chips)
        t_ax = torch.arange(T, device=self.device)[:, None]
        n_ticks_d = self._tensor(n_ticks, torch.int64)
        n_skip_d = self._tensor(n_skip, torch.int64)
        tmask = t_ax < n_ticks_d[None, :]
        wmask = tmask & (t_ax >= n_skip_d[None, :])
        rg = self._tensor(rate_g).expand(T, N)
        sg = self._tensor(size_g).expand(T, N)
        wdraws = self.draws.window()
        self._windows += 1
        ((backlog, sfree), ys, lane_sum_ms, tickq_ms, head_ms, n_s,
         cnt) = _window_core(wdraws, T, S, backlog, sfree, consts, rg, sg,
                             tmask, wmask, core.spec)
        core.clock += n_ticks * T_b        # exact host shadow
        self._backlog, self._sfree_rel = backlog, sfree
        if not summarise:
            return None
        mean_ms, p99, processed = _window_summary(ys, wmask, lane_sum_ms,
                                                  head_ms, cnt)
        per_node = self._emission(
            wdraws, cc=cc, mc=self._mc_dev, F=self._emit_F, rg=rg, sg=sg,
            ys=ys, reconfigs=self._tensor(core.reconfigs),
            etick=self._tensor(etick, torch.int64),
            evalid=self._tensor(evalid, torch.bool), n_s=n_s,
            lane_sum_ms=lane_sum_ms, tickq_ms=tickq_ms,
            node_noise=self.node_noise)
        self.last_stats = {"mean_ms": mean_ms, "p99_ms": p99,
                           "processed": processed, "per_node": per_node,
                           "clock_s": core.clock.copy()}
        if not build_windows:
            return None
        dev = {"mean_ms": mean_ms, "p99_ms": p99, "processed": processed,
               "per_node": per_node, "n_s": n_s, "qd": ys[1],
               "service": ys[0], "T_b": T_b.copy()}
        batch = _WindowBatch(dev, n_ticks, core.clock.copy(), self._index,
                             lane_seed=self._windows, n_skip=n_skip)
        return [DeviceMetricsWindow(batch, i) for i in range(N)]


# --------------------------------------------------------------------------
# the fused loop's window step (DESIGN.md §10)
# --------------------------------------------------------------------------

def build_step_window(core, sel_cols: tuple, T: int, E: int,
                      *, slo_ms: float = 0.0):
    """Build the window step of the fused training loop: one observation
    window (stabilisation preroll + window + selected metric emission)
    that carries the queueing state, derives its tick geometry from the
    device-resident per-cluster lever values (``cc``) and summarises only
    the ``sel_cols`` metric columns the heat-map encoder reads.

    ``T`` is the padded tick budget (preroll + window are CLIPPED to it, the
    documented §10 deviation) and ``E`` the emission-slot budget.

        step_window(wdraws, backlog, sfree_rel, clock, cc, wl,
                    stab_s, reconfigs, win_s)
            -> (backlog', sfree_rel', clock'), stats

    with ``stats = {"mean_ms", "p99_ms", "processed", "per_node"}``
    (``per_node`` (N, nodes, len(sel_cols))), plus ``"breach_frac"`` when
    ``slo_ms > 0``. ``wdraws`` is the step's window draws
    (``repro_torch.engine.draws``); ``wl`` a packed ``DeviceWorkloadTable``
    as a dict of device tensors — the (T, N) rate grids are evaluated from
    the carried clock (``workload_rate_grid``), so time-varying fleets run
    fused. The window itself is one ``fleet_tick`` kernel launch."""
    from repro_torch.kernels.fleet_tick import pack_tick_consts

    dev = core._dev
    device = dev.device
    spec, chips = core.spec, core.chips
    emission = _Emission(core, sel_cols, device)
    F_sel = torch.as_tensor(core._emit_factor[:, :, np.asarray(sel_cols)],
                            dtype=torch.float32, device=device)
    mc_dev = dev._mc_dev
    node_noise = dev.node_noise
    S = window_lanes(T, device)
    t_ax = torch.arange(T, device=device)[:, None]
    e_ax = torch.arange(E, device=device)[:, None]

    def step_window(wdraws, backlog, sfree_rel, clock, cc, wl, stab_s,
                    reconfigs, win_s):
        T_b = cc["T_b"]
        ee = torch.clamp(cc["emit_every"].to(torch.int64), min=1)
        n_win = torch.clamp(torch.round(win_s / T_b).to(torch.int64), 1, T)
        n_skip = txp.clip(torch.round(stab_s / T_b).to(torch.int64), 0,
                          T - n_win)
        n_ticks = n_skip + n_win
        tmask = t_ax < n_ticks[None, :]
        wmask = tmask & (t_ax >= n_skip[None, :])
        consts = pack_tick_consts(cc, mc_dev, spec, chips)
        sfree_rel = torch.clamp(sfree_rel, min=0.0)
        # (T, N) arrival grids from the carried clock: tick t covers
        # [clock + t·T_b, clock + (t+1)·T_b)
        times = clock[None, :] + t_ax.to(torch.float32) * T_b[None, :]
        rg, sg = workload_rate_grid(wl, times)
        ((backlog, sfree_rel), ys, lane_sum_ms, tickq_ms, head_ms, n_s,
         cnt) = _window_core(wdraws, T, S, backlog, sfree_rel, consts, rg,
                             sg, tmask, wmask, spec)
        mean_ms, p99, processed = _window_summary(ys, wmask, lane_sum_ms,
                                                  head_ms, cnt)
        # ---- metric emission, selected columns only (device etick) ----
        forced = n_win < ee
        n_emit = n_win // ee + forced
        etick = torch.where(forced[None, :],
                            n_skip[None, :] + n_win[None, :] - 1,
                            n_skip[None, :] + (e_ax + 1) * ee[None, :] - 1)
        etick = torch.clamp(etick, 0, T - 1)
        evalid = e_ax < n_emit[None, :]
        per_node = emission(
            wdraws, cc=cc, mc=mc_dev, F=F_sel, rg=rg, sg=sg, ys=ys,
            reconfigs=reconfigs, etick=etick, evalid=evalid, n_s=n_s,
            lane_sum_ms=lane_sum_ms, tickq_ms=tickq_ms,
            node_noise=node_noise)
        clock = clock + n_ticks.to(torch.float32) * T_b
        stats = {"mean_ms": mean_ms, "p99_ms": p99, "processed": processed,
                 "per_node": per_node}
        if slo_ms > 0.0:
            # breach duration: fraction of window ticks whose analytic mean
            # latency (base + a/2 + √(2/π)·c) exceeds the SLO
            service, qd = ys[0], ys[1]
            tick_ms = ((qd + service) * 1000.0 + 0.5 * (T_b * 1000.0)[None, :]
                       + _R2PI * (100.0 * service))
            stats["breach_frac"] = ((tick_ms > slo_ms) & wmask).sum(dim=0) \
                / torch.clamp(wmask.sum(dim=0), min=1)
        return (backlog, sfree_rel, clock), stats

    return step_window
