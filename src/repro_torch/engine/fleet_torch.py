"""Device-resident fleet engine on PyTorch: the ``backend="torch"`` engine of
``FleetCore`` (DESIGN.md §9) — the port of ``repro.engine.fleet_jax``.

Every observation window is ONE launch of a hand-written CUDA kernel, by
the engine's ``window_impl``:

* ``"kernel"`` (the reference's ``backend="pallas"``): the ``fleet_tick``
  kernel (``repro_torch.kernels.fleet_tick``) runs the T-tick queueing
  recurrence and the latency-lane statistics (per-tick lane sums and
  quantiles plus a streaming top-K head), with the lanes reduced in place;
* ``"scan"`` (the reference's ``backend="jax"``, its lean ``_tick_body``
  scan): the lane-free ``fleet_scan`` kernel
  (``repro_torch.kernels.fleet_scan``) runs the recurrence alone; the window
  mean is the analytic mixture expectation, the p99 is sampled over
  ``p99_lanes(T)`` lanes a tick through ``torch.topk``, and the emitted
  latency columns are the mixture's analytic quantiles;
* ``"auto"`` picks one of the two once, at engine construction, from a
  timed probe cached per (device type, fleet-size bucket)
  (``preferred_window_impl``); ``REPRO_FLEET_IMPL=pallas|scan`` overrides
  the probe, ``pallas`` meaning ``"kernel"``.

Around the kernel, plain torch ops on the card do what the reference's
jitted program did around its kernel or scan: the 16-bit RNG transforms
(but the ``fleet_tick`` kernel's, which it does itself from the raw words),
the in-trace workload rate grid, the window mean/p99 and the metric
emission.

* Random draws come from a draw source (``repro_torch.engine.draws``), by
  the reference's addresses, so a test can replay the reference's threefry
  bits through the port; the default is a ``torch.Generator``.
* State lives on the device between calls; the host keeps an exact clock
  shadow (the clock advances by ``n_ticks · T_b``), like the reference.
* Lanes per tick on the kernel path follow the reference's tiers: the
  kernel's full tile (``lane_budget``) on CUDA, the compiled tier's
  ~1k-sample budget (``compiled_lane_budget``) on CPU, so CPU tests see the
  reference's CPU shapes.
* PyTorch runs eagerly, so there is no jit cache and no shape ladder to
  compile; the padded tick and emission counts still follow the reference's
  buckets, which keeps the shapes (and the statistics) equal to its own.

* Chaos tables (``repro_torch.core.faults``, DESIGN.md §12): rate shocks
  premultiply the arrival grid and service faults ride the kernels'
  ``fmult`` operand — evaluated host-side in f64 on the observe path, as
  the reference does, and on the device (``fault_effect_grid``) in the
  fused loop's window step.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.engine.draws import PhiloxDraws
from repro_torch.engine.simcluster import (_MAX_LAT_SAMPLES,
                                           _emission_constants, LazyPerNode,
                                           service_terms_arrays)
from repro_torch.monitoring.tracing import span
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


def p99_lanes(T: int, cap: int = _MAX_LAT_SAMPLES, budget: int = 768) -> int:
    """Latency lanes per tick backing the scan path's window p99 (its mean is
    analytic): ~768 samples a window at any tick length, 4 to ``cap``
    lanes a tick."""
    return max(4, min(cap, budget // max(T, 1)))


def p99_topk(T: int, Sp: int) -> int:
    """The scan path's top-k depth over T·Sp sampled lanes (the p99's
    interpolation needs the top 1 % and two more)."""
    return min(T * Sp, int(np.ceil(0.01 * (T * Sp - 1))) + 2)


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


def fault_effect_grid(ft: dict, times) -> tuple[torch.Tensor, torch.Tensor]:
    """Evaluate a packed ``DeviceFaultTable`` (a dict of device tensors) at
    ``times`` of shape (..., N) -> (service_mult, rate_mult), both f32 and
    shaped like ``times`` — the device twin of ``DeviceFaultTable.effects``
    and of the reference's ``fault_effect_grid`` (DESIGN.md §12).

    Per event slot, every kind's law (the shared ``device_effect``
    staticmethods) is evaluated over all rows and the row's own is SELECTED
    by kind code — never multiplied by a mask, since another kind's law on
    this row's parameters may give inf/NaN (``FailureFault``'s division by
    its 1e-9 tail). Slots compose by sequential multiplication in slot
    order, as the reference does; padding slots multiply by an exact
    ``1.0``. Only compares, adds, multiplies, divides and selects: the grid
    is bitwise the same on the card and on the CPU."""
    from repro_torch.core.faults import FAULT_KIND_CLASSES

    t = torch.as_tensor(times, dtype=torch.float32)
    slow = torch.ones_like(t)
    rate = torch.ones_like(t)
    for e in range(ft["kind"].shape[1]):
        kind, p = ft["kind"][:, e], ft["params"][:, e]
        s_e = torch.ones_like(t)
        r_e = torch.ones_like(t)
        for code, cls in sorted(FAULT_KIND_CLASSES.items()):
            s_k, r_k = cls.device_effect(p, t, xp=txp)
            s_e = torch.where(kind == code, s_k, s_e)
            r_e = torch.where(kind == code, r_k, r_e)
        slow = slow * s_e
        rate = rate * r_e
    return slow, rate


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
                 evalid, stats5, node_noise):
        """``stats5(g)``: the (E, N, 5) latency stats (mean, p50, p95, p99,
        max in ms) at the emission ticks, ``g`` the gather of a (T, N)
        tensor at them (``_lane_stats5`` or ``_analytic_stats5``)."""
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
            ew = torch.where(evalid[:, :, None], stats5(g), 0.0).sum(dim=0) \
                / ecnt[:, None]                                 # (N, 5)
            for j, stat_i in self.lat_overwrite:
                per_node[:, :, j] = ew[:, stat_i][:, None]
            if self.queue_overwrite:
                qmean = torch.where(evalid, g(blg_e), 0.0).sum(dim=0) / ecnt
                for j in self.queue_overwrite:
                    per_node[:, :, j] = qmean[:, None]
        return per_node


def tick_noise(tick: torch.Tensor) -> tuple:
    """The tick draws' two uint32 a (tick, cluster), (T, 2, N), decoded:
    the arrival normal z and the straggler / slow / failure uniforms, each
    a contiguous (T, N) f32 tensor."""
    u0, l0 = split16(tick[:, 0])
    u1, l1 = split16(tick[:, 1])
    return (norm16(u0).contiguous(), l0.contiguous(), u1.contiguous(),
            l1.contiguous())


def _tick_kw(spec) -> dict:
    slo, shi = spec.straggler_slow
    return dict(noise=spec.noise, retention_s=spec.retention_s,
                straggler_prob=spec.straggler_prob, slo=slo, shi=shi)


def _window_core(wdraws, T, S, backlog, sfree_rel, consts, rg, sg, tmask,
                 wmask, spec, fmult=None):
    """Draw the window's tick and lane words and run the ``fleet_tick``
    kernel, which decodes them (``fmult``: the contiguous f32 (T, N) chaos
    service multiplier, or None).
    Returns the carry, ys (7 × (T, N)), the per-tick lane sums and
    quantiles in ms, the head in ms, n_s and the valid-lane count."""
    from repro_torch.kernels.fleet_tick import window_recurrence

    N = backlog.shape[0]
    tick_bits = wdraws.tick_bits(T, N)
    lane_bits = wdraws.lane_bits(T, S, N)
    (backlog, sfree_rel), ys, kstats, head = window_recurrence(
        backlog, sfree_rel, consts, rg.contiguous(), sg.contiguous(),
        tick_bits, tmask.to(torch.float32), lane_bits, fmult,
        wmask.to(torch.float32), p99_k=p99_depth(T, S), **_tick_kw(spec))
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


def _lane_stats5(lane_sum_ms, tickq_ms, n_s):
    """The kernel path's emitted latency stats: its per-tick lane mean and
    quantile rows, gathered at the emission ticks (always window ticks)."""
    def stats5(g):
        st = [g(lane_sum_ms) / g(n_s)] + [g(tickq_ms[i]) for i in range(4)]
        return torch.stack(st, dim=-1)                          # (E, N, 5)
    return stats5


def _scan_core(wdraws, T, backlog, sfree_rel, consts, rg, sg, tmask, spec,
               fmult=None):
    """Draw the window's tick noise and run the lane-free ``fleet_scan``
    kernel. Returns the carry, ys (7 × (T, N)) and n_s, the lanes a tick
    of the latency mixture (``clip(batch, 1, _MAX_LAT_SAMPLES)``)."""
    from repro_torch.kernels.fleet_scan import fleet_scan

    N = backlog.shape[0]
    z, u_strag, u_raw, u_fail = tick_noise(wdraws.tick_bits(T, N))
    state, ys = fleet_scan(
        torch.stack([backlog, sfree_rel]), consts, rg.contiguous(),
        sg.contiguous(), z, u_strag, u_raw, u_fail, tmask.to(torch.float32),
        fmult, **_tick_kw(spec))
    n_s = torch.clamp(ys[2].to(torch.int32), 1, _MAX_LAT_SAMPLES)
    return (state[0], state[1]), ys, n_s


def _scan_summary(wdraws, T, ys, wmask, n_s, T_b):
    """The scan path's window statistics: the mean is the exact expectation
    of each tick's latency mixture base + a·U + c·|Z| weighted by its
    lanes, the p99 is sampled over ``p99_lanes(T)`` lanes a tick (the top
    ``p99_topk`` through ``torch.topk``), plus processed events."""
    service, qd = ys[0], ys[1]
    N = service.shape[1]
    processed_sum = (ys[3] * wmask).sum(dim=0)
    base_ms = (qd + service) * 1000.0                           # (T, N)
    a_ms = (T_b * 1000.0)[None, :]
    c_ms = 100.0 * service
    w_t = n_s.to(torch.float32) * wmask
    mean_ms = (w_t * (base_ms + 0.5 * a_ms + _R2PI * c_ms)).sum(dim=0) \
        / torch.clamp(w_t.sum(dim=0), min=1e-9)
    Sp = p99_lanes(T)
    u_p, z_p = split_lane_bits(wdraws.p99_bits(T, N, Sp))
    lat_p = base_ms[:, :, None] + a_ms[:, :, None] * u_p \
        + c_ms[:, :, None] * z_p
    n_sp = torch.clamp(n_s, max=Sp)
    lane = torch.arange(Sp, device=service.device)[None, None, :]
    lv = (lane < n_sp[:, :, None]) & wmask[:, :, None]
    cnt = lv.sum(dim=(0, 2))
    flat = torch.where(lv, lat_p, float("-inf")).permute(1, 0, 2) \
        .reshape(N, T * Sp)
    top = torch.topk(flat, p99_topk(T, Sp), dim=-1).values     # descending
    p99 = _lerp_quantile(top, cnt, 99.0, descending=True)
    return mean_ms, p99, processed_sum


def _analytic_stats5(service, qd, T_b, n_s):
    """The scan path's emitted latency stats: the analytic mean, quantiles
    and expected maximum of base + a·U + c·|Z| at the emission ticks (the
    wait term dominates, so the quantiles are the uniform's, shifted by
    the jitter's mean)."""
    def stats5(g):
        base_e = (g(qd) + g(service)) * 1000.0
        c_e = 100.0 * g(service)
        a_e = T_b[None, :] * 1000.0
        q = lambda al: base_e + al * a_e + _R2PI * c_e
        n_f = g(n_s).to(torch.float32)
        mx = base_e + a_e * n_f / (n_f + 1.0) \
            + c_e * torch.sqrt(2.0 * torch.log(torch.clamp(n_f, min=2.0)))
        return torch.stack([q(0.5), q(0.5), q(0.95), q(0.99), mx], dim=-1)
    return stats5


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

#: the engine's window implementations: the reference's ``backend``
#: "pallas", "jax" and "auto"
WINDOW_IMPLS = ("kernel", "scan", "auto")


def check_window_impl(window_impl: str) -> str:
    if window_impl not in WINDOW_IMPLS:
        raise ValueError(f"window_impl={window_impl!r}: one of "
                         f"{WINDOW_IMPLS} (the reference's backend "
                         "'pallas', 'jax' and 'auto')")
    return window_impl


class DeviceFleetEngine:
    """Owns the device-resident state of one ``FleetCore`` (DESIGN.md §9).
    Host-side concerns — config dicts, the allow-list, stabilisation, the
    clock shadow — stay on the core. ``window_impl`` is resolved here, once
    (``"auto"`` through ``preferred_window_impl``)."""

    def __init__(self, core, *, device: torch.device,
                 window_impl: str = "kernel"):
        self.core = core
        self.device = device
        if check_window_impl(window_impl) == "auto":
            window_impl = preferred_window_impl(core.n, device=device)
        #: "kernel" (fleet_tick) or "scan" (fleet_scan), never "auto"
        self.window_impl = window_impl
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

    def prewarm(self, window_s: float,
                t_buckets=(24, 32, 48, 64, 96, 128, 192, 256)) -> None:
        """Build the window kernel of ``window_impl`` and run the
        reference's shape ladder up front: ascending fused prerolls stretch
        the tick length while the observation window (and with it the
        emission-slot count) stays the real one, so every per-shape buffer
        and library exists before exploration starts. Nothing is captured:
        the observe path is eager.

        The sim is restored exactly afterwards: the clock, the device
        backlog and server occupancy, the pending arrivals and gaps, the
        shape high-water marks, ``last_stats`` and the window counter. The
        ladder draws from a scratch stream, so the engine's own draw source
        is never advanced: prewarm is RNG-transparent, safe mid-run."""
        if self.device.type == "cuda":
            from repro_torch.kernels import fleet_scan, fleet_tick

            (fleet_scan if self.window_impl == "scan" else fleet_tick
             )._library()
        core = self.core
        clock0 = core.clock.copy()
        state0 = (self._backlog, self._sfree_rel)
        pend_a = self._pending_arrivals.copy()
        pend_g = self._pending_gap.copy()
        draws0, hw0 = self.draws, dict(self._hw)
        stats0, windows0 = self.last_stats, self._windows
        T_b = core.packed()["T_b"]
        win = np.full(core.n, float(window_s))
        n_win = np.maximum(1, np.round(win / T_b))
        self.draws = PhiloxDraws(0, self.device)
        try:
            for b in t_buckets:
                pre = np.maximum(b - n_win, 0.0) * T_b
                self.observe_fleet(win, preroll_s=pre, build_windows=False)
        finally:
            core.clock[:] = clock0
            # observe replaces the state tensors, never writes them in place
            self._backlog, self._sfree_rel = state0
            self._pending_arrivals[:] = pend_a
            self._pending_gap[:] = pend_g
            self.draws, self._hw = draws0, hw0
            self.last_stats, self._windows = stats0, windows0

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
        or ``fleet_scan`` kernel launch (``window_impl``). ``preroll_s``
        fuses the paper-§4.2 post-reconfiguration wait into the same
        launch — those ticks evolve state but emit nothing and are excluded
        from the window statistics."""
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
        # chaos events (repro_torch.core.faults): host-evaluated effect
        # grids in f64, like the rate grids — rate shocks premultiply
        # arrivals, service faults ride the kernel's fmult operand
        fmult = None
        ft = core._faults
        if ft is not None and ft.has_tick_effects():
            times = core.clock[None, :] + np.arange(T)[:, None] * T_b[None, :]
            f_slow, f_rate = ft.effects(times)
            rate_g = rate_g * f_rate            # broadcasts (1,N) -> (T,N)
            fmult = self._tensor(f_slow)
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
        scan = self.window_impl == "scan"
        if scan:
            (backlog, sfree), ys, n_s = _scan_core(
                wdraws, T, backlog, sfree, consts, rg, sg, tmask, core.spec,
                fmult)
        else:
            ((backlog, sfree), ys, lane_sum_ms, tickq_ms, head_ms, n_s,
             cnt) = _window_core(wdraws, T, window_lanes(T, self.device),
                                 backlog, sfree, consts, rg, sg, tmask, wmask,
                                 core.spec, fmult)
        core.clock += n_ticks * T_b        # exact host shadow
        self._backlog, self._sfree_rel = backlog, sfree
        if not summarise:
            return None
        if scan:
            mean_ms, p99, processed = _scan_summary(wdraws, T, ys, wmask,
                                                    n_s, consts[0])
            stats5 = _analytic_stats5(ys[0], ys[1], consts[0], n_s)
        else:
            mean_ms, p99, processed = _window_summary(ys, wmask, lane_sum_ms,
                                                      head_ms, cnt)
            stats5 = _lane_stats5(lane_sum_ms, tickq_ms, n_s)
        per_node = self._emission(
            wdraws, cc=cc, mc=self._mc_dev, F=self._emit_F, rg=rg, sg=sg,
            ys=ys, reconfigs=self._tensor(core.reconfigs),
            etick=self._tensor(etick, torch.int64),
            evalid=self._tensor(evalid, torch.bool), stats5=stats5,
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
                      *, slo_ms: float = 0.0, window_impl: str = None,
                      clusters: Optional[tuple] = None):
    """Build the window step of the fused training loop: one observation
    window (stabilisation preroll + window + selected metric emission)
    that carries the queueing state, derives its tick geometry from the
    device-resident per-cluster lever values (``cc``) and summarises only
    the ``sel_cols`` metric columns the heat-map encoder reads.

    ``T`` is the padded tick budget (preroll + window are CLIPPED to it, the
    documented §10 deviation) and ``E`` the emission-slot budget.

        step_window(wdraws, backlog, sfree_rel, clock, cc, wl,
                    stab_s, reconfigs, win_s, ft=None)
            -> (backlog', sfree_rel', clock'), stats

    with ``stats = {"mean_ms", "p99_ms", "processed", "per_node"}``
    (``per_node`` (N, nodes, len(sel_cols))), plus ``"breach_frac"`` when
    ``slo_ms > 0``. ``wdraws`` is the step's window draws
    (``repro_torch.engine.draws``); ``wl`` a packed ``DeviceWorkloadTable``
    as a dict of device tensors — the (T, N) rate grids are evaluated from
    the carried clock (``workload_rate_grid``), so time-varying fleets run
    fused. ``ft`` (optional) is a packed ``DeviceFaultTable`` as a dict of
    device tensors: its events are evaluated at the same tick times
    (``fault_effect_grid``) — rate shocks premultiply the arrival grid,
    service faults ride the kernel's ``fmult`` operand. The window itself
    is one kernel launch: ``fleet_tick`` under ``window_impl="kernel"``,
    ``fleet_scan`` (analytic mean, sampled p99, analytic emitted latency
    columns) under ``"scan"``; None takes the engine's resolved impl.

    ``clusters = (lo, n)`` builds the step for the block of clusters
    ``[lo, lo+n)`` (a fleet-mesh shard, DESIGN.md §11): the per-cluster
    emission factors and model constants it closes over are that block's,
    and every tensor it is called with holds n clusters."""
    from repro_torch.kernels.fleet_tick import pack_tick_consts

    dev = core._dev
    device = dev.device
    window_impl = dev.window_impl if window_impl is None else window_impl
    if window_impl not in ("kernel", "scan"):
        raise ValueError(f"build_step_window: window_impl={window_impl!r} "
                         "(resolve 'auto' at engine construction)")
    scan = window_impl == "scan"
    spec, chips = core.spec, core.chips
    emission = _Emission(core, sel_cols, device)
    F_sel = torch.as_tensor(core._emit_factor[:, :, np.asarray(sel_cols)],
                            dtype=torch.float32, device=device)
    mc_dev = dev._mc_dev
    if clusters is not None:
        lo, n = clusters
        F_sel = F_sel[lo:lo + n]
        mc_dev = {k: v[lo:lo + n] for k, v in mc_dev.items()}
    node_noise = dev.node_noise
    S = window_lanes(T, device)
    t_ax = torch.arange(T, device=device)[:, None]
    e_ax = torch.arange(E, device=device)[:, None]

    def step_window(wdraws, backlog, sfree_rel, clock, cc, wl, stab_s,
                    reconfigs, win_s, ft=None):
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
        f_slow = None
        if ft is not None:
            with span("rt.window.faults"):
                f_slow, f_rate = fault_effect_grid(ft, times)
                rg = rg * f_rate
        if scan:
            with span("rt.window.core"):
                (backlog, sfree_rel), ys, n_s = _scan_core(
                    wdraws, T, backlog, sfree_rel, consts, rg, sg, tmask,
                    spec, f_slow)
            mean_ms, p99, processed = _scan_summary(wdraws, T, ys, wmask,
                                                    n_s, T_b)
            stats5 = _analytic_stats5(ys[0], ys[1], T_b, n_s)
        else:
            with span("rt.window.core"):
                ((backlog, sfree_rel), ys, lane_sum_ms, tickq_ms, head_ms,
                 n_s, cnt) = _window_core(wdraws, T, S, backlog, sfree_rel,
                                          consts, rg, sg, tmask, wmask, spec,
                                          f_slow)
            mean_ms, p99, processed = _window_summary(ys, wmask, lane_sum_ms,
                                                      head_ms, cnt)
            stats5 = _lane_stats5(lane_sum_ms, tickq_ms, n_s)
        # ---- metric emission, selected columns only (device etick) ----
        with span("rt.window.emit"):
            forced = n_win < ee
            n_emit = n_win // ee + forced
            etick = torch.where(forced[None, :],
                                n_skip[None, :] + n_win[None, :] - 1,
                                n_skip[None, :] + (e_ax + 1) * ee[None, :]
                                - 1)
            etick = torch.clamp(etick, 0, T - 1)
            evalid = e_ax < n_emit[None, :]
            per_node = emission(
                wdraws, cc=cc, mc=mc_dev, F=F_sel, rg=rg, sg=sg, ys=ys,
                reconfigs=reconfigs, etick=etick, evalid=evalid,
                stats5=stats5, node_noise=node_noise)
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


# --------------------------------------------------------------------------
# kernel-vs-scan calibration (window_impl="auto", DESIGN.md §14)
# --------------------------------------------------------------------------

#: (device type, fleet-size bucket) -> "kernel" | "scan"
_IMPL_CACHE: dict = {}


def _probe_window_fns(T: int, N: int, device: torch.device):
    """The two window implementations' divergent halves at (T, N) on
    ``device``: the ``fleet_tick`` kernel with its head/mean reductions, and
    the ``fleet_scan`` kernel with the analytic mean and the sampled-lane
    p99. Each draws and decodes its noise as its real path does (the
    kernel its raw words itself, the scan its tick words eagerly); the
    emission and summary gathers are shared by the real paths, so the
    comparison leaves them out. Each takes (draws, state, consts, rate,
    size) and returns (state', mean, p99)."""
    from repro_torch.kernels.fleet_scan import fleet_scan
    from repro_torch.kernels.fleet_tick import fleet_tick_window

    S = window_lanes(T, device)
    kw = dict(noise=0.05, retention_s=60.0, straggler_prob=0.05, slo=1.5,
              shi=3.0)
    active = torch.ones((T, N), dtype=torch.float32, device=device)
    wmask = torch.ones((T, N), dtype=torch.bool, device=device)

    def kern(draws, state, consts, rate, size):
        tick_bits = draws.tick_bits(T, N)
        state_out, ys, stats, head = fleet_tick_window(
            state, consts, rate, size, tick_bits, active,
            draws.lane_bits(T, S, N), p99_k=p99_depth(T, S), **kw)
        cnt = torch.clamp(ys[2].to(torch.int32), 1, S).sum(dim=0)
        mean = stats[0].sum(dim=0) / torch.clamp(cnt, min=1)
        p99 = _lerp_quantile(torch.flip(head.T, dims=(-1,)), cnt, 99.0,
                             descending=True)
        return state_out, mean, p99

    def scan(draws, state, consts, rate, size):
        z, u_s, u_r, u_f = tick_noise(draws.tick_bits(T, N))
        state_out, ys = fleet_scan(state, consts, rate, size, z, u_s, u_r,
                                   u_f, active, **kw)
        n_s = torch.clamp(ys[2].to(torch.int32), 1, _MAX_LAT_SAMPLES)
        mean, p99, _ = _scan_summary(draws, T, ys, wmask, n_s, consts[0])
        return state_out, mean, p99

    return kern, scan


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def window_impl_timings(N: int, T: int = 32, reps: int = 5, device=None):
    """Interleaved median wall times of the two window implementations'
    divergent halves (``_probe_window_fns``) at N's fleet-size bucket on
    ``device`` (None: the card). Returns ``({"kernel": s, "scan": s},
    Nb)``. Each timed call is fenced by a synchronize; the reps alternate
    kernel and scan, so a drift of the clock or the host hits both
    alike."""
    import time

    from repro_torch.kernels.fleet_tick import CONSTS_ROWS
    from repro_torch.utils import resolve_device

    device = resolve_device(device, "window_impl_timings")
    Nb = _bucket(max(int(N), 1))
    rng = np.random.default_rng(0)
    f32 = dict(dtype=torch.float32, device=device)
    rows = np.tile(np.array([8.0, 1e4, 2e-5, 2e-6, 1e-9, 0.1, 0.05, 3.0,
                             0.0, 0.02, 16.0], np.float32)[:, None], (1, Nb))
    consts = torch.as_tensor(np.vstack([rows, np.zeros(
        (CONSTS_ROWS - rows.shape[0], Nb), np.float32)]), **f32)
    state = torch.zeros((2, Nb), **f32)
    rate = torch.as_tensor(rng.uniform(50.0, 500.0, (T, Nb)), **f32)
    size = torch.as_tensor(rng.uniform(0.5, 2.0, (T, Nb)), **f32)
    kern, scan = _probe_window_fns(T, Nb, device)
    fns = (("kernel", kern), ("scan", scan))
    draws = PhiloxDraws(7, device)
    for _, fn in fns:          # builds the kernels, warms the allocator
        fn(draws, state, consts, rate, size)
    _sync(device)
    ts: dict = {"kernel": [], "scan": []}
    for _ in range(reps):
        for name, fn in fns:
            t0 = time.perf_counter()
            fn(draws, state, consts, rate, size)
            _sync(device)
            ts[name].append(time.perf_counter() - t0)
    return {name: float(np.median(v)) for name, v in ts.items()}, Nb


def calibrate_window_impl(N: int, T: int = 32, reps: int = 5, device=None):
    """Measure the probe at N's bucket, cache the verdict for the process
    and return ``(verdict, timings)``: the verdict and its timings are the
    same sample."""
    from repro_torch.utils import resolve_device

    device = resolve_device(device, "calibrate_window_impl")
    timings, _ = window_impl_timings(N, T, reps, device=device)
    best = "kernel" if timings["kernel"] <= timings["scan"] else "scan"
    _IMPL_CACHE[(device.type, _bucket(max(int(N), 1)))] = best
    return best, timings


def preferred_window_impl(N: int, T: int = 32, reps: int = 5,
                          device=None) -> str:
    """The window implementation for an N-cluster fleet on ``device``:
    ``"kernel"`` (fleet_tick) or ``"scan"`` (fleet_scan). One timed probe
    per (device type, fleet-size bucket), cached for the process.
    ``REPRO_FLEET_IMPL=pallas|scan`` overrides it without measuring
    (``pallas``, the reference's name, and ``kernel`` mean ``"kernel"``);
    any other value falls through to the probe."""
    import os

    from repro_torch.utils import resolve_device

    override = os.environ.get("REPRO_FLEET_IMPL", "")
    if override in ("pallas", "kernel"):
        return "kernel"
    if override == "scan":
        return "scan"
    device = resolve_device(device, "preferred_window_impl")
    hit = _IMPL_CACHE.get((device.type, _bucket(max(int(N), 1))))
    if hit is not None:
        return hit
    return calibrate_window_impl(N, T, reps, device=device)[0]
