"""Streaming workload generators (paper §2.1, §4.4).

Event arrival processes:

* ``PoissonWorkload``     — Poisson(λ) arrivals; event sizes ~ Gaussian(mean, sd)
                            (paper §4.4: λ1=10k ev/s @0.5 MB, λ2=100k ev/s @5 MB).
* ``TrapezoidWorkload``   — ramp-up / plateau / ramp-down (classic trapezoidal).
* ``YahooAdsWorkload``    — Yahoo streaming-benchmark-like ad events [11]:
                            campaign-keyed small JSON events, diurnal modulation,
                            ~17k ev/s at the paper's 26-node setting.
* ``IoTWorkload``         — consumer-IoT-like trace: many tiny heartbeats +
                            bursty firmware/telemetry fan-ins (lognormal bursts).
* ``SwitchingWorkload``   — alternates between two workloads every
                            ``period_s`` (paper §4.5 rate-switch experiments).

All generators are deterministic given (seed, window index) so SimCluster
re-runs are reproducible; they expose ``rate(t)`` (ev/s) and ``mean_size(t)``
(MB) — the queueing model consumes those — plus ``sample_events`` for the
real LocalEngine, which needs concrete arrival timestamps.

``rate``/``mean_size`` are *time-vectorised*: ``t`` may be a python float
(float out), an ``np.ndarray`` or a ``torch.Tensor`` (matching array
out). The device-resident fleet engine (DESIGN.md §9) leans on this to
evaluate a whole exploration window's (ticks × clusters) rate grid in one
call per workload instead of one python call per tick.

**Device packing (DESIGN.md §11).** The fused training loop cannot call
python ``rate()`` per tick, so workloads whose rate law is a closed-form
function of time expose a *device leaf*: a small integer kind code plus a
fixed-width parameter row, with the rate law itself a ``device_rate``
staticmethod shared between the instance ``rate()`` (numpy) and the traced
device evaluator (``repro_torch.engine.fleet_torch.workload_rate_grid``
evaluates every leaf law and selects by kind code). ``SwitchingWorkload``
packs as TWO leaf slots plus its period — the regime flip is evaluated on
device from the carried clock. ``pack_device_workloads`` compiles an
N-cluster fleet into one ``DeviceWorkloadTable`` of ``(N,)``/``(N, P)``
columns, mirroring how ``DeviceLeverTable`` packs the lever space.
``IoTWorkload`` is not packable (its burst schedule is a 512-entry
precomputed host array); ``device_workload_reason`` names the offender so
``DeviceEpisodeRunner.supported`` can report it.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

#: parameter columns per device-leaf row (max over the leaf kinds; unused
#: trailing columns are zero)
DEVICE_LEAF_PARAMS = 4


def _np_of(t):
    """Array namespace for ``t``: the port's torch shim (``repro_torch.utils
    .txp``) for torch tensors, numpy otherwise.

    Keeps the workload maths a single implementation that is simultaneously
    float-exact for the numpy oracle and runs on torch tensors on the card."""
    if type(t) is float or isinstance(t, (np.ndarray, np.generic)):
        return np
    import torch

    if isinstance(t, torch.Tensor):
        from repro_torch.utils import txp

        return txp
    return np


def _scalar_in(t) -> bool:
    return np.ndim(t) == 0 and _np_of(t) is np


def _const_like(t, value: float):
    """``value`` broadcast to ``t``'s shape (float for scalar ``t``)."""
    if _scalar_in(t):
        return float(value)
    return _np_of(t).asarray(t) * 0.0 + value


@dataclass
class Event:
    arrival_s: float
    size_mb: float
    key: int = 0           # e.g. ad-campaign id / device id
    tokens: int = 32       # LM-engine cost proxy for the event payload


class Workload:
    name = "base"

    #: device-leaf kind code (the selector ``repro_torch.engine.fleet_torch
    #: .workload_rate_grid`` picks each cluster's law by); None = not packable
    DEVICE_KIND: Optional[int] = None

    def rate(self, t):  # events / second; t scalar or (…,) time array
        raise NotImplementedError

    def mean_size(self, t):  # MB; t scalar or (…,) time array
        return _const_like(t, 0.5)

    def device_leaf(self) -> Optional[tuple[int, list, float]]:
        """(kind_code, params row, mean event size MB) when this workload's
        rate law is closed-form in time (device-packable); None otherwise."""
        if self.DEVICE_KIND is None:
            return None
        return (self.DEVICE_KIND, self._device_params(),
                float(self.mean_size(0.0)))

    def _device_params(self) -> list:  # pragma: no cover - leaf override
        raise NotImplementedError

    def sample_events(self, t0: float, t1: float, rng: np.random.Generator,
                      max_events: int = 200_000) -> list[Event]:
        """Thinned Poisson sampling over [t0, t1) at the (possibly varying) rate."""
        lam_max = max(self.rate(t) for t in np.linspace(t0, t1, 16)) + 1e-9
        n = int(min(rng.poisson(lam_max * (t1 - t0)), max_events))
        ts = np.sort(rng.uniform(t0, t1, n))
        keep = rng.uniform(0, 1, n) < np.array([self.rate(t) for t in ts]) / lam_max
        ts = ts[keep]
        sizes = np.maximum(rng.normal(
            [self.mean_size(t) for t in ts],
            0.3 * np.array([self.mean_size(t) for t in ts])), 0.01)
        return [Event(float(t), float(s), key=int(k), tokens=max(8, int(s * 64)))
                for t, s, k in zip(ts, sizes, rng.integers(0, 1000, len(ts)))]


@dataclass
class PoissonWorkload(Workload):
    lam: float = 10_000.0         # events / s
    event_size_mb: float = 0.5    # Gaussian mean (sd = 0.3·mean, paper §4.4)
    name: str = "poisson"

    # time-invariant rate/size: lets the fleet sim hoist rate() out of the
    # per-tick loop (repro_torch.engine.simcluster.FleetCore.observe_fleet)
    constant = True
    DEVICE_KIND = 0

    @staticmethod
    def device_rate(p, t, xp=np):
        """rate(t) from a packed parameter row (shared host/device law)."""
        return p[..., 0] + 0.0 * t

    def _device_params(self) -> list:
        return [self.lam]

    def rate(self, t):
        return _const_like(t, self.lam)

    def mean_size(self, t):
        return _const_like(t, self.event_size_mb)


@dataclass
class TrapezoidWorkload(Workload):
    peak: float = 50_000.0
    ramp_s: float = 600.0
    plateau_s: float = 1800.0
    base: float = 2_000.0
    event_size_mb: float = 0.5
    name: str = "trapezoid"

    DEVICE_KIND = 1

    @staticmethod
    def device_rate(p, t, xp=np):
        """Ramp/plateau/ramp rate law from a packed [base, peak, ramp_s,
        plateau_s] row — ONE implementation for the numpy oracle and the
        traced device grid (DESIGN.md §11)."""
        base, peak, ramp, plateau = (p[..., i] for i in range(4))
        u = t % (2.0 * ramp + plateau)
        up = base + (peak - base) * u / ramp
        down = peak - (peak - base) * (u - ramp - plateau) / ramp
        return xp.where(u < ramp, up, xp.where(u < ramp + plateau, peak, down))

    def _device_params(self) -> list:
        return [self.base, self.peak, self.ramp_s, self.plateau_s]

    def rate(self, t):
        xp = _np_of(t)
        r = self.device_rate(np.asarray(self._device_params()),
                             xp.asarray(t), xp)
        return float(r) if _scalar_in(t) else r

    def mean_size(self, t):
        return _const_like(t, self.event_size_mb)


@dataclass
class YahooAdsWorkload(Workload):
    """Ad-analytics pipeline events (view/click/purchase), diurnal modulation."""

    base_rate: float = 17_000.0
    diurnal_amp: float = 0.3
    day_s: float = 3600.0          # compressed 'day' for simulation
    event_size_mb: float = 0.001   # small JSON events
    n_campaigns: int = 100
    name: str = "yahoo_ads"

    DEVICE_KIND = 2

    @staticmethod
    def device_rate(p, t, xp=np):
        """Diurnal sine law from a packed [base_rate, amp, day_s] row."""
        return p[..., 0] * (1.0 + p[..., 1]
                            * xp.sin(2.0 * np.pi * t / p[..., 2]))

    def _device_params(self) -> list:
        return [self.base_rate, self.diurnal_amp, self.day_s]

    def rate(self, t):
        xp = _np_of(t)
        r = self.device_rate(np.asarray(self._device_params()),
                             xp.asarray(t), xp)
        return float(r) if _scalar_in(t) else r

    def mean_size(self, t):
        return _const_like(t, self.event_size_mb)


@dataclass
class IoTWorkload(Workload):
    """Consumer-device fleet: heartbeats + lognormal telemetry bursts."""

    fleet: int = 200_000
    heartbeat_s: float = 30.0
    burst_rate: float = 0.02       # bursts / s
    burst_scale: float = 40_000.0  # events per burst (lognormal median)
    event_size_mb: float = 0.05
    seed: int = 7
    name: str = "iot"

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._burst_times = np.cumsum(rng.exponential(1 / self.burst_rate, 512))
        self._burst_sizes = rng.lognormal(np.log(self.burst_scale), 0.8, 512)

    def rate(self, t):
        xp = _np_of(t)
        base = self.fleet / self.heartbeat_s
        # each burst drains over ~60 s; vectorised over both t and the burst
        # schedule ((…, 512) mask against the precomputed burst arrays)
        dt = xp.asarray(t)[..., None] - self._burst_times
        active = (dt >= 0) & (dt < 60.0)
        burst = xp.sum(xp.where(active, self._burst_sizes / 60.0, 0.0), axis=-1)
        return float(base + burst) if _scalar_in(t) else base + burst

    def mean_size(self, t):
        return _const_like(t, self.event_size_mb)


@dataclass
class SwitchingWorkload(Workload):
    """Alternate a/b every period_s (paper §4.4/§4.5: λ1 <-> λ2 switches)."""

    a: Workload = dataclasses.field(default_factory=lambda: PoissonWorkload(10_000, 0.5))
    b: Workload = dataclasses.field(default_factory=lambda: PoissonWorkload(100_000, 5.0))
    period_s: float = 3600.0
    name: str = "switching"

    def active(self, t: float) -> Workload:
        return self.a if int(t // self.period_s) % 2 == 0 else self.b

    def _is_a(self, t):
        return (_np_of(t).asarray(t) // self.period_s) % 2 == 0

    def rate(self, t):
        if _scalar_in(t):
            return self.active(float(t)).rate(float(t))
        return _np_of(t).where(self._is_a(t), self.a.rate(t), self.b.rate(t))

    def mean_size(self, t):
        if _scalar_in(t):
            return self.active(float(t)).mean_size(float(t))
        return _np_of(t).where(self._is_a(t), self.a.mean_size(t),
                               self.b.mean_size(t))

    def device_slots(self) -> Optional[tuple]:
        """(leaf_a, leaf_b, period_s) when both members are device leaves —
        the regime flip itself runs on device (``(t // period) % 2`` on the
        carried clock, matching ``_is_a`` exactly)."""
        la, lb = self.a.device_leaf(), self.b.device_leaf()
        if la is None or lb is None:
            return None
        return la, lb, float(self.period_s)


# --------------------------------------------------------------------------
# device workload tables (DESIGN.md §11)
# --------------------------------------------------------------------------

#: kind code -> leaf class; ``workload_rate_grid`` evaluates each class's
#: law and selects by code, so codes must be dense from 0.
DEVICE_LEAF_CLASSES: dict[int, type] = {
    PoissonWorkload.DEVICE_KIND: PoissonWorkload,
    TrapezoidWorkload.DEVICE_KIND: TrapezoidWorkload,
    YahooAdsWorkload.DEVICE_KIND: YahooAdsWorkload,
}


@dataclass
class DeviceWorkloadTable:
    """An N-cluster fleet's workloads packed into per-cluster parameter
    columns — the arrival-process twin of ``DeviceLeverTable``. Two leaf
    slots per cluster: non-switching workloads fill slot A and set
    ``period_s = inf`` (``t // inf == 0`` keeps slot A active forever);
    ``SwitchingWorkload`` fills both slots. Kind codes index the shared
    ``device_rate`` branch table (``DEVICE_LEAF_CLASSES``)."""

    kind_a: np.ndarray    # (N,) int32 leaf kind codes
    params_a: np.ndarray  # (N, DEVICE_LEAF_PARAMS) f32
    size_a: np.ndarray    # (N,) f32 mean event size, MB
    kind_b: np.ndarray    # (N,) slot B (== slot A when the cluster never switches)
    params_b: np.ndarray
    size_b: np.ndarray
    period_s: np.ndarray  # (N,) f32; +inf => slot A only

    def asdict(self) -> dict[str, np.ndarray]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def rates(self, t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Numpy reference evaluation at ``t`` of shape (..., N) — the host
        twin of ``repro_torch.engine.fleet_torch.workload_rate_grid``, used by the
        regression tests that pin the table against ``Workload.rate``."""
        t = np.asarray(t, float)
        ra = _eval_leaf_np(self.kind_a, self.params_a, t)
        rb = _eval_leaf_np(self.kind_b, self.params_b, t)
        use_a = (t // self.period_s) % 2.0 < 0.5
        return (np.where(use_a, ra, rb),
                np.where(use_a, self.size_a, self.size_b))


def _eval_leaf_np(kind: np.ndarray, params: np.ndarray,
                  t: np.ndarray) -> np.ndarray:
    out = np.zeros(np.broadcast_shapes(t.shape, kind.shape), float)
    for code, cls in DEVICE_LEAF_CLASSES.items():
        with np.errstate(invalid="ignore", divide="ignore"):
            r = cls.device_rate(params, t, np)   # rows of other kinds: junk
        out = np.where(kind == code, r, out)
    return out


def device_workload_reason(workloads: Sequence[Workload]) -> Optional[str]:
    """None when every workload packs into a ``DeviceWorkloadTable``;
    otherwise which cluster blocks it and why (the ``supported()`` string)."""
    for i, w in enumerate(workloads):
        if isinstance(w, SwitchingWorkload):
            if w.device_slots() is None:
                return (f"cluster {i}: switching members "
                        f"({w.a.name}/{w.b.name}) are not device leaves")
        elif w.device_leaf() is None:
            return f"cluster {i}: workload {w.name!r} has no device rate law"
    return None


def pack_device_workloads(workloads: Sequence[Workload]) -> DeviceWorkloadTable:
    reason = device_workload_reason(workloads)
    if reason is not None:
        raise ValueError(reason)
    n = len(workloads)
    P = DEVICE_LEAF_PARAMS
    kind = np.zeros((2, n), np.int32)
    params = np.zeros((2, n, P), np.float32)
    size = np.zeros((2, n), np.float32)
    period = np.full(n, np.inf, np.float32)
    for i, w in enumerate(workloads):
        if isinstance(w, SwitchingWorkload):
            (ka, pa, sa), (kb, pb, sb), period[i] = w.device_slots()
            slots = ((ka, pa, sa), (kb, pb, sb))
        else:
            leaf = w.device_leaf()
            slots = (leaf, leaf)
        for s, (k, p, sz) in enumerate(slots):
            kind[s, i] = k
            params[s, i, :len(p)] = p
            size[s, i] = sz
    return DeviceWorkloadTable(kind[0], params[0], size[0],
                               kind[1], params[1], size[1], period)


#: Default roster used to build heterogeneous fleets: a spread of steady,
#: diurnal, bursty and regime-switching arrival processes (paper §4.4/§4.5).
FLEET_MIX: tuple = ("poisson_low", "trapezoid", "yahoo_ads", "iot",
                    "switching", "poisson_high")


def fleet_workloads(n: int, *, seed: int = 0,
                    mix: Optional[Sequence[str]] = None) -> list[Workload]:
    """Deterministic heterogeneous workload roster for an N-cluster fleet.

    Cluster ``i`` gets ``mix[i % len(mix)]``; stochastic generators (IoT) are
    seeded ``seed + i`` so the roster is fully determined by ``(n, seed, mix)``
    — replicating a fleet replays the exact same arrival processes, which is
    what makes fleet runs reproducible window-for-window (tests/test_fleet.py).

    Note for pooled analysis (AutoTuner over one fleet): cluster identity is
    an unmodelled covariate in the Lasso, so mixing wildly different rate
    scales (poisson_high's λ2=100k ev/s next to ads traffic) dilutes lever
    recovery; pass a ``mix`` of comparable scales or spend a bigger collect
    budget when the full roster is used.
    """
    roster = tuple(mix) if mix is not None else FLEET_MIX
    out: list[Workload] = []
    for i in range(n):
        name = roster[i % len(roster)]
        kw = {"seed": seed + i} if name == "iot" else {}
        out.append(get_workload(name, **kw))
    return out


def get_workload(name: str, **kw) -> Workload:
    table = {
        "poisson": PoissonWorkload,
        "poisson_low": lambda **k: PoissonWorkload(10_000, 0.5, **k),
        "poisson_high": lambda **k: PoissonWorkload(100_000, 5.0, **k),
        "trapezoid": TrapezoidWorkload,
        "yahoo_ads": YahooAdsWorkload,
        "iot": IoTWorkload,
        "switching": SwitchingWorkload,
    }
    wl = table[name](**kw)
    return wl
