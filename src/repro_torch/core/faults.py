"""Chaos event tables: device-expressible fault scenarios (DESIGN.md §12).

The paper tunes *under pre-agreed service quality metrics* — the interesting
regime is degraded conditions, not steady load. This module packs per-cluster
fault scenarios into the same kind-coded table shape as
``DeviceWorkloadTable`` (repro_torch.data.workloads) so the fused device
loop can evaluate them on the device, selected by kind code, while the
numpy oracle replays the exact same closed-form laws. The port's copy of
``repro.core.faults``: numpy only, bitwise the reference's.

Fault kinds (dense codes — the device grid selects its law by code):

* 0 ``NoFault``          — padding slot; identity on everything.
* 1 ``StragglerFault``   — service slowdown ×mult during [t0, t0+dur).
* 2 ``FailureFault``     — correlated cluster failure: service ×mult during
                           the outage, then a linear restart tail decaying
                           mult→1 over the following dur/2 (nodes rejoin and
                           catch up). Correlation across clusters is
                           expressed by giving a group identical (t0, dur).
* 3 ``BacklogShockFault``— arrival-rate ×mult during [t0, t0+dur) (an
                           upstream replay / redirected traffic spike).
* 4 ``DeployLatencyFault``— lever deploy latency: configs take effect
                           ``delay_windows`` windows late (paper §4.4's
                           stabilisation discussion). No per-tick effect —
                           the fused episode scan consumes it as a config
                           index history depth (``max_deploy_delay``).

Every kind's law is ONE ``device_effect(p, t, xp)`` staticmethod returning a
``(service_mult, rate_mult)`` pair, shared between the numpy oracle
(``DeviceFaultTable.effects``) and the device grid
(``repro_torch.engine.fleet_torch.fault_effect_grid``). A cluster carries up to
``n_events`` slots (padded with kind 0); concurrent events compose
multiplicatively. Multiplication by the padding slots' exact ``1.0`` is
bit-exact in f32, so an all-``NoFault`` table is a no-op on the fused window
— pinned by tests/test_torch_faults.py.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

#: parameter columns per fault-event row (max over the kinds; unused trailing
#: columns are zero)
FAULT_PARAMS = 4


def _ones_like(t, xp):
    return xp.asarray(t) * 0.0 + 1.0


@dataclass
class NoFault:
    """Padding slot: identity on service and arrivals."""

    KIND = 0

    @staticmethod
    def device_effect(p, t, xp=np):
        one = _ones_like(t, xp)
        return one, one

    def _device_params(self) -> list:
        return []

    @classmethod
    def _from_params(cls, p) -> "NoFault":
        return cls()


@dataclass
class StragglerFault:
    """Sustained straggler: service slowed ×``slow_mult`` during the window
    (a hot node, a noisy neighbour, a degraded disk)."""

    t0_s: float = 0.0
    duration_s: float = 0.0
    slow_mult: float = 2.0

    KIND = 1

    @staticmethod
    def device_effect(p, t, xp=np):
        on = (t >= p[..., 0]) & (t < p[..., 0] + p[..., 1])
        return xp.where(on, p[..., 2], 1.0), _ones_like(t, xp)

    def _device_params(self) -> list:
        return [self.t0_s, self.duration_s, self.slow_mult]

    @classmethod
    def _from_params(cls, p) -> "StragglerFault":
        return cls(float(p[0]), float(p[1]), float(p[2]))


@dataclass
class FailureFault:
    """Correlated cluster failure: service ×``slow_mult`` during
    [t0, t0+dur), then a linear restart tail (mult → 1 over dur/2) as the
    failed nodes rejoin. Give several clusters identical (t0, duration) to
    model a correlated (rack / AZ) outage."""

    t0_s: float = 0.0
    duration_s: float = 0.0
    slow_mult: float = 4.0

    KIND = 2

    @staticmethod
    def device_effect(p, t, xp=np):
        t0, dur, mult = p[..., 0], p[..., 1], p[..., 2]
        end = t0 + dur
        tail = xp.maximum(0.5 * dur, 1e-9)
        frac = xp.clip((t - end) / tail, 0.0, 1.0)   # 0 at outage end -> 1
        decay = mult + (1.0 - mult) * frac
        out = xp.where((t >= t0) & (t < end), mult,
                       xp.where((t >= end) & (t < end + tail), decay, 1.0))
        return out, _ones_like(t, xp)

    def _device_params(self) -> list:
        return [self.t0_s, self.duration_s, self.slow_mult]

    @classmethod
    def _from_params(cls, p) -> "FailureFault":
        return cls(float(p[0]), float(p[1]), float(p[2]))


@dataclass
class BacklogShockFault:
    """Arrival-rate shock: arrivals ×``rate_mult`` during [t0, t0+dur) — an
    upstream replay, a failed-over partner cluster's traffic."""

    t0_s: float = 0.0
    duration_s: float = 0.0
    rate_mult: float = 3.0

    KIND = 3

    @staticmethod
    def device_effect(p, t, xp=np):
        on = (t >= p[..., 0]) & (t < p[..., 0] + p[..., 1])
        return _ones_like(t, xp), xp.where(on, p[..., 2], 1.0)

    def _device_params(self) -> list:
        return [self.t0_s, self.duration_s, self.rate_mult]

    @classmethod
    def _from_params(cls, p) -> "BacklogShockFault":
        return cls(float(p[0]), float(p[1]), float(p[2]))


@dataclass
class DeployLatencyFault:
    """Lever deploy latency: a cluster's config changes take effect
    ``delay_windows`` tuning windows late (rolling restarts, slow control
    planes — paper §4.4). No per-tick effect; the fused episode scan reads
    the table's ``max_deploy_delay`` and routes the environment's config
    through a carried index history while the policy still observes what it
    requested."""

    delay_windows: int = 1

    KIND = 4

    @staticmethod
    def device_effect(p, t, xp=np):
        one = _ones_like(t, xp)
        return one, one

    def _device_params(self) -> list:
        return [float(self.delay_windows)]

    @classmethod
    def _from_params(cls, p) -> "DeployLatencyFault":
        return cls(int(round(float(p[0]))))


#: kind code -> fault class; ``fault_effect_grid`` evaluates the kinds
#: in code order and selects by code, so codes must be dense from 0.
FAULT_KIND_CLASSES: dict[int, type] = {
    NoFault.KIND: NoFault,
    StragglerFault.KIND: StragglerFault,
    FailureFault.KIND: FailureFault,
    BacklogShockFault.KIND: BacklogShockFault,
    DeployLatencyFault.KIND: DeployLatencyFault,
}

#: host spec classes accepted by ``pack_device_faults``
FAULT_SPEC_CLASSES = tuple(FAULT_KIND_CLASSES.values())


@dataclass
class DeviceFaultTable:
    """An N-cluster fleet's chaos events packed into kind-coded per-cluster
    columns — the fault twin of ``DeviceWorkloadTable``. ``kind[i, e]`` is
    event slot ``e`` of cluster ``i`` (0 = padding); concurrent events
    compose multiplicatively."""

    kind: np.ndarray    # (N, E) int32 fault kind codes
    params: np.ndarray  # (N, E, FAULT_PARAMS) f32

    @property
    def n_clusters(self) -> int:
        return int(self.kind.shape[0])

    @property
    def n_events(self) -> int:
        return int(self.kind.shape[1])

    def asdict(self) -> dict[str, np.ndarray]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def effects(self, t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Numpy reference evaluation at ``t`` of shape (..., N): the host
        twin of ``repro_torch.engine.fleet_torch.fault_effect_grid``. Returns
        ``(service_mult, rate_mult)`` broadcast to ``t``'s shape."""
        t = np.asarray(t, float)
        shape = np.broadcast_shapes(t.shape, self.kind[..., 0].shape)
        slow = np.ones(shape, float)
        rate = np.ones(shape, float)
        for e in range(self.n_events):
            s, r = _eval_fault_np(self.kind[:, e], self.params[:, e], t)
            slow = slow * s
            rate = rate * r
        return slow, rate

    def max_deploy_delay(self) -> int:
        """Largest ``delay_windows`` over the fleet's DeployLatency events —
        the config-history depth the fused episode scan must carry."""
        mask = self.kind == DeployLatencyFault.KIND
        if not mask.any():
            return 0
        return int(np.max(np.round(self.params[..., 0][mask])))

    def deploy_delays(self) -> np.ndarray:
        """(N,) int32 per-cluster deploy delay in windows (0 = immediate).
        Multiple DeployLatency events on one cluster take the max."""
        d = np.where(self.kind == DeployLatencyFault.KIND,
                     np.round(self.params[..., 0]), 0.0)
        return d.max(axis=1).astype(np.int32)

    def has_tick_effects(self) -> bool:
        """Whether any event perturbs the per-tick dynamics (anything other
        than padding / deploy latency). False => the rate/service grids are
        untouched and the window programs run exactly as without faults."""
        return bool(np.any((self.kind != NoFault.KIND)
                           & (self.kind != DeployLatencyFault.KIND)))


def _eval_fault_np(kind: np.ndarray, params: np.ndarray,
                   t: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    shape = np.broadcast_shapes(t.shape, kind.shape)
    slow = np.ones(shape, float)
    rate = np.ones(shape, float)
    for code, cls in FAULT_KIND_CLASSES.items():
        with np.errstate(invalid="ignore", divide="ignore"):
            s, r = cls.device_effect(params, t, np)  # rows of other kinds: junk
        slow = np.where(kind == code, s, slow)
        rate = np.where(kind == code, r, rate)
    return slow, rate


def pack_device_faults(events: Sequence[Sequence],
                       n_events: Optional[int] = None) -> DeviceFaultTable:
    """Compile per-cluster fault spec lists into one ``DeviceFaultTable``.

    ``events[i]`` is cluster ``i``'s list of fault spec objects (any of
    ``FAULT_SPEC_CLASSES``); rows are padded with ``NoFault`` to the widest
    cluster (or ``n_events`` when given)."""
    n = len(events)
    width = max([len(ev) for ev in events] + [1])
    if n_events is not None:
        if n_events < width:
            raise ValueError(f"n_events={n_events} < widest cluster ({width})")
        width = n_events
    kind = np.zeros((n, width), np.int32)
    params = np.zeros((n, width, FAULT_PARAMS), np.float32)
    for i, evs in enumerate(events):
        for e, spec in enumerate(evs):
            if not isinstance(spec, FAULT_SPEC_CLASSES):
                raise ValueError(
                    f"cluster {i}: {type(spec).__name__} is not a fault spec")
            p = spec._device_params()
            kind[i, e] = spec.KIND
            params[i, e, :len(p)] = p
    return DeviceFaultTable(kind, params)


def unpack_device_faults(table: DeviceFaultTable) -> list[list]:
    """Table -> per-cluster spec lists (padding slots dropped). Values come
    back f32-rounded, so ``pack(unpack(pack(x)))`` equals ``pack(x)``
    bit-for-bit — the round-trip law the property tests pin."""
    out: list[list] = []
    for i in range(table.n_clusters):
        row = []
        for e in range(table.n_events):
            code = int(table.kind[i, e])
            if code == NoFault.KIND:
                continue
            row.append(FAULT_KIND_CLASSES[code]._from_params(table.params[i, e]))
        out.append(row)
    return out


def no_faults(n: int, n_events: int = 1) -> DeviceFaultTable:
    """An all-padding table for an N-cluster fleet (identity scenario)."""
    return DeviceFaultTable(np.zeros((n, n_events), np.int32),
                            np.zeros((n, n_events, FAULT_PARAMS), np.float32))


def chaos_scenario(n: int, *, t0_s: float = 600.0, duration_s: float = 240.0,
                   fail_frac: float = 0.25, shock_mult: float = 2.5,
                   slow_mult: float = 4.0, deploy_delay: int = 0,
                   seed: int = 0) -> DeviceFaultTable:
    """A canonical mixed scenario for benchmarks and examples: a correlated
    failure hits the first ``fail_frac`` of the fleet at ``t0_s`` (identical
    event times — one 'rack'), a backlog shock hits the next quarter, a
    sustained straggler the quarter after, and (optionally) every cluster
    deploys configs ``deploy_delay`` windows late."""
    rng = np.random.default_rng(seed)
    events: list[list] = [[] for _ in range(n)]
    n_fail = max(1, int(round(fail_frac * n)))
    n_quarter = max(1, n // 4)
    for i in range(n):
        if i < n_fail:
            events[i].append(FailureFault(t0_s, duration_s, slow_mult))
        elif i < n_fail + n_quarter:
            events[i].append(BacklogShockFault(
                t0_s + float(rng.uniform(0, 60.0)), duration_s, shock_mult))
        elif i < n_fail + 2 * n_quarter:
            events[i].append(StragglerFault(
                t0_s + float(rng.uniform(0, 60.0)), 2.0 * duration_s, 2.0))
        if deploy_delay > 0:
            events[i].append(DeployLatencyFault(deploy_delay))
    return pack_device_faults(events)
