"""SimCluster: analytic queueing/roofline model of the streaming engine on a
TPU v5e slice (DESIGN.md §2) — the large-scale ``TuningEnv``.

Why a simulator: the paper trains on 80 EC2 clusters; this container has one
CPU. The sim replaces EC2 wall-clock with a simulated clock, but keeps the
tuner-facing API identical to the real ``LocalEngine`` (same lever specs,
same 90 metrics, same latency-based reward), and its service-time model uses
the same three roofline terms (compute / memory / collective seconds) the
dry-run reports for the real models.

Performance model per micro-batch (batch interval T_b, a lever):

  service = t_overhead + t_compute · mem_penalty + t_collective
  t_compute    ~ batch_tokens · c_tok / (chips · peak · eff)
  mem_penalty  ~ 1 + spill cliff once the KV/working set overflows HBM
  t_collective ~ tp-dependent per-token collective bytes / ICI, reduced by
                 compression and microbatch overlap
  t_overhead   ~ dispatch + driver stalls (driver memory / allocator / GC
                 analogue), reduced by prefetch

Queueing: batches tick every T_b; arrivals λ(t)·T_b join a backlog (Kafka);
utilisation ρ = service/T_b; backlog drains at the spare capacity. Event
latency = batching wait + queue delay + service (+ straggler / failure
tails). ~17 of the 109 levers move these terms (engine/levers.py EFFECTIVE);
the rest are inert — Lasso must recover the distinction.

Fleet-parallel form (DESIGN.md §2a): the paper explores lever space on ~80
EC2 clusters in parallel, so the whole performance/queueing model here is
written *array-over-clusters*: every state variable is an ``(N,)`` array and
every model term is computed for all N clusters in one vectorised pass
(``pack_configs`` / ``service_terms_arrays`` / ``FleetCore``);
``repro_torch.engine.fleet.FleetEnv`` is the N>1 batched env.

Device-resident form (DESIGN.md §9): ``FleetCore`` steps every observation
window through ``repro_torch.engine.fleet_torch``'s ``DeviceFleetEngine``,
one launch of a hand-written CUDA kernel: ``fleet_tick``
(``repro_torch.kernels.fleet_tick``) or, under ``window_impl="scan"``, the
lane-free ``fleet_scan`` (``repro_torch.kernels.fleet_scan``); their plain
torch versions on CPU tensors. The reference's numpy tick loop is not copied: it stays the
oracle in ``repro.engine.simcluster``. ``service_terms_arrays`` runs on
numpy arrays (stabilisation, the allow-list) and, through its ``xp``
namespace parameter (``xp=repro_torch.utils.txp``), on torch tensors.

``SimCluster`` is the serial ``TuningEnv``: the N=1 view over
``FleetCore``, so every apply, stabilisation wait and window runs through
the same code (and the same ``fleet_tick`` launch) as a fleet of one.

This module is the port's copy of the parts of ``repro.engine.simcluster``
the torch engine uses: every numpy formula is kept bitwise-identical to the
reference (tests/test_torch_copies.py pins it).
"""
from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.discretize import LeverSpec
from repro_torch.data.workloads import Workload
from repro_torch.monitoring.metrics import FACTORS, REGISTRY

PEAK_FLOPS = 197e12
TOKENS_PER_MB = 16.0

# Categorical lever -> performance-model factor tables (DESIGN.md §2).
_REMAT_FACTOR = {"none": 1.0, "block": 1.12, "full": 1.35}
_KV_BLOCK_PRESSURE = {64: 0.28, 128: 0.18, 256: 0.22, 512: 0.3}
_TP_COMPUTE = {4: 1.18, 8: 1.06, 16: 1.0, 32: 1.07}
_GRAD_COMPRESSION = {"int8": 0.55, "topk": 0.4}

# Cap on per-tick latency samples (events sampled per micro-batch).
_MAX_LAT_SAMPLES = 64


class LazyPerNode(Mapping):
    """Read-only metric->(n_nodes,) mapping over a dense (nodes, metrics)
    window matrix. Column views materialise on access, so consumers that
    touch a handful of the 90 metrics (the heat-map encoder reads ~7) don't
    pay for 90 eager dict entries per window."""

    __slots__ = ("_matrix", "_index")

    def __init__(self, matrix: np.ndarray, index: dict):
        self._matrix = matrix
        self._index = index

    def __getitem__(self, name: str) -> np.ndarray:
        return self._matrix[:, self._index[name]]

    def __iter__(self):
        return iter(self._index)

    def __len__(self) -> int:
        return len(self._index)


@dataclass
class MetricsWindowData:
    per_node: Mapping
    latencies_ms: np.ndarray
    p99_ms: float
    clock_s: float
    # (n_nodes, n_metrics) window average in registry order — the dense twin
    # of per_node, letting consumers reduce all 90 metrics in one array op
    # instead of 90 dict lookups (None for envs that don't provide it)
    node_matrix: Optional[np.ndarray] = None
    # events processed during the window (true sim throughput, not the noisy
    # emitted events_per_s metric); NaN for envs that don't track it
    processed_events: float = float("nan")

    @property
    def mean_ms(self) -> float:
        return float(np.mean(self.latencies_ms)) if self.latencies_ms.size else float("nan")


@dataclass
class SimSpec:
    """Cluster geometry + calibration constants."""

    n_nodes: int = 10              # 1 driver + 9 workers (paper's clusters)
    chips_per_worker: int = 8      # v5e hosts
    base_mfu: float = 0.42         # achievable model-flops utilisation at defaults
    dispatch_overhead_s: float = 0.35
    driver_gc_coeff: float = 2.4   # driver stall ~ coeff / driver_memory_gb
    collective_frac: float = 0.18  # collective seconds as fraction of compute @ tp=16
    straggler_prob: float = 0.05
    straggler_slow: tuple = (1.5, 3.0)
    hbm_gb_per_chip: float = 16.0
    noise: float = 0.04
    retention_s: float = 300.0     # Kafka retention: oldest events age out, so
                                   # backlog (and latency) cannot grow unboundedly


# --------------------------------------------------------------------------
# Array-over-clusters performance model (DESIGN.md §2a)
# --------------------------------------------------------------------------

#: packed-array key -> scalar extractor over one config dict. Categorical
#: levers are mapped straight to their model factors so the hot path is pure
#: float arithmetic over the cluster axis. ("emit_every": paper cadence — 90
#: metrics per simulated MINUTE per node, i.e. every round(60/T_b) ticks.)
_PACKERS: dict = {
    "T_b": lambda c: float(c["batch_interval_s"]),
    "max_batch_events": lambda c: float(c["max_batch_events"]),
    "eff_block_q": lambda c: 1.0 if c["attn_block_q"] == 128 else 0.88,
    "eff_block_k": lambda c: 1.0 if c["attn_block_k"] == 128 else 0.9,
    "eff_dtype": lambda c: 1.0 if c["compute_dtype"] == "bf16" else 0.5,
    "remat": lambda c: _REMAT_FACTOR[c["remat_policy"]],
    "kv_pressure": lambda c: _KV_BLOCK_PRESSURE[int(c["kv_block"])],
    "tp": lambda c: float(int(c["model_axis_size"])),
    "tp_compute": lambda c: _TP_COMPUTE[int(c["model_axis_size"])],
    "compression": lambda c: _GRAD_COMPRESSION.get(c["grad_compression"], 1.0),
    "mb": lambda c: float(int(c["microbatch_count"])),
    "expert_parallel": lambda c: bool(c["expert_parallel"]),
    "driver_memory_gb": lambda c: float(c["driver_memory_gb"]),
    "allocator_arena_mb": lambda c: float(c["allocator_arena_mb"]),
    "sink_partitions": lambda c: float(int(c["sink_partitions"])),
    "prefetch_depth": lambda c: float(max(int(c["prefetch_depth"]), 0)),
    "backup_tasks": lambda c: bool(c["backup_tasks"]),
    "straggler_timeout_s": lambda c: float(c["straggler_timeout_s"]),
    "failure_inject_frac": lambda c: float(c["failure_inject_frac"]),
    "max_inflight_batches": lambda c: float(c["max_inflight_batches"]),
    "emit_every": lambda c: max(1, int(round(60.0 / float(c["batch_interval_s"])))),
}

#: lever name -> packed keys it feeds, for in-place single-lever updates
_LEVER_TO_PACKED: dict = {
    "batch_interval_s": ("T_b", "emit_every"),
    "max_batch_events": ("max_batch_events",),
    "attn_block_q": ("eff_block_q",),
    "attn_block_k": ("eff_block_k",),
    "compute_dtype": ("eff_dtype",),
    "remat_policy": ("remat",),
    "kv_block": ("kv_pressure",),
    "model_axis_size": ("tp", "tp_compute"),
    "grad_compression": ("compression",),
    "microbatch_count": ("mb",),
    "expert_parallel": ("expert_parallel",),
    "driver_memory_gb": ("driver_memory_gb",),
    "allocator_arena_mb": ("allocator_arena_mb",),
    "sink_partitions": ("sink_partitions",),
    "prefetch_depth": ("prefetch_depth",),
    "backup_tasks": ("backup_tasks",),
    "straggler_timeout_s": ("straggler_timeout_s",),
    "failure_inject_frac": ("failure_inject_frac",),
    "max_inflight_batches": ("max_inflight_batches",),
}


def pack_configs(configs: Sequence[dict]) -> dict[str, np.ndarray]:
    """Extract the service-model levers of N cluster configs into (N,) arrays."""
    return {k: np.array([f(c) for c in configs]) for k, f in _PACKERS.items()}


def model_constants(models: Sequence[ModelConfig]) -> dict[str, np.ndarray]:
    """Per-cluster model constants the service model consumes."""
    return {
        "flops_per_tok": np.array([2.0 * m.active_param_count() for m in models]),
        "kv_per_tok": np.array([float(m.num_layers * m.num_kv_heads
                                      * m.resolved_head_dim * 2 * 2) for m in models]),
        "is_moe": np.array([m.family == "moe" for m in models]),
    }


def service_terms_arrays(cc: dict[str, np.ndarray], mc: dict[str, np.ndarray],
                         spec: SimSpec, chips: int, rate, ev_size,
                         batch_events=None, xp=np) -> dict[str, np.ndarray]:
    """The per-micro-batch service model, vectorised over the cluster axis.

    All inputs are (N,) arrays (or scalars that broadcast); the returned terms
    are (N,) arrays. This is the single implementation both the serial
    ``SimCluster`` (N=1) and the batched ``FleetEnv`` step through, so serial
    and fleet results agree bit-for-bit. ``xp`` selects the array namespace:
    numpy (default, float64 oracle) or the port's torch shim
    (``repro_torch.utils.txp``), in which case the same formulas run on
    device tensors (DESIGN.md §9) — one implementation, two backends.
    """
    T_b = cc["T_b"]
    if batch_events is None:
        batch_events = xp.minimum(rate * T_b, cc["max_batch_events"])
    tokens = batch_events * ev_size * TOKENS_PER_MB

    # --- efficiency factors (kernel / precision / padding levers) -------
    eff = spec.base_mfu * cc["eff_block_q"] * cc["eff_block_k"] * cc["eff_dtype"]
    t_compute = tokens * mc["flops_per_tok"] * cc["remat"] / (chips * PEAK_FLOPS * eff)

    # --- memory pressure (kv block / batch size / hbm budget) -----------
    kv_gb = tokens * mc["kv_per_tok"] / 1e9
    mem_frac = xp.minimum(kv_gb / (chips * spec.hbm_gb_per_chip) + cc["kv_pressure"], 1.5)
    t_mem_penalty = 1.0 + xp.maximum(mem_frac - 1.0, 0.0) * 2.0  # spill cliff

    # --- collective term (tp size / compression / microbatch overlap) ----
    coll = spec.collective_frac * t_compute * (cc["tp"] / 16.0) ** 0.5
    coll = coll * cc["compression"]
    coll = coll / (1.0 + 0.45 * (cc["mb"] - 1.0))            # overlap with compute
    moe = mc["is_moe"] & (cc["expert_parallel"] != 0)
    t_compute = xp.where(moe, t_compute * 0.92, t_compute)   # no replicated expert FFN
    coll = xp.where(moe, coll * 1.15, coll)                  # but adds all-to-all
    # tp also trades compute efficiency (smaller per-chip matmuls)
    t_compute = t_compute * cc["tp_compute"]

    # --- overhead (dispatch / driver stalls / sink / prefetch) -----------
    ovh = spec.dispatch_overhead_s * (1.0 + 0.12 * (cc["mb"] - 1.0))
    ovh = ovh + spec.driver_gc_coeff / xp.maximum(cc["driver_memory_gb"], 1.0) * 0.1
    ovh = ovh + 0.12 * xp.maximum(
        xp.log2(512.0 / xp.maximum(cc["allocator_arena_mb"], 32.0)), 0.0)
    sink = cc["sink_partitions"]
    ovh = ovh + 0.25 / xp.maximum(sink, 1.0) + 0.004 * sink
    ovh = ovh * (0.45 + 0.55 / (1.0 + cc["prefetch_depth"]))

    service = ovh + t_compute * t_mem_penalty + coll
    zeros = xp.zeros_like(service)
    return {
        "service": service, "t_compute": t_compute * t_mem_penalty,
        "t_overhead": ovh, "t_collective": coll,
        "mem_frac": xp.minimum(mem_frac, 1.0), "eff": eff + zeros,
        "tokens": tokens + zeros, "straggler": zeros, "failure": zeros + 0.0,
    }


_EMIT_CONST: Optional[dict] = None


def _emission_constants() -> dict:
    """(factors × metrics) loading, scale, noise, bias arrays — shared by all
    clusters (the registry is a module-level constant)."""
    global _EMIT_CONST
    if _EMIT_CONST is None:
        M = len(REGISTRY)
        W = np.zeros((len(FACTORS), M))
        findex = {f: i for i, f in enumerate(FACTORS)}
        for j, m in enumerate(REGISTRY):
            for f, w in m.loading.items():
                W[findex[f], j] = w
        li = {m.name: j for j, m in enumerate(REGISTRY)}
        _EMIT_CONST = {
            "W": W,
            "scale": np.array([m.scale for m in REGISTRY]),
            "noise_v": np.array([m.noise for m in REGISTRY]),
            "bias": np.array([m.bias for m in REGISTRY]),
            "is_driver": np.array([m.scope == "driver" for m in REGISTRY]),
            "lat_cols": np.array([li["latency_mean_ms"], li["latency_p50_ms"],
                                  li["latency_p95_ms"], li["latency_p99_ms"],
                                  li["latency_max_ms"]]),
            "queue_col": li["queue_depth"],
        }
    return _EMIT_CONST


class FleetCore:
    """Array-over-clusters state + batched stepping for N simulated clusters.

    Every piece of queueing state (clock, backlog, server occupancy, reconfig
    count) is an (N,) array. Heterogeneity is free: each cluster has its own
    workload, model, config dict and RNG stream. ``FleetEnv`` exposes the
    N>1 batched environment (DESIGN.md §2a).

    The tick engine is the device-resident
    ``repro_torch.engine.fleet_torch.DeviceFleetEngine`` on ``device``
    (counter RNG; each window is one kernel launch, DESIGN.md §9).
    ``backend`` keeps the reference's keyword and takes only ``"torch"``;
    ``window_impl`` picks the window: ``"kernel"`` (the ``fleet_tick``
    kernel, the reference's ``backend="pallas"``), ``"scan"`` (the lean
    lane-free ``fleet_scan`` kernel, its ``backend="jax"``) or ``"auto"``
    (a timed choice made once, at construction); the resolved value is
    ``self.window_impl``.
    ``device=None`` resolves to ``cuda`` and raises when there is no card —
    pass ``device="cpu"`` to run the kernels' plain torch versions.
    Config management, the allow-list guard and stabilisation stay
    host-side in this class.
    """

    def __init__(self, workloads: Sequence[Workload], models: Sequence[ModelConfig],
                 spec: SimSpec, lever_specs: Sequence[LeverSpec],
                 seeds: Sequence[int], backend: str = "torch",
                 faults=None, device=None, window_impl: str = "kernel"):
        assert len(workloads) == len(models) == len(seeds)
        if backend != "torch":
            raise ValueError(f"backend={backend!r}: the port runs only the "
                             "torch engine (the numpy oracle is the "
                             "reference's repro.engine.simcluster)")
        self.n = len(workloads)
        self.backend = backend
        self.workloads = list(workloads)
        # chaos event table (repro_torch.core.faults, DESIGN.md §12):
        # per-cluster fault scenarios evaluated per tick — None, a packed
        # DeviceFaultTable, or per-cluster fault spec lists
        if faults is not None and not hasattr(faults, "effects"):
            from repro_torch.core.faults import pack_device_faults

            faults = pack_device_faults(faults)
        if faults is not None and faults.n_clusters != self.n:
            raise ValueError(f"fault table covers {faults.n_clusters} "
                             f"clusters, fleet has {self.n}")
        self._faults = faults
        self._fault_tick = faults is not None and faults.has_tick_effects()
        self.models = list(models)
        self.spec = spec
        self.lever_specs = list(lever_specs)
        self.specs_by_name = {s.name: s for s in self.lever_specs}
        self.metric_names = [m.name for m in REGISTRY]
        self.n_nodes = spec.n_nodes
        self.chips = (spec.n_nodes - 1) * spec.chips_per_worker
        self.mc = model_constants(self.models)
        # SFC64: ~25 % faster bulk normal generation than PCG64 on this hot
        # path; one independent stream per cluster, seeded per cluster.
        self.seeds = [int(s) for s in seeds]
        self.rngs = [np.random.Generator(np.random.SFC64(s)) for s in seeds]
        self.node_speed = np.stack(
            [1.0 + 0.03 * rng.standard_normal(self.n_nodes) for rng in self.rngs])
        self.clock = np.zeros(self.n)
        self.backlog = np.zeros(self.n)
        self.server_free = np.zeros(self.n)
        self.reconfigs = np.zeros(self.n, np.int64)
        self.last_service = np.full(self.n, np.nan)
        self.last_load_s = np.zeros(self.n)
        self.configs = [self._default_config() for _ in range(self.n)]
        self._packed: Optional[dict] = None
        # (N, nodes, metrics) emission factor: metric scale × per-node speed
        # for worker metrics, plain scale for driver metrics — folding three
        # broadcast passes of the emission hot loop into one
        emc = _emission_constants()
        self._emit_factor = self.node_speed[:, :, None] * emc["scale"][None, None, :]
        self._emit_factor[:, :, emc["is_driver"]] = emc["scale"][emc["is_driver"]]
        from repro_torch.engine.fleet_torch import DeviceFleetEngine
        from repro_torch.utils import resolve_device

        self.device = resolve_device(device, "backend='torch'")
        self._dev = DeviceFleetEngine(self, device=self.device,
                                      window_impl=window_impl)

    @property
    def window_impl(self) -> str:
        """The engine's resolved window: ``"kernel"`` or ``"scan"``."""
        return self._dev.window_impl

    # ------------------------------------------------------------- config
    def _default_config(self) -> dict:
        return {s.name: s.default_value() for s in self.lever_specs}

    def packed(self) -> dict[str, np.ndarray]:
        if self._packed is None:
            self._packed = pack_configs(self.configs)
        return self._packed

    def invalidate(self) -> None:
        self._packed = None
        self._dev.invalidate_cc()   # device copy of the lever arrays too

    # ---------------------------------------------------------------- env ops
    def reset(self) -> None:
        self.clock[:] = 0.0
        self.backlog[:] = 0.0
        self.server_free[:] = 0.0
        self.reconfigs[:] = 0
        self.last_service[:] = np.nan
        self.configs = [self._default_config() for _ in range(self.n)]
        self._dev.reset()
        self.invalidate()

    def _const_rates(self) -> Optional[tuple]:
        """(rate, size) (N,) arrays when every workload is time-invariant —
        hoists the 2N python ``rate()`` calls out of every guard /
        stabilisation / window call on constant fleets."""
        if not all(getattr(w, "constant", False) for w in self.workloads):
            return None
        if not hasattr(self, "_const_rs"):
            self._const_rs = (
                np.array([w.rate(0.0) for w in self.workloads]),
                np.array([w.mean_size(0.0) for w in self.workloads]))
        return self._const_rs

    def _rates_now(self) -> tuple[np.ndarray, np.ndarray]:
        cr = self._const_rates()
        if cr is not None:
            return cr
        return (np.array([w.rate(t) for w, t in zip(self.workloads, self.clock)]),
                np.array([w.mean_size(t) for w, t in zip(self.workloads,
                                                         self.clock)]))

    def apply_configs(self, configs: Sequence[dict],
                      changed_levers: Optional[Sequence] = None,
                      copy: bool = True) -> list[dict]:
        """Install one config per cluster. Reconfiguration costs loading time
        while Kafka buffers arrivals (paper §4.2); without a ``changed_levers``
        hint the loading noise comes from each cluster's own RNG stream, as
        in the reference.

        ``changed_levers`` (per-cluster iterables of lever names) lets callers
        that know exactly which levers moved skip the 109-key config diff AND
        keeps the packed lever arrays updated in place instead of repacked.
        ``copy=False`` additionally trusts the caller to hand over ownership
        of the config dicts (no defensive copy) — the exploration hot loop's
        contract on device backends (DESIGN.md §9)."""
        if changed_levers is not None and self._packed is not None:
            return self._apply_configs_device(configs, changed_levers, copy)
        reports = []
        for i, cfg in enumerate(configs):
            old = self.configs[i]
            if changed_levers is None:
                changed = [k for k, v in cfg.items() if old.get(k) != v]
            elif not copy:
                # caller owns the dicts and may have mutated them in place
                # (old IS cfg), so the no-op filter would diff a dict
                # against itself — the hint is authoritative here
                changed = list(changed_levers[i])
            else:
                changed = [k for k in changed_levers[i] if old.get(k) != cfg.get(k)]
            reboot = any(self.specs_by_name[k].reboot for k in changed)
            rejit = any(self.specs_by_name[k].group in ("kernel", "memory", "parallel")
                        for k in changed)
            load_s = 10.0 + (60.0 if reboot else 0.0) + (8.0 if rejit else 0.0)
            load_s *= 1.0 + self.spec.noise * abs(self.rngs[i].standard_normal())
            # Kafka buffers arrivals during the reconfiguration (paper §4.2);
            # the device engine queues them for device-side application, so
            # the authoritative backlog never leaves the device (DESIGN.md §9)
            self._dev.buffer_during_load(i, load_s)
            self.clock[i] += load_s
            self.configs[i] = dict(cfg) if copy else cfg
            self.reconfigs[i] += 1
            self.last_load_s[i] = load_s
            reports.append({"load_s": float(load_s), "rebooted": reboot})
        self.invalidate()
        return reports

    def _apply_configs_device(self, configs: Sequence[dict],
                              changed_levers: Sequence,
                              copy: bool) -> list[dict]:
        """Vectorised ``apply_configs`` for device backends: one bulk host-RNG
        draw for the loading noise and batched pending-arrival buffering
        instead of N python round-trips. The per-cluster-stream accounting
        only exists for the reference numpy oracle's bit-for-bit contract,
        which device backends already trade away (DESIGN.md §9)."""
        n = self.n
        load_s = np.full(n, 10.0)
        reboot = np.zeros(n, bool)
        for i, ch in enumerate(changed_levers):
            cfg = configs[i]
            rb = rj = False
            for k in ch:
                s = self.specs_by_name[k]
                rb |= s.reboot
                rj |= s.group in ("kernel", "memory", "parallel")
                for key in _LEVER_TO_PACKED.get(k, ()):
                    self._packed[key][i] = _PACKERS[key](cfg)
            load_s[i] += (60.0 if rb else 0.0) + (8.0 if rj else 0.0)
            reboot[i] = rb
            self.configs[i] = dict(cfg) if copy else cfg
        load_s *= 1.0 + self.spec.noise * np.abs(
            self._dev.host_rng.standard_normal(n))
        rate, _ = self._rates_now()
        self._dev.buffer_during_load_batch(rate * load_s, load_s)
        self.clock += load_s
        self.reconfigs += 1
        self.last_load_s = load_s
        self._dev.invalidate_cc()
        return [{"load_s": float(l), "rebooted": bool(r)}
                for l, r in zip(load_s, reboot)]

    def runnable_delta(self, proposals: Sequence[dict],
                       changed_levers: Sequence) -> np.ndarray:
        """``runnable`` for single-lever proposals: patches a copy of the
        packed lever arrays instead of re-packing all 21 × N extractor
        lambdas — the §2.1 guard at 1024-cluster fleet scale."""
        cc = {k: v.copy() for k, v in self.packed().items()}
        for i, (cfg, ch) in enumerate(zip(proposals, changed_levers)):
            for k in ch:
                for key in _LEVER_TO_PACKED.get(k, ()):
                    cc[key][i] = _PACKERS[key](cfg)
        rate, size = self._rates_now()
        return self._allowlist(cc, rate, size)

    def stabilisation_times(self) -> np.ndarray:
        """Paper §4.2: stabilisation detected from latency-variance trends,
        '<3 min 99 % of the time'. Modelled as base + term ∝ service change."""
        rate, size = self._rates_now()
        s_new = service_terms_arrays(self.packed(), self.mc, self.spec,
                                     self.chips, rate, size)["service"]
        prev = np.where(np.isnan(self.last_service), s_new, self.last_service)
        rel = np.abs(s_new - prev) / np.maximum(prev, 1e-6)
        self.last_service = s_new
        return np.clip(30.0 + 240.0 * rel, 30.0, 180.0)

    def _allowlist(self, cc: dict, rate: np.ndarray,
                   size: np.ndarray) -> np.ndarray:
        """The paper's allow-list rule over packed lever arrays: service
        within 2.5 batch intervals and ≥70 % throughput — the ONE place the
        thresholds live (``runnable`` and ``runnable_delta`` both call it)."""
        service = service_terms_arrays(cc, self.mc, self.spec, self.chips,
                                       rate, size)["service"]
        T_b = cc["T_b"]
        batch = np.minimum(rate * T_b, cc["max_batch_events"])
        throughput = batch / np.maximum(service, T_b)
        return (service <= 2.5 * T_b) & (throughput >= 0.7 * rate)

    def runnable(self, configs: Sequence[dict]) -> np.ndarray:
        """Paper's allow-list, vectorised: keep only configs the engine could
        schedule."""
        rate, size = self._rates_now()
        return self._allowlist(pack_configs(configs), rate, size)

    # -------------------------------------------------------------- windows
    def observe_fleet(self, window_s, *, summarise: bool = True,
                      preroll_s=None):
        """Advance every cluster by its window on the device engine and
        return per-cluster window views (``None`` with ``summarise=False``).

        ``window_s`` may be a scalar (same window for all) or an (N,) array
        (per-cluster stabilisation windows). ``preroll_s`` prepends a
        stabilisation wait excluded from the window, fused into the same
        device window (DESIGN.md §9).
        """
        return self._dev.observe_fleet(self._windows(window_s),
                                       summarise=summarise,
                                       preroll_s=preroll_s)

    def advance_fleet(self, window_s) -> None:
        """``observe_fleet`` without the window summaries — for stabilisation
        waits whose metrics nobody reads (reward is measured on the window
        AFTER stabilisation, paper §4.2)."""
        self.observe_fleet(window_s, summarise=False)

    def observe_fleet_stats(self, window_s, preroll_s=None) -> dict:
        """``observe_fleet`` returning fleet-shaped window arrays instead of N
        per-cluster objects: ``{"mean_ms", "p99_ms", "processed", "per_node",
        "clock_s"}`` with leading cluster axis. The arrays stay on the device
        until read, so an exploration loop can queue many windows
        asynchronously (DESIGN.md §9). ``preroll_s`` prepends a stabilisation
        wait (paper §4.2) excluded from the stats, in the same program."""
        self._dev.observe_fleet(self._windows(window_s), summarise=True,
                                build_windows=False, preroll_s=preroll_s)
        return self._dev.last_stats

    def _windows(self, window_s) -> np.ndarray:
        win = np.asarray(window_s, float)
        return np.full(self.n, float(win)) if win.ndim == 0 else win


class SimCluster:
    """Implements repro_torch.core.configurator.TuningEnv on a simulated
    clock: the N=1 view over ``FleetCore`` on ``device`` (``None`` resolves
    to ``cuda`` and raises without a card; ``"cpu"`` runs the kernel's plain
    version). Loading-time noise comes from the cluster's own numpy stream,
    as in the reference; each window is one ``fleet_tick`` launch."""

    def __init__(
        self,
        workload: Optional[Workload] = None,
        model: Optional[ModelConfig] = None,
        *,
        spec: Optional[SimSpec] = None,
        lever_specs: Optional[Sequence[LeverSpec]] = None,
        seed: int = 0,
        device=None,
    ):
        from repro_torch import configs
        from repro_torch.data.workloads import PoissonWorkload
        from repro_torch.engine.levers import LEVER_SPECS

        self.workload = workload or PoissonWorkload(10_000, 0.5)
        self.model = model or configs.get("smollm_135m")
        self.spec = spec or SimSpec()
        self._core = FleetCore([self.workload], [self.model], self.spec,
                               list(lever_specs or LEVER_SPECS), [seed],
                               device=device)
        self.lever_specs = self._core.lever_specs
        self.metric_names = self._core.metric_names
        self.n_nodes = self._core.n_nodes
        self.device = self._core.device

    # ------------------------------------------------- N=1 views over the core
    @property
    def clock(self) -> float:
        return float(self._core.clock[0])

    @clock.setter
    def clock(self, v: float) -> None:
        self._core.clock[0] = v

    @property
    def backlog_events(self) -> float:
        """The backlog the next window starts from. Once a window has run,
        the engine's device tensor holds it (``FleetCore.backlog`` is then
        stale), and a reconfiguration's buffered arrivals wait on the host
        until that window: the two summed, as the reference's numpy
        ``SimCluster`` reports right after ``apply_config``."""
        dev = self._core._dev
        held = (float(self._core.backlog[0]) if dev._backlog is None
                else float(dev._backlog[0]))
        return held + float(dev._pending_arrivals[0])

    @backlog_events.setter
    def backlog_events(self, v: float) -> None:
        """Write the backlog the engine holds (the device tensor once a
        window has run); pending arrivals are left as they are."""
        dev = self._core._dev
        if dev._backlog is None:
            self._core.backlog[0] = v
        else:
            dev._backlog = dev._backlog.new_full(dev._backlog.shape,
                                                 float(v))

    @property
    def store(self) -> None:
        """``None``: a device engine summarises its windows on the device
        and keeps no ring buffer of metric series, as the reference's
        device backends keep none."""
        return None

    @property
    def config(self) -> dict:
        # the live dict; a caller may mutate it in place, which the setter
        # would never see, so drop the packed-lever cache
        self._core.invalidate()
        return self._core.configs[0]

    @config.setter
    def config(self, cfg: dict) -> None:
        self._core.configs[0] = cfg
        self._core.invalidate()

    # ------------------------------------------------------------------ env API
    def reset(self) -> None:
        self._core.reset()

    def current_config(self) -> dict:
        return dict(self._core.configs[0])

    def apply_config(self, config: dict) -> dict:
        return self._core.apply_configs([config])[0]

    def stabilisation_time(self) -> float:
        return float(self._core.stabilisation_times()[0])

    def observe(self, window_s: float):
        """Advance the sim by window_s; the window's metrics and latency
        sample (a lazy view over the device results)."""
        return self._core.observe_fleet(float(window_s))[0]

    def advance(self, window_s: float) -> None:
        """observe() minus the unread window summary (stabilisation waits)."""
        self._core.advance_fleet(float(window_s))

    # ------------------------------------------------------------- perf model
    def _chips(self) -> int:
        return self._core.chips

    def _service_terms(self, rate: float, ev_size: float = 0.5,
                       batch_events: Optional[float] = None) -> dict:
        terms = service_terms_arrays(
            self._core.packed(), self._core.mc, self.spec, self._core.chips,
            rate, ev_size, batch_events)
        return {k: float(np.asarray(v).reshape(-1)[0]) for k, v in terms.items()}
