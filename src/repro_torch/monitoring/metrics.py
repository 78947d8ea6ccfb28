"""90-metric registry + per-node time-series store (paper §2.1/§2.2 substrate).

The paper collects 90 metrics/min/node from dstat/JVM/perf on Spark clusters.
Our engine's equivalents are TPU-pod metrics: latency percentiles, queue
state, device compute/memory/collective utilisation, host overheads, compile
cache stats, padding waste, checkpoint/fault counters, power.

Each metric declares:
  * scope   — 'driver' (engine coordinator) or 'worker' (per device/host)
  * group   — its latent redundancy group. The SimCluster emits metrics as
              (loading · latent) + noise, so FA + k-means has real structure
              to recover (the paper found 7 clusters over ~90 metrics, Fig 2);
  * loading — weights over the latent factor vector.

Latent factors (ground truth the sim uses; FA should approximately recover
them): load, compute, memory, network, host, efficiency, reliability, power.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

FACTORS = ("load", "compute", "memory", "network", "host",
           "efficiency", "reliability", "power")


@dataclass(frozen=True)
class MetricDef:
    name: str
    scope: str                      # driver | worker
    group: str                      # human label (cluster family)
    loading: dict = field(default_factory=dict)  # factor -> weight
    scale: float = 1.0              # output units scale
    noise: float = 0.05             # relative iid noise
    bias: float = 0.0

    def value(self, latents: dict, rng: np.random.Generator) -> float:
        v = self.bias + sum(latents.get(f, 0.0) * w for f, w in self.loading.items())
        return float(self.scale * v * (1.0 + self.noise * rng.standard_normal()))


def _m(name, scope, group, loading, scale=1.0, noise=0.05, bias=0.0):
    return MetricDef(name, scope, group, loading, scale, noise, bias)


def build_registry() -> list[MetricDef]:
    L = []
    # -- latency family (driver, 7) — dominated by 'load' -------------------
    for nm, s in [("latency_mean_ms", 1.0), ("latency_p50_ms", 0.8),
                  ("latency_p95_ms", 1.6), ("latency_p99_ms", 2.0),
                  ("latency_max_ms", 3.0), ("event_wait_ms", 0.7),
                  ("batch_service_ms", 0.5)]:
        L.append(_m(nm, "driver", "latency", {"load": 1.0, "compute": 0.15}, s))
    # -- throughput family (driver, 6) ---------------------------------------
    for nm, ld in [("events_per_s", {"load": -0.2, "compute": 1.0}),
                   ("batches_per_s", {"compute": 1.0}),
                   ("tokens_per_s", {"compute": 1.0, "efficiency": 0.3}),
                   ("bytes_in_mb_s", {"load": 1.0}),
                   ("bytes_out_mb_s", {"load": 0.9, "efficiency": 0.1}),
                   ("sink_commit_s", {"host": 0.8, "load": 0.3})]:
        L.append(_m(nm, "driver", "throughput", ld))
    # -- queue state (driver, 6) ------------------------------------------------
    for nm in ["queue_depth", "queue_age_ms", "buffer_bytes_mb",
               "drop_count", "replay_count", "backlog_batches"]:
        L.append(_m(nm, "driver", "queue", {"load": 1.2, "reliability": 0.2}))
    # -- device compute (worker, 7) ----------------------------------------------
    for nm, ld in [("device_util", {"compute": 1.0}),
                   ("mxu_util", {"compute": 1.0, "efficiency": 0.4}),
                   ("flops_rate_tflops", {"compute": 1.0, "efficiency": 0.3}),
                   ("vpu_util", {"compute": 0.8}),
                   ("kernel_occupancy", {"compute": 0.9, "efficiency": 0.3}),
                   ("step_time_ms", {"load": 0.5, "compute": 0.6}),
                   ("compute_stall_frac", {"memory": 0.7, "network": 0.4})]:
        L.append(_m(nm, "worker", "compute", ld))
    # -- HBM / memory (worker, 7) ---------------------------------------------------
    for nm, ld in [("hbm_used_gb", {"memory": 1.0}),
                   ("hbm_peak_gb", {"memory": 1.1}),
                   ("hbm_bw_util", {"memory": 0.9, "compute": 0.3}),
                   ("vmem_spill_bytes", {"memory": 1.3}),
                   ("alloc_fragmentation", {"memory": 0.8, "host": 0.2}),
                   ("allocator_arena_mb", {"memory": 0.7}),
                   ("oom_retries", {"memory": 1.5, "reliability": 0.5})]:
        L.append(_m(nm, "worker", "memory", ld))
    # -- host (worker, 7) -----------------------------------------------------------
    for nm in ["host_cpu_util", "host_mem_gb", "host_io_wait",
               "callback_overhead_ms", "transfer_stall_ms", "infeed_wait_ms",
               "outfeed_wait_ms"]:
        L.append(_m(nm, "worker", "host", {"host": 1.0, "load": 0.2}))
    # -- collective / network (worker, 7) ----------------------------------------------
    for nm in ["ici_bw_util", "allreduce_ms", "allgather_ms",
               "collective_wait_ms", "network_rx_mb_s", "network_tx_mb_s",
               "permute_ms"]:
        L.append(_m(nm, "worker", "network", {"network": 1.0, "compute": 0.1}))
    # -- jit / compile cache (driver, 6) ---------------------------------------------
    for nm, ld in [("jit_compiles", {"reliability": 0.6, "host": 0.5}),
                   ("jit_time_s", {"host": 0.9}),
                   ("cache_hits", {"host": -0.3, "efficiency": 0.5}),
                   ("cache_misses", {"host": 0.7}),
                   ("recompile_count", {"reliability": 0.8}),
                   ("dispatch_overhead_ms", {"host": 0.8, "load": 0.2})]:
        L.append(_m(nm, "driver", "jit", ld))
    # -- padding / efficiency (worker, 6) -------------------------------------------------
    for nm, ld in [("padding_waste_frac", {"efficiency": -1.0}),
                   ("batch_fill_frac", {"efficiency": 1.0, "load": 0.3}),
                   ("useful_flops_frac", {"efficiency": 1.0}),
                   ("remat_recompute_frac", {"efficiency": -0.7, "memory": -0.4}),
                   ("moe_drop_frac", {"efficiency": -0.8, "load": 0.3}),
                   ("moe_imbalance", {"efficiency": -0.6})]:
        L.append(_m(nm, "worker", "efficiency", ld))
    # -- checkpoint / fault tolerance (driver, 6) -------------------------------------------
    for nm in ["ckpt_write_s", "ckpt_bytes_gb", "restore_count",
               "failure_count", "straggler_events", "rescale_events"]:
        L.append(_m(nm, "driver", "reliability", {"reliability": 1.0}))
    # -- allocator churn / host sync, the GC analogue (worker, 5) -------------------------------
    for nm in ["host_sync_stall_ms", "donation_miss_count", "buffer_churn_mb_s",
               "live_buffers", "compaction_ms"]:
        L.append(_m(nm, "worker", "gc", {"memory": 0.8, "host": 0.6}))
    # -- power / thermal (worker, 4) -----------------------------------------------------------
    for nm in ["chip_power_w", "chip_temp_c", "throttle_events", "duty_cycle"]:
        L.append(_m(nm, "worker", "power", {"power": 1.0, "compute": 0.6}))
    # -- scheduler (worker, 6) ---------------------------------------------------------------------
    for nm in ["sched_queue_depth", "prefetch_depth_eff", "batch_form_ms",
               "dispatch_queue_ms", "task_retries", "work_steal_count"]:
        L.append(_m(nm, "worker", "scheduler", {"load": 0.9, "host": 0.3}))
    # -- pure-noise daemons (mixed, 10): constant or uncorrelated — the 10 %
    #    the variance filter should drop / FA should isolate -----------------------
    for nm, scope in [("clock_skew_ms", "worker"), ("ntp_drift_ms", "worker"),
                      ("daemon_cpu_frac", "worker"), ("log_rate_lines_s", "driver"),
                      ("fd_count", "driver"), ("uptime_s", "driver"),
                      ("heartbeat_lag_ms", "worker"), ("container_restarts", "driver"),
                      ("disk_used_frac", "worker"), ("inode_used_frac", "worker")]:
        const = nm in ("uptime_s", "fd_count", "disk_used_frac", "inode_used_frac",
                       "container_restarts")
        L.append(_m(nm, scope, "noise", {}, noise=0.0 if const else 1.0,
                    bias=1.0 if const else 0.0))
    assert len(L) == 90, len(L)
    return L


REGISTRY: list[MetricDef] = build_registry()
METRIC_NAMES: list[str] = [m.name for m in REGISTRY]
DRIVER_METRICS = [m.name for m in REGISTRY if m.scope == "driver"]
WORKER_METRICS = [m.name for m in REGISTRY if m.scope == "worker"]


@dataclass
class ChaosCounters:
    """Chaos/SLO bookkeeping for the fused device loop (DESIGN.md §12).

    The fused episode program never materialises per-step host values, so
    monitoring is fed in bulk ONCE per episode batch — the same
    device-to-host pull that builds ``StepRecord``s: window counts, reward
    mass, the p99 high-water mark and SLO-breach counters.
    ``breach_frac`` rows come from the window program's in-trace tick-level
    breach fraction (``reward_mode="slo"``); without them breaches are
    counted against an explicit ``slo_ms`` from the window p99 instead.
    ``fault_events`` is the static count of non-``NoFault`` slots in the
    fleet's packed ``DeviceFaultTable``."""

    windows: int = 0
    breached_windows: int = 0
    fault_events: int = 0
    reward_sum: float = 0.0
    breach_frac_sum: float = 0.0
    p99_max_ms: float = 0.0
    wall_s: float = 0.0

    def record_batch(self, rewards, p99_ms, breach_frac=None, *,
                     slo_ms: float = 0.0) -> None:
        """Fold one episode batch's (N, S) arrays into the counters."""
        rewards = np.asarray(rewards, float)
        p99 = np.asarray(p99_ms, float)
        self.windows += int(rewards.size)
        self.reward_sum += float(rewards.sum())
        if p99.size:
            self.p99_max_ms = max(self.p99_max_ms, float(p99.max()))
        if breach_frac is not None:
            bf = np.asarray(breach_frac, float)
            self.breach_frac_sum += float(bf.sum())
            self.breached_windows += int((bf > 0.0).sum())
        elif slo_ms > 0.0:
            self.breached_windows += int((p99 > slo_ms).sum())

    def add_wall(self, seconds: float) -> None:
        self.wall_s += float(seconds)

    @property
    def windows_per_s(self) -> float:
        return self.windows / self.wall_s if self.wall_s > 0.0 else 0.0

    @property
    def mean_reward(self) -> float:
        return self.reward_sum / self.windows if self.windows else 0.0

    @property
    def breach_rate(self) -> float:
        return self.breached_windows / self.windows if self.windows else 0.0

    def as_dict(self) -> dict:
        return {"windows": self.windows,
                "breached_windows": self.breached_windows,
                "fault_events": self.fault_events,
                "reward_sum": self.reward_sum,
                "breach_frac_sum": self.breach_frac_sum,
                "p99_max_ms": self.p99_max_ms,
                "wall_s": self.wall_s,
                "windows_per_s": self.windows_per_s,
                "mean_reward": self.mean_reward,
                "breach_rate": self.breach_rate}

    def prometheus_text(self, prefix: str = "repro_chaos") -> str:
        """Prometheus text-exposition dump of the counters."""
        return _prometheus_text(prefix, self.as_dict(), _CHAOS_COUNTER_KEYS)


@dataclass
class ShieldCounters:
    """Safe-exploration shield bookkeeping (DESIGN.md §16).

    Counters (monotone): ``clamped_actions`` — sampled bin moves that the
    trust-region clamp pulled back inside the ±R window around the
    last-known-good config; ``fallbacks`` — steps where a cluster's whole
    config row was reverted to LKG (risk over threshold or breach budget
    exhausted); ``budget_exhaustions`` — episodes in which a cluster ran
    its per-episode breach budget to zero. Gauge: ``trust_radius`` — the
    fleet-mean trust radius R after the most recent episode batch, the
    live width of the exploration corridor."""

    clamped_actions: int = 0
    fallbacks: int = 0
    budget_exhaustions: int = 0
    trust_radius: float = 0.0

    def as_dict(self) -> dict:
        return {f: getattr(self, f) for f in self.__dataclass_fields__}

    @classmethod
    def from_dict(cls, d: dict) -> "ShieldCounters":
        c = cls()
        for f in cls.__dataclass_fields__:
            if f in d:
                setattr(c, f, type(getattr(c, f))(d[f]))
        return c

    def prometheus_text(self, prefix: str = "repro_shield") -> str:
        return _prometheus_text(prefix, self.as_dict(), _SHIELD_COUNTER_KEYS)


#: which ChaosCounters fields render as monotonically-increasing counters
#: (``_total`` suffix) vs gauges in the text exposition
_CHAOS_COUNTER_KEYS = frozenset(
    {"windows", "breached_windows", "fault_events"})

_SHIELD_COUNTER_KEYS = frozenset(
    {"clamped_actions", "fallbacks", "budget_exhaustions"})

_SERVE_COUNTER_KEYS = frozenset(
    {"cycles", "shadow_windows", "canary_windows", "canary_breached",
     "live_windows", "live_breached", "promotions", "rollbacks",
     "demotions", "holds"})

def retrace_counts() -> int:
    """Total program compilations on the hot loop: the one-time ``nvcc``
    build of each kernel library plus every CUDA-graph capture of the
    fused loop's and the policy update's programs
    (``core.graphs.CAPTURE_COUNTS``; on the CPU, programs built) — the
    port's twin of the reference's jit-trace total. A steady-state serve
    loop captures its program set once, so this total going up
    cycle-over-cycle means programs are being recaptured; ``ServeCounters``
    exposes it as the ``retraces`` gauge."""
    from repro_torch.core import graphs
    from repro_torch.kernels import build
    return int(build.BUILDS) + sum(graphs.CAPTURE_COUNTS.values())


def _prometheus_text(prefix: str, values: dict, counter_keys) -> str:
    """Render a flat {name: number} dict in the Prometheus text-exposition
    format (one HELP/TYPE pair per series, counters get ``_total``)."""
    lines = []
    for k, v in values.items():
        if v is None or isinstance(v, (dict, list, str)):
            continue
        kind = "counter" if k in counter_keys else "gauge"
        name = f"{prefix}_{k}" + ("_total" if kind == "counter" else "")
        lines.append(f"# HELP {name} {k.replace('_', ' ')}")
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name} {float(v):g}")
    return "\n".join(lines) + "\n"


@dataclass
class ServeCounters:
    """Control-plane bookkeeping for the serve loop (DESIGN.md §13).

    Counters (monotone): cycles, per-role window counts, SLO breach counts
    on the canary and live fleets, and the gate outcome tally
    (promotions / rollbacks / demotions / holds). Gauges: the latest live
    reward/p99, the canary p99 high-water of the most recent evaluation,
    and ``retraces`` — the process-wide ``retrace_counts()`` total the
    controller samples each cycle (flat in steady state; climbing means
    the device programs are being recompiled). ``prometheus_text`` renders
    the ``/metrics``-style dump the launcher writes on every cycle and on
    shutdown (``flush_guard``)."""

    cycles: int = 0
    shadow_windows: int = 0
    canary_windows: int = 0
    canary_breached: int = 0
    live_windows: int = 0
    live_breached: int = 0
    promotions: int = 0
    rollbacks: int = 0
    demotions: int = 0
    holds: int = 0
    wall_s: float = 0.0
    live_reward: float = 0.0
    live_p99_ms: float = 0.0
    last_canary_p99_ms: float = 0.0
    retraces: int = 0

    def inc(self, name: str, n: int = 1) -> None:
        setattr(self, name, getattr(self, name) + int(n))

    def add_wall(self, seconds: float) -> None:
        self.wall_s += float(seconds)

    def observe_live(self, *, reward: float, p99_ms: float) -> None:
        self.live_reward = float(reward)
        self.live_p99_ms = float(p99_ms)

    @property
    def windows_per_s(self) -> float:
        w = self.shadow_windows + self.canary_windows + self.live_windows
        return w / self.wall_s if self.wall_s > 0.0 else 0.0

    @property
    def breach_rate(self) -> float:
        w = self.canary_windows + self.live_windows
        return (self.canary_breached + self.live_breached) / w if w else 0.0

    @property
    def cycle_latency_s(self) -> float:
        return self.wall_s / self.cycles if self.cycles else 0.0

    def as_dict(self) -> dict:
        d = {f: getattr(self, f) for f in self.__dataclass_fields__}
        d["windows_per_s"] = self.windows_per_s
        d["breach_rate"] = self.breach_rate
        d["cycle_latency_s"] = self.cycle_latency_s
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ServeCounters":
        c = cls()
        for f in cls.__dataclass_fields__:
            if f in d:
                setattr(c, f, type(getattr(c, f))(d[f]))
        return c

    def prometheus_text(self, prefix: str = "repro_serve") -> str:
        return _prometheus_text(prefix, self.as_dict(), _SERVE_COUNTER_KEYS)


@contextlib.contextmanager
def flush_guard(path, render):
    """Always-write-the-metrics-dump guard for the launchers.

    ``render()`` must return the text to write to ``path``. The body runs
    with SIGTERM remapped to ``KeyboardInterrupt`` so a polite kill of a
    long-running serve/tune process unwinds through the ``finally`` and
    the final dump is written — the tune launcher's Ctrl-C path uses it."""
    import os
    import signal

    path = Path(path)
    prev = None
    is_main = threading.current_thread() is threading.main_thread()
    if is_main:
        def _term(signum, frame):
            raise KeyboardInterrupt
        try:
            prev = signal.signal(signal.SIGTERM, _term)
        except (ValueError, OSError):
            prev = None
    try:
        yield
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + ".tmp")
        tmp.write_text(render())
        os.replace(tmp, path)


class TimeSeriesStore:
    """Per-node ring buffer of metric samples: (t, node, metric) -> value."""

    def __init__(self, names: Sequence[str], n_nodes: int, capacity: int = 4096):
        self.names = list(names)
        self.index = {n: i for i, n in enumerate(self.names)}
        self.n_nodes = n_nodes
        self.capacity = capacity
        self._t = np.zeros(capacity)
        self._v = np.full((capacity, n_nodes, len(self.names)), np.nan)
        self._head = 0
        self._count = 0

    def append(self, t: float, values: np.ndarray) -> None:
        """values (n_nodes, n_metrics)."""
        self._t[self._head] = t
        self._v[self._head] = values
        self._head = (self._head + 1) % self.capacity
        self._count = min(self._count + 1, self.capacity)

    def window(self, seconds: float, now: float) -> np.ndarray:
        """(samples, n_nodes, n_metrics) for t in [now-seconds, now]."""
        if self._count == 0:
            return np.zeros((0, self.n_nodes, len(self.names)))
        idx = (self._head - np.arange(1, self._count + 1)) % self.capacity
        sel = idx[self._t[idx] >= now - seconds]
        return self._v[sel[::-1]]

    def node_average(self, seconds: float, now: float) -> dict[str, np.ndarray]:
        """metric -> (n_nodes,) mean over the window (heat-map input)."""
        w = self.window(seconds, now)
        if w.shape[0] == 0:
            return {n: np.zeros(self.n_nodes) for n in self.names}
        avg = np.nanmean(w, axis=0)  # (nodes, metrics)
        return {n: avg[:, self.index[n]] for n in self.names}


class FleetSeriesStore:
    """Batched ``TimeSeriesStore``: one ring buffer over (time, cluster, node,
    metric) so a fleet tick appends every cluster's sample in a single scatter
    (DESIGN.md §2a). Clusters keep independent heads/counts/timestamps —
    ragged fleets (per-cluster batch intervals) stay exact."""

    def __init__(self, names: Sequence[str], n_clusters: int, n_nodes: int,
                 capacity: int = 256):
        # capacity sizes the look-back: metric emission is 1/simulated-minute
        # (DESIGN.md §2), so 256 slots cover >4 h windows while keeping the
        # ring ~120 MB at fleet size 64 (4096 slots would be ~1.9 GB)
        self.names = list(names)
        self.index = {n: i for i, n in enumerate(self.names)}
        self.n_clusters = n_clusters
        self.n_nodes = n_nodes
        self.capacity = capacity
        self._t = np.zeros((capacity, n_clusters))
        self._v = np.zeros((capacity, n_clusters, n_nodes, len(self.names)))
        # fault the ring in now: appends walk forward through fresh slots, so
        # lazily-paged memory would otherwise page-fault on the hot path for
        # the first `capacity` ticks
        self._v.fill(0.0)
        self._head = np.zeros(n_clusters, np.int64)
        self._count = np.zeros(n_clusters, np.int64)
        self._ids = np.arange(n_clusters)

    def clear(self) -> None:
        """Reset to empty without reallocating (or re-faulting) the ring."""
        self._head[:] = 0
        self._count[:] = 0
        self._t[:] = 0.0

    def lockstep_slot(self) -> Optional[np.ndarray]:
        """When every cluster's ring head coincides (fleets ticking in
        lockstep — the common case), expose the next slot as a writable
        (n_clusters, n_nodes, n_metrics) view so emission can compute straight
        into the ring without an intermediate array. Commit with
        ``commit_slot``; returns None when heads have diverged."""
        h0 = int(self._head[0])
        if (self._head == h0).all():
            return self._v[h0]
        return None

    def commit_slot(self, ts: np.ndarray) -> None:
        """Finalise a ``lockstep_slot`` write at per-cluster times ts."""
        h0 = int(self._head[0])
        self._t[h0] = ts
        self._head[:] = (h0 + 1) % self.capacity
        np.minimum(self._count + 1, self.capacity, out=self._count)

    def append_batch(self, ids: np.ndarray, ts: np.ndarray,
                     values: np.ndarray) -> None:
        """values (len(ids), n_nodes, n_metrics) at per-cluster times ts."""
        h = self._head[ids]
        h0 = int(h[0])
        if (ids.size == self.n_clusters and (h == h0).all()
                and (ids == self._ids).all()):
            # lockstep fleet (the common case): one contiguous slice write.
            # The ids==arange guard matters — values row i must land in
            # cluster i, so a permuted ids batch takes the scatter path.
            self._v[h0] = values
            self._t[h0] = ts
            self._head[:] = (h0 + 1) % self.capacity
        else:
            self._v[h, ids] = values
            self._t[h, ids] = ts
            self._head[ids] = (h + 1) % self.capacity
        self._count[ids] = np.minimum(self._count[ids] + 1, self.capacity)

    def window_of(self, i: int, seconds: float, now: float) -> np.ndarray:
        """(samples, n_nodes, n_metrics) for cluster i, t in [now-seconds, now]."""
        c = int(self._count[i])
        if c == 0:
            return np.zeros((0, self.n_nodes, len(self.names)))
        idx = (int(self._head[i]) - np.arange(1, c + 1)) % self.capacity
        sel = idx[self._t[idx, i] >= now - seconds]
        return self._v[sel[::-1], i]
