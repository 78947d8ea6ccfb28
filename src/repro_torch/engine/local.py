"""LocalEngine — the REAL environment: a StreamEngine over the reduced
smollm config, driven by real wall-clock (DESIGN.md §2), on PyTorch.

Proves the tuner drives a live system: re-"compile" costs, batch formation,
padding waste and latency percentiles are all measured, not simulated. The
lever set is the subset with real effect in-process (the tuner is agnostic to
the lever space — it reads ``env.lever_specs``).

The engine runs on ``device`` (``cuda`` unless another device is named;
without a card ``device=None`` raises). ``StreamEngine.process_batch`` waits
for the device before it stamps a batch's latencies, so every latency is
real seconds on that device. A "compile" is a new shape's first call
(``StreamEngine``'s docstring says why).
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.discretize import LeverSpec
from repro_torch.data.workloads import PoissonWorkload, Workload
from repro_torch.engine.engine import EngineConfig, StreamEngine
from repro_torch.engine.simcluster import MetricsWindowData
from repro_torch.monitoring.metrics import REGISTRY, TimeSeriesStore
from repro_torch.utils import resolve_device

LOCAL_LEVERS: list[LeverSpec] = [
    LeverSpec("batch_interval_s", kind="log", lo=0.02, hi=2.0, default=0.5,
              group="ingest"),
    LeverSpec("max_batch_events", kind="log", lo=2, hi=64, default=8,
              group="ingest"),
    LeverSpec("pad_to_pow2", kind="bool", default=True, group="ingest"),
    LeverSpec("seq_bucket_count", kind="int", lo=1, hi=8, default=4,
              group="ingest"),
    LeverSpec("compute_dtype", kind="choice", choices=("float32", "bfloat16"),
              default="float32", group="precision", reboot=True),
    LeverSpec("attn_impl", kind="choice", choices=("chunked", "naive"),
              default="chunked", group="kernel", reboot=True),
    LeverSpec("attn_chunk", kind="choice", choices=(32, 64, 128), default=64,
              group="kernel", reboot=True),
    LeverSpec("sink_partitions", kind="int", lo=1, hi=32, default=8,
              group="misc"),
    LeverSpec("warmup_batches", kind="int", lo=0, hi=4, default=1,
              group="misc"),
    LeverSpec("prefetch_depth", kind="int", lo=0, hi=8, default=2,
              group="sched"),
    LeverSpec("failure_inject_frac", lo=0.0, hi=0.2, default=0.0,
              group="misc"),
    LeverSpec("dedupe_window_s", lo=0.0, hi=10.0, default=0.0, group="ingest"),
]


class LocalEngine:
    """TuningEnv over a real StreamEngine, real seconds."""

    def __init__(self, workload: Optional[Workload] = None, *, seed: int = 0,
                 arch: str = "smollm_135m", device=None):
        from repro_torch import configs

        self.workload = workload or PoissonWorkload(lam=24.0, event_size_mb=0.5)
        self.lever_specs: Sequence[LeverSpec] = list(LOCAL_LEVERS)
        self.metric_names = [m.name for m in REGISTRY]
        self.n_nodes = 1
        self.seed = seed
        self.device = resolve_device(device, "LocalEngine")
        self._cfg = configs.get(arch, reduced=True)
        self.config = {s.name: s.default_value() for s in self.lever_specs}
        self.engine = StreamEngine(self._cfg, seed=seed,
                                   econf=self._econf(self.config),
                                   device=self.device)
        self.engine.warmup()
        self.store = TimeSeriesStore(self.metric_names, self.n_nodes)
        self._rng = np.random.default_rng(seed)
        self._t0 = time.perf_counter()

    # ------------------------------------------------------------------ env API
    def _econf(self, config: dict) -> EngineConfig:
        return EngineConfig(
            batch_interval_s=float(config["batch_interval_s"]),
            max_batch_events=int(config["max_batch_events"]),
            pad_to_pow2=bool(config["pad_to_pow2"]),
            seq_bucket_count=int(config["seq_bucket_count"]),
            compute_dtype=str(config["compute_dtype"]),
            attn_impl=str(config["attn_impl"]),
            attn_chunk=int(config["attn_chunk"]),
            sink_partitions=int(config["sink_partitions"]),
            warmup_batches=int(config["warmup_batches"]),
            failure_inject_frac=float(config["failure_inject_frac"]),
        )

    def reset(self) -> None:
        self.config = {s.name: s.default_value() for s in self.lever_specs}
        self.engine = StreamEngine(self._cfg, seed=self.seed,
                                   econf=self._econf(self.config),
                                   device=self.device)
        self.engine.warmup()
        self.store = TimeSeriesStore(self.metric_names, self.n_nodes)
        self._t0 = time.perf_counter()

    def current_config(self) -> dict:
        return dict(self.config)

    def apply_config(self, config: dict) -> dict:
        t0 = time.perf_counter()
        load_s = self.engine.reconfigure(self._econf(config))
        rebooted = any(
            s.reboot and config.get(s.name) != self.config.get(s.name)
            for s in self.lever_specs)
        self.config = dict(config)
        if int(config["warmup_batches"]):
            self.engine.warmup()
        return {"load_s": time.perf_counter() - t0 + load_s, "rebooted": rebooted}

    def stabilisation_time(self) -> float:
        return 0.0  # the real engine has no OS-level warm-up to wait for

    def observe(self, window_s: float) -> MetricsWindowData:
        """Run the engine for (up to) window_s REAL seconds."""
        now = time.perf_counter()
        end = now + window_s
        lats: list[float] = []
        pads: list[float] = []
        services: list[float] = []
        n_batches = 0
        while time.perf_counter() < end:
            t_batch_close = time.perf_counter() + self.engine.econf.batch_interval_s
            evs = self.workload.sample_events(
                time.perf_counter(), t_batch_close, self._rng, max_events=4096)
            # stamp with real arrival clocks then sleep until the window closes
            for e in evs:
                e.arrival_s = min(e.arrival_s, t_batch_close)
            self.engine.buffer.put(evs)
            dt = t_batch_close - time.perf_counter()
            if dt > 0:
                time.sleep(min(dt, self.engine.econf.batch_interval_s))
            rep = self.engine.process_batch(time.perf_counter())
            if rep:
                lats.extend(rep.latencies_s)
                pads.append(rep.padding_frac)
                services.append(rep.service_s)
                n_batches += 1
        lat_ms = 1000.0 * np.asarray(lats) if lats else np.array([1e3 * window_s])
        self._emit(lat_ms, pads, services, n_batches, window_s)
        return MetricsWindowData(
            per_node=self.store.node_average(window_s, self._clock()),
            latencies_ms=lat_ms,
            p99_ms=float(np.percentile(lat_ms, 99)),
            clock_s=self._clock(),
        )

    # ------------------------------------------------------------------ internals
    def _clock(self) -> float:
        return time.perf_counter() - self._t0

    def _emit(self, lat_ms, pads, services, n_batches, window_s) -> None:
        vals = np.zeros((1, len(self.metric_names)))
        li = self.store.index
        e = self.engine
        vals[0, li["latency_mean_ms"]] = float(np.mean(lat_ms))
        vals[0, li["latency_p50_ms"]] = float(np.percentile(lat_ms, 50))
        vals[0, li["latency_p95_ms"]] = float(np.percentile(lat_ms, 95))
        vals[0, li["latency_p99_ms"]] = float(np.percentile(lat_ms, 99))
        vals[0, li["latency_max_ms"]] = float(np.max(lat_ms))
        vals[0, li["batch_service_ms"]] = 1000.0 * float(np.mean(services)) if services else 0.0
        vals[0, li["batches_per_s"]] = n_batches / window_s
        vals[0, li["events_per_s"]] = e.buffer.stats.total_out / max(self._clock(), 1e-3)
        vals[0, li["queue_depth"]] = len(e.buffer)
        vals[0, li["queue_age_ms"]] = 1000.0 * e.buffer.stats.oldest_age_s
        vals[0, li["drop_count"]] = e.buffer.stats.dropped
        vals[0, li["replay_count"]] = e.buffer.stats.replayed
        vals[0, li["jit_compiles"]] = e.jit_compiles
        vals[0, li["jit_time_s"]] = e.jit_time_s
        vals[0, li["padding_waste_frac"]] = float(np.mean(pads)) if pads else 0.0
        vals[0, li["batch_fill_frac"]] = 1.0 - (float(np.mean(pads)) if pads else 0.0)
        self.store.append(self._clock(), vals)
