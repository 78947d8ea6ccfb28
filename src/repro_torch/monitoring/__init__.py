"""The 90-metric registry, the per-node series stores (copies of the
reference's: ``TimeSeriesStore`` holds ``LocalEngine``'s windows; the torch
fleet engine summarises windows on the device and uses neither), the fused
loop's and the serve loop's counters and the launchers' metrics-dump
guard."""
from repro_torch.monitoring.metrics import (
    DRIVER_METRICS,
    METRIC_NAMES,
    REGISTRY,
    WORKER_METRICS,
    ChaosCounters,
    FleetSeriesStore,
    MetricDef,
    ServeCounters,
    ShieldCounters,
    TimeSeriesStore,
    build_registry,
    flush_guard,
    retrace_counts,
)

__all__ = [
    "DRIVER_METRICS",
    "METRIC_NAMES",
    "REGISTRY",
    "WORKER_METRICS",
    "ChaosCounters",
    "FleetSeriesStore",
    "MetricDef",
    "ServeCounters",
    "ShieldCounters",
    "TimeSeriesStore",
    "build_registry",
    "flush_guard",
    "retrace_counts",
]
