"""The 90-metric registry, the per-node series store (a copy of the
reference's; the torch engine summarises windows on the device and does not
use it), the fused loop's and the serve loop's counters and the
launchers' metrics-dump guard."""
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
    "build_registry",
    "flush_guard",
    "retrace_counts",
]
