"""The 90-metric registry, the per-node series store (a copy of the
reference's; the torch engine summarises windows on the device and does not
use it) and the fused loop's counters."""
from repro_torch.monitoring.metrics import (
    DRIVER_METRICS,
    METRIC_NAMES,
    REGISTRY,
    WORKER_METRICS,
    ChaosCounters,
    FleetSeriesStore,
    MetricDef,
    ShieldCounters,
    build_registry,
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
    "ShieldCounters",
    "build_registry",
    "retrace_counts",
]
