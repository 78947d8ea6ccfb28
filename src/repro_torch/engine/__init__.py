"""The stream-processing engine: the real micro-batch engine
(``StreamEngine``) with its queue and sink and its wall-clock tuning
environment (``LocalEngine``), and the simulated fleet (lever
specs, the fleet model and the torch device engine, and its serial N=1
view ``SimCluster``)."""
from repro_torch.engine.engine import BatchReport, EngineConfig, StreamEngine
from repro_torch.engine.fleet import FleetEnv
from repro_torch.engine.levers import EFFECTIVE, LEVER_NAMES, LEVER_SPECS, build_lever_specs
from repro_torch.engine.local import LOCAL_LEVERS, LocalEngine
from repro_torch.engine.queue import EventBuffer, IdempotentSink
from repro_torch.engine.simcluster import FleetCore, MetricsWindowData, SimCluster, SimSpec

__all__ = [
    "BatchReport",
    "EFFECTIVE",
    "EngineConfig",
    "EventBuffer",
    "FleetCore",
    "FleetEnv",
    "IdempotentSink",
    "LEVER_NAMES",
    "LEVER_SPECS",
    "LOCAL_LEVERS",
    "LocalEngine",
    "MetricsWindowData",
    "SimCluster",
    "SimSpec",
    "StreamEngine",
    "build_lever_specs",
]
