"""The simulated stream-processing fleet: lever specs, the fleet model and
the torch device engine."""
from repro_torch.engine.fleet import FleetEnv
from repro_torch.engine.levers import EFFECTIVE, LEVER_NAMES, LEVER_SPECS, build_lever_specs
from repro_torch.engine.simcluster import FleetCore, SimSpec

__all__ = [
    "EFFECTIVE",
    "FleetCore",
    "FleetEnv",
    "LEVER_NAMES",
    "LEVER_SPECS",
    "SimSpec",
    "build_lever_specs",
]
