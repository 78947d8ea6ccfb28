"""Continuous-tuning control plane (DESIGN.md §13) on PyTorch.

The batch tuner (``launch/tune.py``) explores, finds a good config, prints
it and exits; the serve path keeps the fused Algorithm-1 loop running
forever and decides *when a candidate is allowed to touch the serving
fleet*: each cycle shadows candidates on a replica fleet, canary-evaluates
the best one against the incumbent on matched workloads, promotes only
after K consecutive margin wins, and rolls back the moment the canary
breaches the SLO — ContTune's conservative continuous tuning
(arXiv 2309.12239) around the port's captured training loop.
"""
from repro_torch.serve.canary import CanaryGate
from repro_torch.serve.controller import ServeController
from repro_torch.serve.history import EpisodeStore, workload_features

__all__ = ["CanaryGate", "ServeController", "EpisodeStore",
           "workload_features"]
