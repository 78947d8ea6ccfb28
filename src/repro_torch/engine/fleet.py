"""FleetEnv — the fleet-parallel simulation layer (DESIGN.md §2a).

The paper's offline phase explores lever space on ~80 EC2 clusters running in
parallel. ``FleetEnv`` reproduces that shape in simulation: N independent
cluster states — heterogeneous workloads, models and seeds — stepped in a
single batched call. All queueing/performance maths are vectorised over the
cluster axis (``repro_torch.engine.simcluster.FleetCore``), and every window
is one launch of a hand-written CUDA kernel on ``device`` (DESIGN.md §9):
``fleet_tick`` with its latency lanes under ``window_impl="kernel"`` (the
default; the reference's ``backend="pallas"``), the lane-free
``fleet_scan`` under ``"scan"`` (its ``backend="jax"``), or the one a timed
probe picks under ``"auto"``. *Statistically* equivalent to the
reference's bit-for-bit numpy oracle, and the only way to 1024-cluster
fleets.

API shape (the plural twin of ``TuningEnv``; the reference's
``repro.core.configurator.FleetTuningEnv`` protocol). ``device=None``
resolves to ``cuda`` and raises without a card; ``device="cpu"`` runs the
kernels' plain torch versions:

    env = FleetEnv.heterogeneous(1024, seed=0)   # mixed workloads, on cuda
    reports = env.apply_configs(configs)         # one config per cluster
    stabs = env.stabilisation_times()            # (N,) seconds
    windows = env.observe(stabs)                 # per-cluster window views
    stats = env.observe_stats(240.0)             # device-resident tensors

``backend`` keeps the reference's keyword; the port takes only ``"torch"``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.discretize import LeverSpec
from repro_torch.data.workloads import PoissonWorkload, Workload, fleet_workloads
from repro_torch.engine.levers import LEVER_SPECS
from repro_torch.engine.simcluster import FleetCore, SimSpec


class FleetEnv(FleetCore):
    """N simulated clusters stepped as one batch (the paper's 80-cluster sweep)."""

    def __init__(
        self,
        workloads: Optional[Sequence[Workload]] = None,
        models: Optional[Sequence[ModelConfig]] = None,
        *,
        n: Optional[int] = None,
        model: Optional[ModelConfig] = None,
        spec: Optional[SimSpec] = None,
        lever_specs: Optional[Sequence[LeverSpec]] = None,
        seeds: Optional[Sequence[int]] = None,
        seed: int = 0,
        backend: str = "torch",
        faults=None,
        device=None,
        window_impl: str = "kernel",
    ):
        from repro_torch import configs

        if workloads is None:
            workloads = [PoissonWorkload(10_000, 0.5) for _ in range(n or 8)]
        workloads = list(workloads)
        n = len(workloads)
        if models is None:
            base = model or configs.get("smollm_135m")
            models = [base] * n
        if seeds is None:
            seeds = [seed + i for i in range(n)]
        assert len(models) == n and len(list(seeds)) == n
        super().__init__(workloads, list(models), spec or SimSpec(),
                         list(lever_specs or LEVER_SPECS), list(seeds),
                         backend=backend, faults=faults, device=device,
                         window_impl=window_impl)

    # ------------------------------------------------------------ constructors
    @classmethod
    def homogeneous(cls, n: int, workload_factory=None, *, seed: int = 0,
                    **kw) -> "FleetEnv":
        """N identical-workload clusters with distinct seeds (the serial-loop
        baseline's natural batched twin)."""
        factory = workload_factory or (lambda i: PoissonWorkload(10_000, 0.5))
        return cls([factory(i) for i in range(n)], seed=seed, **kw)

    @classmethod
    def heterogeneous(cls, n: int, *, seed: int = 0, mix=None, **kw) -> "FleetEnv":
        """N clusters over the deterministic mixed-workload roster
        (``repro_torch.data.workloads.fleet_workloads``), mimicking the paper's
        fleet of differently-loaded production clusters."""
        return cls(fleet_workloads(n, seed=seed, mix=mix), seed=seed, **kw)

    # ----------------------------------------------------------------- env API
    @property
    def n_clusters(self) -> int:
        return self.n

    def current_configs(self) -> list[dict]:
        return [dict(c) for c in self.configs]

    def observe(self, window_s, preroll_s=None) -> list:
        """Advance all clusters; ``window_s`` is a scalar or an (N,) array of
        per-cluster windows (e.g. per-cluster stabilisation times).
        ``preroll_s`` prepends a stabilisation wait excluded from the window
        (fused into the same device window). Returns one lazy window view per
        cluster (``p99_ms``, ``mean_ms``, ``per_node``, ...)."""
        return self.observe_fleet(window_s, preroll_s=preroll_s)

    def advance(self, window_s) -> None:
        """observe() minus the unread window summaries (stabilisation waits)."""
        self.advance_fleet(window_s)

    def observe_stats(self, window_s, preroll_s=None) -> dict:
        """``observe`` as fleet-shaped arrays (mean/p99/processed/per_node)
        instead of N window objects; nothing is pulled from the device until
        the caller reads an array, and an optional
        stabilisation ``preroll_s`` fuses the §4.2 wait into the same device
        program (DESIGN.md §9)."""
        return self.observe_fleet_stats(window_s, preroll_s=preroll_s)

    def prewarm(self, window_s: float = 240.0) -> None:
        """Build the window kernel and run the window-shape ladder up front,
        so exploration never meets a first-call stall; state- and
        RNG-transparent (``DeviceFleetEngine.prewarm``)."""
        self._dev.prewarm(window_s)

    def runnable_mask(self, configs: Sequence[dict]) -> np.ndarray:
        """(N,) bool — which candidate configs the paper's allow-list accepts."""
        return self.runnable(configs)

    def clocks(self) -> np.ndarray:
        return self.clock.copy()
