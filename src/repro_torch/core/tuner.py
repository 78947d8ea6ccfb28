"""End-to-end AutoTuner (paper Figs 1+3), on PyTorch: offline data
generation -> metric selection (FA + k-means) -> lever ranking (Lasso path)
-> online RL tuning.

The port of ``repro.core.tuner``, the composable entry point the launcher
and examples use:

    tuner = AutoTuner(env)           # a SimCluster or a FleetEnv
    tuner.collect(n_windows=200)     # §2.1 random-lever exploration
    tuner.analyse()                  # §2.2 + §2.3
    tuner.configurator.tune(50)      # §2.4 online REINFORCE loop

Every window of collect and tune is a kernel launch on the env's device
(``fleet_tick``, or ``fleet_scan`` under ``window_impl="scan"``); the k-means and the Lasso path (the ``lasso_cd`` kernel) run
on ``device``, the env's device unless named. ``run(epoch_k>1)`` tunes
through the epoch mega-scan (``Configurator.tune_megascan``);
``build_serve_controller`` hands the analysis to the continuous control
plane (``repro_torch.serve.ServeController``).
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from repro_torch.core import lasso as lasso_mod
from repro_torch.core import metrics_selection as msel
from repro_torch.core.configurator import Configurator, TuningEnv, is_fleet_env
from repro_torch.core.discretize import DeviceLeverTable, LeverDiscretiser
from repro_torch.utils import resolve_device


@dataclass
class TrainingMatrix:
    """§2.1 output: metrics × levers along (simulated) time."""

    metric_rows: list = field(default_factory=list)   # per window: dict name->value
    lever_rows: list = field(default_factory=list)    # per window: dict name->value
    target: list = field(default_factory=list)        # per window: p99 latency ms
    target_mean: list = field(default_factory=list)   # per window: mean latency ms
    cluster: list = field(default_factory=list)       # per window: source cluster id
    #                                                   (fleet sweeps; -1 serial)

    def metrics_array(self, names: Sequence[str]) -> np.ndarray:
        return np.array([[row.get(n, np.nan) for n in names]
                         for row in self.metric_rows], float)

    def levers_array(self, specs) -> tuple[np.ndarray, list[str]]:
        """Categorical levers are 'numbered' (paper §2.3); bools -> 0/1."""
        names = [s.name for s in specs]
        out = np.zeros((len(self.lever_rows), len(names)))
        for i, row in enumerate(self.lever_rows):
            for j, s in enumerate(specs):
                v = row.get(s.name, s.default_value())
                if s.kind == "choice":
                    v = s.choices.index(v)
                elif s.kind == "bool":
                    v = float(bool(v))
                out[i, j] = float(v)
        return out, names


class AutoTuner:
    """Glue object for the full paper pipeline over one environment."""

    def __init__(self, env: TuningEnv, *, seed: int = 0,
                 window_s: float = 240.0, top_levers: int = 8, device=None):
        self.env = env
        self.device = resolve_device(
            device if device is not None else getattr(env, "device", None),
            "AutoTuner")
        self.seed = seed
        self.window_s = window_s
        self.top_levers = top_levers
        self.matrix = TrainingMatrix()
        self.selected_metrics: list[str] = []
        self.ranked_levers: list[str] = []
        self.selection: Optional[msel.SelectionResult] = None
        self.configurator: Optional[Configurator] = None
        self._rng = np.random.default_rng(seed)
        #: §2.1 guard bookkeeping: windows where 8 straight proposals were
        #: guard-rejected and the sweep fell back to the cluster's
        #: last-known-good config
        self.guard_exhausted = 0
        #: wall seconds of the last ``analyse``, by stage ("fa": spline
        #: repair, variance filter, FA; "kmeans": the k sweep and the final
        #: clustering; "lasso": the lever ranking), for the phase breakdown
        self.analyse_s: dict = {}

    # -- §2.1 training-data generation ---------------------------------------
    def collect(self, n_windows: int, *, perturb_every: int = 1,
                drop_frac: float = 0.0, windows_per_cluster: int = 12,
                guard: bool = True) -> TrainingMatrix:
        """Run the env with one random single-lever change per window (the
        paper changed one of the 109 levers every 15 simulated minutes).

        The paper's fleet was 80 *independent* clusters: we emulate that by
        resetting the env to defaults every ``windows_per_cluster`` windows —
        without it a single random walk drifts and its latency trend induces
        spurious lever correlations. ``guard`` rejects not-runnable configs
        (the paper: 'some configurations were not allowed ... to make sure
        all configurations resulted in runnable conditions').
        ``drop_frac`` randomly NaNs metric entries to exercise spline repair.

        Against a ``FleetTuningEnv`` the sweep runs the paper's actual shape:
        every cluster perturbs its own random lever each window and all
        clusters advance in one batched call, yielding n_clusters matrix rows
        per round (``_collect_fleet``)."""
        if is_fleet_env(self.env):
            return self._collect_fleet(
                n_windows, perturb_every=perturb_every, drop_frac=drop_frac,
                windows_per_cluster=windows_per_cluster, guard=guard)
        disc = LeverDiscretiser(list(self.env.lever_specs), seed=self.seed)
        config = self.env.current_config()
        specs = list(self.env.lever_specs)
        for w in range(n_windows):
            if windows_per_cluster and w % windows_per_cluster == 0:
                self.env.reset()
                config = self.env.current_config()
            if w % perturb_every == 0:
                for _ in range(8):  # retry guard-rejected proposals
                    s = specs[self._rng.integers(len(specs))]
                    direction = int(self._rng.choice([-1, 1]))
                    proposal = disc.apply(config, s.name, direction)
                    if not guard or self._runnable(proposal):
                        config = proposal
                        break
                else:
                    # 8 straight rejections: observe this window under the
                    # last-known-good config (config is the last accepted
                    # one) and count it
                    self.guard_exhausted += 1
                self.env.apply_config(config)
                stab = self.env.stabilisation_time()
                if stab > 0:  # paper §2.2: the 4-min sample average is taken
                    # after the change stabilises (summaries unread -> advance)
                    getattr(self.env, "advance", self.env.observe)(stab)
            window = self.env.observe(self.window_s)
            row = self._metric_row(window)
            if drop_frac:
                for m in list(row):
                    if self._rng.uniform() < drop_frac:
                        row[m] = np.nan
            self.matrix.metric_rows.append(row)
            self.matrix.lever_rows.append(dict(config))
            self.matrix.target.append(window.p99_ms)
            self.matrix.target_mean.append(
                float(np.mean(window.latencies_ms)) if window.latencies_ms.size
                else np.nan)
            self.matrix.cluster.append(-1)
        return self.matrix

    def _collect_fleet(self, n_windows: int, *, perturb_every: int = 1,
                       drop_frac: float = 0.0, windows_per_cluster: int = 12,
                       guard: bool = True) -> TrainingMatrix:
        """§2.1 over a FleetTuningEnv: the paper's 80-cluster sweep, batched.

        The sweep walks the same *integerised* lever representation as the
        fused device training loop (``DeviceLeverTable``, DESIGN.md §10): the
        fleet's configs are one (N, L) int index array, a round proposes one
        random (lever, direction) per cluster via pure index arithmetic and
        decodes only the moved lever (bin centre + ridge jitter), the guard
        rejects non-runnable configs fleet-wide in one vectorised call, and
        the whole fleet is applied/stabilised/observed together — n_clusters
        matrix rows per round. The §2.4.1 bin adaptation stays live: every
        proposal is recorded into a fleet-shared ``LeverDiscretiser`` oracle
        (the same sharing the online Configurator uses) and the table is
        re-packed from the adapted binning whenever it changes, so the walk
        keeps WIDENING (extend) and coarsening (merge) like the dict-based
        sweep did. The split rule is off here: a fleet-shared oracle sees
        every cluster's proposals, and the periodic resets-to-default make
        same-bin streaks common, so splitting would keep halving the bins
        around the defaults and shrink the very lever deltas the Lasso needs
        (per-cluster oracles never hit this — their streaks were rare).
        Clusters reset to defaults every ``windows_per_cluster`` rounds
        exactly like the serial emulation."""
        env = self.env
        N = env.n_clusters
        specs = list(env.lever_specs)
        disc = LeverDiscretiser(specs, seed=self.seed, split_after=10**9)
        table = DeviceLeverTable.from_discretiser(disc)

        def bins_sig():
            return tuple(d._edges.tobytes() for d in disc.bins.values())

        sig = bins_sig()
        L = table.n_levers
        rounds = -(-n_windows // N)  # ceil
        rows_added = 0
        configs = env.current_configs()
        idx = table.index_configs(configs)
        for w in range(rounds):
            if windows_per_cluster and w % windows_per_cluster == 0:
                env.reset()
                configs = env.current_configs()
                idx = table.index_configs(configs)
            if w % perturb_every == 0:
                cand = list(configs)
                changed: list = [()] * N
                pending = list(range(N))
                for _ in range(8):  # retry guard-rejected proposals
                    if not pending:
                        break
                    p = np.asarray(pending)
                    li = self._rng.integers(L, size=p.size)
                    dirs = self._rng.choice([-1, 1], size=p.size)
                    bins = table.step_index(idx[p, li], li, dirs)
                    for j, i in enumerate(p):
                        name = table.names[li[j]]
                        dyn = disc.bins.get(name)
                        if dyn is not None:  # adapt on proposal, like apply()
                            dyn.record(int(bins[j]))
                        c = dict(configs[i])
                        c[name] = table.value_of(int(li[j]), int(bins[j]),
                                                 self._rng)
                        cand[i] = c
                    ok = (env.runnable_mask(cand) if guard
                          else np.ones(N, bool))
                    still = []
                    for j, i in enumerate(p):
                        if ok[i]:
                            configs[i] = cand[i]
                            idx[i, li[j]] = bins[j]
                            changed[i] = (table.names[li[j]],)
                        else:
                            cand[i] = configs[i]
                            still.append(i)
                    pending = still
                # clusters still pending after 8 tries observe this window
                # under their last-known-good config — counted, not silent
                self.guard_exhausted += len(pending)
                env.apply_configs(configs, changed_levers=changed)
                new_sig = bins_sig()
                if new_sig != sig:  # split/extend/merge happened: re-pack
                    table = DeviceLeverTable.from_discretiser(disc)
                    idx = table.index_configs(configs)
                    sig = new_sig
                stabs = env.stabilisation_times()
                env.advance(stabs)  # paper §2.2: sample average taken after
                #                     the change stabilises
            windows = env.observe(self.window_s)
            for i, window in enumerate(windows):
                if rows_added >= n_windows:
                    break  # honour the requested budget when N ∤ n_windows
                row = self._metric_row(window)
                if drop_frac:
                    for m in list(row):
                        if self._rng.uniform() < drop_frac:
                            row[m] = np.nan
                self.matrix.metric_rows.append(row)
                self.matrix.lever_rows.append(dict(configs[i]))
                self.matrix.target.append(window.p99_ms)
                self.matrix.target_mean.append(
                    float(np.mean(window.latencies_ms))
                    if window.latencies_ms.size else np.nan)
                self.matrix.cluster.append(i)
                rows_added += 1
        return self.matrix

    def _metric_row(self, window) -> dict:
        """Window -> {metric: node-mean}. Uses the env's dense (nodes,
        metrics) matrix when present — one array reduction instead of 90
        per-metric nanmeans (the §2.1 sweep's former hot spot)."""
        if getattr(window, "node_matrix", None) is not None:
            means = window.node_matrix.mean(axis=0)
            return {m: float(v)
                    for m, v in zip(self.env.metric_names, means)}
        return {m: float(np.nanmean(window.per_node[m]))
                for m in self.env.metric_names}

    def _runnable(self, config: dict) -> bool:
        """Paper's allow-list: a config must keep the engine schedulable.
        Uses the env's own service estimate when it exposes one."""
        terms_fn = getattr(self.env, "_service_terms", None)
        if terms_fn is None:
            return True
        rate = self.env.workload.rate(getattr(self.env, "clock", 0.0))
        size = self.env.workload.mean_size(getattr(self.env, "clock", 0.0))
        old = self.env.config
        try:
            self.env.config = config
            service = terms_fn(rate, size)["service"]
        finally:
            self.env.config = old
        T_b = float(config["batch_interval_s"])
        batch = min(rate * T_b, float(config.get("max_batch_events", np.inf)))
        throughput = batch / max(service, T_b)
        return service <= 2.5 * T_b and throughput >= 0.7 * rate

    # -- §2.2 + §2.3 analysis ---------------------------------------------------
    def analyse(self, *, k: Optional[int] = None, lasso_degree: int = 2,
                interactions: bool = False, log_target: bool = True,
                target: str = "mean",
                demean_clusters: bool = False) -> tuple[list[str], list[str]]:
        """§2.2 + §2.3. ``target`` is the Lasso objective: the windowed 'mean'
        latency (default — far lower variance across 4-min windows) or 'p99'
        (the SLO the RL reward tracks; both move together in this engine).

        ``demean_clusters`` subtracts each source cluster's mean (log-)target
        before the Lasso fit: on heterogeneous fleets the per-cluster arrival
        rate is an unmodelled covariate whose between-cluster offsets dwarf
        the within-cluster lever signal, so the pooled regression can rank
        inert levers first (the §4.4/§4.5 mixed-fleet confound). Demeaning
        is the fixed-effects estimator for exactly that structure; it is a
        no-op on single-cluster matrices."""
        names = list(self.env.metric_names)
        X = self.matrix.metrics_array(names)
        t0 = time.perf_counter()
        self.selection = msel.select_metrics(X, names, seed=self.seed, k=k,
                                             device=self.device,
                                             stage_s=self.analyse_s)
        self.selected_metrics = self.selection.kept_names

        t1 = time.perf_counter()
        R, yk, lever_names = self.lasso_inputs(
            target=target, log_target=log_target,
            demean_clusters=demean_clusters)
        self.ranked_levers = lasso_mod.rank_levers(
            R, yk, lever_names, degree=lasso_degree,
            interactions=interactions, top=self.top_levers,
            device=self.device)
        self.analyse_s["lasso"] = time.perf_counter() - t1
        self.analyse_s["total"] = time.perf_counter() - t0
        return self.selected_metrics, self.ranked_levers

    def lasso_inputs(self, *, target: str = "mean", log_target: bool = True,
                     demean_clusters: bool = False
                     ) -> tuple[np.ndarray, np.ndarray, list[str]]:
        """The §2.3 regression ``analyse`` ranks levers on: the numbered
        lever matrix R and the (log-)target y over the windows whose target
        is finite, and the lever names."""
        R, lever_names = self.matrix.levers_array(self.env.lever_specs)
        raw = self.matrix.target_mean if target == "mean" else self.matrix.target
        y = np.asarray(raw, float)
        if target == "mean" and not len(y):  # legacy matrices
            y = np.asarray(self.matrix.target, float)
        keep = np.isfinite(y)
        yk = np.log(np.maximum(y[keep], 1e-3)) if log_target else y[keep]
        if demean_clusters and len(self.matrix.cluster) == len(y):
            cid = np.asarray(self.matrix.cluster)[keep]
            for c in np.unique(cid):
                rows = cid == c
                yk = np.where(rows, yk - yk[rows].mean(), yk)
        return R[keep], yk, lever_names

    # -- §2.4 online loop ----------------------------------------------------------
    def build_configurator(self, **kw) -> Configurator:
        assert self.selected_metrics and self.ranked_levers, "run analyse() first"
        kw.setdefault("device", self.device)
        self.configurator = Configurator(
            self.env, self.selected_metrics, self.ranked_levers,
            seed=self.seed, **kw)
        return self.configurator

    def build_serve_controller(self, workloads, **kw):
        """§13 handoff from offline analysis to the continuous control
        plane: the tuner's selected metrics + ranked levers seed a
        ``ServeController`` whose shadow fleet keeps training forever, on
        the tuner's device and, when the tuner's env is a fleet, on its
        window impl. ``workloads`` is the serve-time workload roster (one
        per shadow cluster); remaining kwargs pass through to the
        controller."""
        assert self.selected_metrics and self.ranked_levers, "run analyse() first"
        from repro_torch.serve import ServeController
        kw.setdefault("seed", self.seed)
        kw.setdefault("device", self.device)
        if hasattr(self.env, "window_impl"):
            kw.setdefault("window_impl", self.env.window_impl)
        return ServeController(workloads, metrics=self.selected_metrics,
                               levers=self.ranked_levers, **kw)

    def run(self, n_updates: int, *, collect_windows: int = 120,
            configurator_kw: Optional[dict] = None, callback=None,
            epoch_k: int = 1, records: str = "full"):
        """collect -> analyse -> tune, in one call (examples/launcher).

        ``epoch_k > 1`` switches the online loop to the epoch mega-scan
        (DESIGN.md §15): updates run in epochs of ``epoch_k`` through
        ``Configurator.tune_megascan`` — the callback still fires per
        update, but only at epoch boundaries. Requires the fused device
        loop."""
        if not self.matrix.metric_rows:
            self.collect(collect_windows)
        if not self.ranked_levers:
            self.analyse()
        if self.configurator is None:
            self.build_configurator(**(configurator_kw or {}))
        if epoch_k > 1:
            return self.configurator.tune_megascan(
                n_updates, k=epoch_k, records=records, callback=callback)
        return self.configurator.tune(n_updates, callback=callback)

    # -- persistence -------------------------------------------------------------
    def save_analysis(self, path: str | Path) -> None:
        out = {
            "selected_metrics": self.selected_metrics,
            "ranked_levers": self.ranked_levers,
            "n_factors": self.selection.n_factors if self.selection else None,
            "k": self.selection.k if self.selection else None,
            "reduction": self.selection.reduction if self.selection else None,
            "guard_exhausted": self.guard_exhausted,
        }
        Path(path).write_text(json.dumps(out, indent=2))

    def load_analysis(self, path: str | Path) -> None:
        d = json.loads(Path(path).read_text())
        self.selected_metrics = d["selected_metrics"]
        self.ranked_levers = d["ranked_levers"]
