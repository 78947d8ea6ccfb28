"""RL configuration feedback loop (paper Fig 3 bottom, §3, §4.2), on PyTorch.

The port of ``repro.core.configurator``: the ``Configurator`` drives the
paper's episode loop — observe heat-maps -> pick (lever, direction) ->
discretise -> apply config -> buffer events during loading -> wait for
stabilisation -> measure latency -> reward -> (end of episode) REINFORCE
update — against a ``TuningEnv`` (the serial ``SimCluster``) or a
``FleetTuningEnv`` (``FleetEnv(backend="torch")``).

Over a fleet whose workloads the device rate grid can pack, ``run_update``
runs the fused device loop (``repro_torch.core.device_loop``, captured CUDA
graphs on the card), as do ``tune_pipelined`` (§14) and ``run_epoch`` /
``tune_megascan`` (§15), which need it; otherwise,
or with ``device_loop="off"``, the per-step host loops: ``run_episode``
(serial) and ``run_fleet_episodes`` (N parallel episodes, acting on the
device). Every observation window is one kernel launch either way:
``fleet_tick``, or ``fleet_scan`` on a ``window_impl="scan"`` fleet. ``safe=True`` (DESIGN.md §16) runs the safety shield on both fleet
paths: inside the fused loop's episode, and as its numpy twin in
``run_fleet_episodes``, which walks the same integerised lever table with
the same mask, clamp, fallback and budget recurrence.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional, Protocol, Sequence

import numpy as np
import torch

from repro_torch.core.discretize import (DeviceLeverTable, LeverDiscretiser,
                                         LeverSpec, ShieldSpec, shield_update)
from repro_torch.core.heatmap import HeatmapEncoder, HeatmapSpec
from repro_torch.core.policy import ReinforceAgent, Trajectory


class MetricsWindow(Protocol):
    per_node: dict[str, np.ndarray]   # metric -> (n_nodes,) window average
    latencies_ms: np.ndarray          # per-event end-to-end latency sample
    p99_ms: float
    clock_s: float                    # environment clock (simulated or real)


class TuningEnv(Protocol):
    """Implemented by repro_torch.engine.simcluster.SimCluster."""

    lever_specs: Sequence[LeverSpec]
    metric_names: Sequence[str]
    n_nodes: int

    def reset(self) -> None: ...
    def current_config(self) -> dict: ...
    def apply_config(self, config: dict) -> dict:
        """Install a config. Returns {'load_s': float, 'rebooted': bool}."""
    def observe(self, window_s: float) -> MetricsWindow:
        """Advance the environment by window_s and return the window metrics."""
    def stabilisation_time(self) -> float:
        """Seconds until latency variance trend flattens (paper: <3 min p99)."""


class FleetTuningEnv(Protocol):
    """The plural twin of ``TuningEnv``: N clusters stepped as one batch
    (repro_torch.engine.fleet.FleetEnv). The configurator runs the
    Algorithm-1 episode batch as N *parallel* episodes — one per cluster —
    and the tuner's §2.1 exploration sweeps the whole fleet per window."""

    lever_specs: Sequence[LeverSpec]
    metric_names: Sequence[str]
    n_nodes: int
    n_clusters: int

    def reset(self) -> None: ...
    def current_configs(self) -> list[dict]: ...
    def apply_configs(self, configs: Sequence[dict],
                      changed_levers: Optional[Sequence] = None,
                      copy: bool = True) -> list[dict]:
        """Install one config per cluster; list of {'load_s', 'rebooted'}.
        ``changed_levers`` optionally names each cluster's moved levers so
        the env can skip the full config diff; ``copy=False`` hands over
        ownership of the dicts."""
    def observe(self, window_s, preroll_s=None) -> list[MetricsWindow]:
        """Advance all clusters by window_s (scalar or per-cluster array);
        ``preroll_s`` prepends a stabilisation wait excluded from the
        window (fused into the same kernel launch)."""
    def advance(self, window_s) -> None:
        """observe() without building window summaries (stabilisation waits)."""
    def stabilisation_times(self) -> np.ndarray:
        """(N,) seconds until each cluster's latency trend flattens."""
    def runnable_mask(self, configs: Sequence[dict]) -> np.ndarray:
        """(N,) bool — the paper's allow-list, vectorised."""


def is_fleet_env(env) -> bool:
    """True when env speaks the batched FleetTuningEnv protocol (any N ≥ 1)."""
    return getattr(env, "n_clusters", 0) >= 1 and hasattr(env, "apply_configs")


@dataclass
class StepRecord:
    lever: str
    direction: int
    config: dict
    reward: float
    p99_ms: float
    clock_s: float
    phases: dict  # generation/loading/stabilisation/update seconds


@dataclass
class EpisodeResult:
    steps: list[StepRecord]
    mean_return: float


def reward_from_latency(latencies_ms: np.ndarray, mode: str = "neg_mean", *,
                        slo_ms: float = 1000.0, hinge_w: float = 1.0,
                        breach_w: float = 1.0) -> float:
    """Paper's delay-dependent reward: -mean(T) by default (the text's
    cumulative reward is negative summed latency at gamma=1), ``neg_p99``,
    ``neg_sum``, the literal ``neg_inv`` Σ -1/T, or ``slo`` (DESIGN.md
    §12): -mean latency, minus a hinge penalty when the window p99
    breaches ``slo_ms``, minus the fraction of latency samples above it."""
    lat = np.asarray(latencies_ms, float)
    lat = lat[np.isfinite(lat) & (lat > 0)]
    if lat.size == 0:
        return -1e4  # failed window: strongly negative
    if mode == "neg_mean":
        return float(-lat.mean() / 1000.0)
    if mode == "neg_p99":
        return float(-np.percentile(lat, 99.0) / 1000.0)
    if mode == "neg_sum":
        return float(-lat.sum() / 1000.0)
    if mode == "neg_inv":  # the literal Σ -1/T form from the paper text
        return float(np.sum(-1.0 / np.maximum(lat, 1e-3)))
    if mode == "slo":
        p99 = float(np.percentile(lat, 99.0))
        breach = float((lat > slo_ms).mean())
        return float(-lat.mean() / 1000.0
                     - hinge_w * max(p99 - slo_ms, 0.0) / 1000.0
                     - breach_w * breach)
    raise ValueError(mode)


class Configurator:
    """Paper §3: runs tuning phases made of episodes of N configuration steps.

    ``device_loop`` selects the §10 fused training loop over a torch fleet:
    ``"auto"`` (default) uses it whenever ``device_loop_reason()`` is None,
    ``"on"`` fails loudly when it can't, ``"off"`` always runs the per-step
    host loop. ``device`` is where the policy lives; it defaults to the
    env's device.

    ``mesh`` shards the fused loop's cluster axis across the ranks of a
    ``torch.distributed`` process group (DESIGN.md §11): ``"auto"``
    (default) uses ``repro_torch.distribution.sharding.fleet_mesh()``
    whenever the fleet size divides the world size, ``"off"``/None pins one
    device, or pass an explicit 1-D ``DeviceMesh``. Every rank builds the
    same configurator over the same whole fleet.

    ``reward_mode="slo"`` (DESIGN.md §12) shapes the reward against a
    latency SLO: ``slo_ms`` is the p99 target, ``slo_hinge_w`` weights the
    hinge penalty on a window-p99 breach and ``slo_breach_w`` the
    breach-duration term (computed on device per window).

    ``safe=True`` (DESIGN.md §16, needs ``reward_mode="slo"``) shields
    exploration: trust-region masked sampling, the clamp, fallback to the
    last-known-good config and a per-episode breach budget, with
    ``shield_kw`` the ``ShieldSpec`` fields."""

    def __init__(
        self,
        env,
        selected_metrics: Sequence[str],
        ranked_levers: Sequence[str],
        *,
        f_exploit: float = 0.8,
        gamma: float = 1.0,
        lr: float = 1e-3,
        steps_per_episode: int = 10,
        episodes_per_update: int = 4,
        window_s: float = 120.0,
        reward_mode: str = "neg_mean",
        slo_ms: float = 1000.0,
        slo_hinge_w: float = 1.0,
        slo_breach_w: float = 1.0,
        seed: int = 0,
        bin_kw: Optional[dict] = None,
        device_loop: str = "auto",
        mesh="auto",
        safe: bool = False,
        shield_kw: Optional[dict] = None,
        device=None,
    ):
        assert device_loop in ("auto", "on", "off"), device_loop
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch.utils import resolve_device

        if mesh not in ("auto", "off", None) and not isinstance(mesh,
                                                                DeviceMesh):
            raise TypeError(f"mesh={mesh!r}: 'auto', 'off', None or a 1-D "
                            "torch.distributed DeviceMesh")
        self.env = env
        self.fleet = is_fleet_env(env)
        self.device_loop = device_loop
        self.mesh_opt = mesh
        self.device = resolve_device(
            device if device is not None else getattr(env, "device", None),
            "Configurator")
        self._runner = None            # lazy DeviceEpisodeRunner (§10)
        self.levers = [l for l in ranked_levers if l in {s.name for s in env.lever_specs}]
        assert self.levers, "no ranked lever matches the environment's lever set"
        self.disc = LeverDiscretiser(list(env.lever_specs), seed=seed,
                                     **(bin_kw or {}))
        self.hspec = HeatmapSpec(list(selected_metrics), list(self.levers),
                                 env.n_nodes)
        self.encoder = HeatmapEncoder(self.hspec)
        self.agent = ReinforceAgent(
            self.hspec.state_dim, self.levers, device=self.device,
            f_exploit=f_exploit, gamma=gamma, lr=lr, seed=seed)
        self.steps_per_episode = steps_per_episode
        self.episodes_per_update = episodes_per_update
        self.window_s = window_s
        self.reward_mode = reward_mode
        self.slo_ms = float(slo_ms)
        self.slo_hinge_w = float(slo_hinge_w)
        self.slo_breach_w = float(slo_breach_w)
        #: §16 safety shield: None = unshielded exploration, a ShieldSpec =
        #: the shield on the fused loop and on the host loop's numpy twin
        self.shield = ShieldSpec(**(shield_kw or {})) if safe else None
        if self.shield is not None and reward_mode != "slo":
            raise ValueError(
                "safe exploration needs reward_mode='slo': the shield's "
                "breach-risk carry reads the window breach fraction")
        from repro_torch.monitoring.metrics import ShieldCounters
        self.shield_counters = ShieldCounters()
        self._host_shield = None   # numpy twin carry (sig, lkg, radius, ...)
        self.history: list[StepRecord] = []
        self._last_window: Optional[MetricsWindow] = None
        self._last_fleet_windows: Optional[list] = None
        try:  # selected-metric columns in registry order (dense encodes)
            self._sel_cols = [list(env.metric_names).index(m)
                              for m in self.hspec.metric_names]
        except ValueError:
            self._sel_cols = None

    # -- state encoding -------------------------------------------------------
    def _lever_fracs(self, config: dict) -> dict[str, float]:
        out = {}
        for name in self.levers:
            spec = self.disc.specs[name]
            if spec.kind == "choice":
                out[name] = spec.choices.index(config[name]) / max(len(spec.choices) - 1, 1)
            elif spec.kind == "bool":
                out[name] = float(bool(config[name]))
            else:
                dyn = self.disc.bins[name]
                out[name] = dyn.bin_of(float(config[name])) / max(dyn.n_bins - 1, 1)
        return out

    def _encode(self, window, config: dict) -> np.ndarray:
        return self.encoder.encode(window.per_node, self._lever_fracs(config))

    def _encode_fleet(self, windows, configs) -> np.ndarray:
        """(N, state_dim) fleet state batch with ONE running-range update for
        the whole fleet (``HeatmapEncoder.encode_fleet``) — the
        normalisation the fused device loop computes on device."""
        mats = [getattr(w, "node_matrix", None) for w in windows]
        if self._sel_cols is None or any(m is None for m in mats):
            return np.stack([self._encode(w, c)
                             for w, c in zip(windows, configs)])
        raw = np.stack(mats)[:, :, self._sel_cols]       # (N, nodes, M_sel)
        fracs = np.array([[self._lever_fracs(c)[l] for l in self.levers]
                          for c in configs])
        return self.encoder.encode_fleet(raw, fracs)

    # -- the per-step host loops ------------------------------------------
    def run_episode(self, *, explore: bool = True
                    ) -> tuple[Trajectory, list[StepRecord]]:
        """One serial episode: each step acts on the host (``agent.act``),
        applies the move, waits for stabilisation and rewards the window
        after it (paper §4.2)."""
        traj = Trajectory()
        records: list[StepRecord] = []
        config = self.env.current_config()
        window = self._last_window or self.env.observe(self.window_s)
        for _ in range(self.steps_per_episode):
            state = self._encode(window, config)
            t0 = time.perf_counter()
            a = self.agent.act(state, explore=explore)
            lever, direction = self.agent.action_decode(a)
            gen_s = time.perf_counter() - t0

            new_config = self.disc.apply(config, lever, direction)
            report = self.env.apply_config(new_config)
            stab_s = self.env.stabilisation_time()
            if stab_s > 0:
                # the reward is measured on the window AFTER stabilisation,
                # so skip summaries when the env can
                getattr(self.env, "advance", self.env.observe)(stab_s)
            window = self.env.observe(self.window_s)
            reward = reward_from_latency(window.latencies_ms, self.reward_mode,
                                         slo_ms=self.slo_ms,
                                         hinge_w=self.slo_hinge_w,
                                         breach_w=self.slo_breach_w)

            traj.add(state, a, reward)
            records.append(StepRecord(
                lever=lever, direction=direction, config=dict(new_config),
                reward=reward, p99_ms=window.p99_ms, clock_s=window.clock_s,
                phases={"generation_s": gen_s, "loading_s": report["load_s"],
                        "stabilisation_s": stab_s, "update_s": 0.0},
            ))
            config = new_config
        self._last_window = window
        return traj, records

    def run_fleet_episodes(self, *, explore: bool = True
                           ) -> tuple[list[Trajectory], list[StepRecord]]:
        """Algorithm 1's episode batch as N *parallel* episodes — one per
        fleet cluster — stepped from the host: each step samples all N
        actions on the device (``act_batch_device``), applies the moves
        through the host ``LeverDiscretiser``, and observes the whole fleet
        with the §4.2 stabilisation wait fused into the window (one
        window kernel launch a step). ``neg_mean``/``neg_p99`` rewards read
        the window's device statistic; other modes draw each cluster's
        latency sample on the host.

        Under ``safe=True`` this is the fused loop's shield as a numpy twin:
        it walks the same integerised table (frozen for the episode, the
        §2.4.1 replay at its end), with the same mask, clamp, fallback and
        budget recurrence, and carries LKG, radius, streak and risk across
        episodes, keyed on the bin-edge signature. Its breach signal is the
        fraction of each window's latency sample above the SLO."""
        env = self.env
        N = env.n_clusters
        trajs = [Trajectory() for _ in range(N)]
        records: list[list[StepRecord]] = [[] for _ in range(N)]
        configs = env.current_configs()
        windows = self._last_fleet_windows or env.observe(self.window_s)
        spec = self.shield
        if spec is not None:
            table = DeviceLeverTable.from_discretiser(self.disc)
            names = table.names
            ranked = np.asarray([table.index_of[n] for n in self.levers])
            idx = table.index_configs(configs)
            rows = np.arange(N)
            sig = tuple(e.tobytes() if e is not None else b""
                        for e in table._edges)
            if self._host_shield is not None and self._host_shield[0] == sig:
                _, lkg, radius, streak, risk = self._host_shield
            else:
                lkg = idx.copy()
                radius = np.full(N, spec.trust_radius, np.int32)
                streak = np.zeros(N, np.int32)
                risk = np.zeros(N, np.float32)
            budget = np.full(N, spec.breach_budget, np.int32)
            ex_any = np.zeros(N, bool)
            replay_l: list = []
            replay_b: list = []
        for _ in range(self.steps_per_episode):
            states = self._encode_fleet(windows, configs)
            mask = (table.shield_mask(idx, lkg, radius, ranked)
                    if spec is not None else None)
            t0 = time.perf_counter()
            actions = self.agent.act_batch_device(
                states, explore=explore, mask=mask).cpu().numpy()
            gen_s = (time.perf_counter() - t0) / N
            decoded = [self.agent.action_decode(int(a)) for a in actions]
            if spec is None:
                new_configs = [self.disc.apply(c, lever, direction)
                               for c, (lever, direction)
                               in zip(configs, decoded)]
                changed = [(l,) for l, _ in decoded]
            else:
                # a step counts as clamped when the mask removed the action
                # the policy's own argmax would have taken (no extra draws),
                # or when the hard clamp moved the sampled bin
                a_free = self.agent.act_batch(states, greedy=True)
                diverted = ~mask[rows, a_free]
                l_idx = ranked[actions // 2]
                direction = np.where(actions % 2 == 0, 1, -1)
                prev_idx = idx.copy()
                raw = table.step_index(idx[rows, l_idx], l_idx, direction)
                nb = table.shield_clamp(raw, lkg[rows, l_idx], radius, l_idx)
                fallback = (risk > spec.risk_threshold) | (budget <= 0)
                idx[rows, l_idx] = nb
                idx = np.where(fallback[:, None], lkg, idx)
                self.shield_counters.clamped_actions += int(
                    (diverted | (nb != raw)).sum())
                self.shield_counters.fallbacks += int(fallback.sum())
                replay_l.append(l_idx.copy())
                replay_b.append(idx[rows, l_idx].copy())
                new_configs = []
                changed = []
                for i in range(N):
                    cfg = dict(configs[i])
                    moved = np.nonzero(idx[i] != prev_idx[i])[0]
                    for li in moved:
                        cfg[names[li]] = table.value_of(int(li),
                                                        int(idx[i, li]))
                    new_configs.append(cfg)
                    changed.append(tuple(names[int(li)] for li in moved))
            reports = env.apply_configs(new_configs, changed_levers=changed)
            stabs = env.stabilisation_times()
            # paper §4.2: reward measured on the window after stabilisation
            windows = env.observe(self.window_s, preroll_s=stabs)
            if self.reward_mode == "neg_mean":
                rewards = [-w.mean_ms / 1000.0 for w in windows]
            elif self.reward_mode == "neg_p99":
                rewards = [-w.p99_ms / 1000.0 for w in windows]
            else:
                rewards = [reward_from_latency(w.latencies_ms,
                                               self.reward_mode,
                                               slo_ms=self.slo_ms,
                                               hinge_w=self.slo_hinge_w,
                                               breach_w=self.slo_breach_w)
                           for w in windows]
            if spec is not None:
                # the host breach-fraction proxy (the slo reward's): the
                # fraction of the window's latency sample above the SLO
                bf = np.empty(N, np.float32)
                for i, w in enumerate(windows):
                    lat = np.asarray(w.latencies_ms, float)
                    lat = lat[np.isfinite(lat) & (lat > 0)]
                    bf[i] = float((lat > self.slo_ms).mean()) \
                        if lat.size else 1.0
                lkg, radius, streak, risk, budget, b_out = shield_update(
                    bf, lkg, idx, radius, streak, risk, budget, spec,
                    xp=np)
                ex_any |= np.asarray(b_out)
            for i in range(N):
                reward = rewards[i]
                trajs[i].add(states[i], int(actions[i]), reward)
                lever, direction = decoded[i]
                records[i].append(StepRecord(
                    lever=lever, direction=direction,
                    config=dict(new_configs[i]), reward=reward,
                    p99_ms=windows[i].p99_ms, clock_s=windows[i].clock_s,
                    phases={"generation_s": gen_s,
                            "loading_s": reports[i]["load_s"],
                            "stabilisation_s": float(stabs[i]),
                            "update_s": 0.0},
                ))
            configs = new_configs
        if spec is not None:
            self._host_shield = (sig, lkg, radius, streak, risk)
            self.shield_counters.budget_exhaustions += int(ex_any.sum())
            self.shield_counters.trust_radius = float(radius.mean())
            # §2.4.1 replay, step-major like the fused loop's (the table
            # stayed frozen for the whole episode)
            lever_sm = np.concatenate(replay_l)
            bin_sm = np.concatenate(replay_b)
            for li in np.unique(lever_sm):
                dyn = self.disc.bins.get(names[li])
                if dyn is not None:
                    dyn.record_many(bin_sm[lever_sm == li])
        self._last_fleet_windows = windows
        return trajs, [r for cluster in records for r in cluster]

    def contract_shield(self) -> None:
        """Collapse the shield's trust region to its floor and reset the
        clean-window streaks, on whichever path (fused runner / numpy twin)
        holds shield state: exploration continues, confined to
        ±radius_min bins around the last-known-good configs until clean
        windows earn the radius back (the serve loop's breach-budget trip,
        DESIGN.md §16)."""
        spec = self.shield
        if spec is None:
            return
        runner = self._runner
        if runner is not None and runner._shield is not None:
            lkg, radius, streak, risk = runner._shield
            runner._shield = (lkg, torch.full_like(radius, spec.radius_min),
                              torch.zeros_like(streak), risk)
        if self._host_shield is not None:
            sig, lkg, radius, streak, risk = self._host_shield
            self._host_shield = (sig, lkg,
                                 np.full_like(radius, spec.radius_min),
                                 np.zeros_like(streak), risk)
        self.shield_counters.trust_radius = float(spec.radius_min)

    # -- the fused device loop (DESIGN.md §10) ----------------------------------
    def _device_runner(self):
        if self._runner is None:
            from repro_torch.core.device_loop import DeviceEpisodeRunner

            self._runner = DeviceEpisodeRunner(self)
        return self._runner

    def device_loop_reason(self) -> Optional[str]:
        """None when the fused device training loop will run; otherwise why
        it can't."""
        if self.device_loop == "off":
            return "device_loop='off'"
        if not self.fleet:
            return "serial TuningEnv (the fused loop is fleet-shaped)"
        return self._device_runner().supported()

    def run_fleet_episodes_device(self, *, explore: bool = True,
                                  greedy: bool = False):
        """The whole Algorithm-1 episode batch on the device: encode → act →
        integerised lever-apply → loading/stabilisation → fused observation
        window → reward, stepped with the queueing state carried through.
        Returns ``(batch, records)``: the device-resident (N, S)
        states/actions/rewards and the host ``StepRecord``s.
        ``explore=False`` (or ``greedy=True``) takes the deterministic
        argmax action — exactly replayable against the reference."""
        reason = self.device_loop_reason()
        if reason is not None:
            raise RuntimeError(f"fused device loop unavailable: {reason}")
        return self._device_runner().run(explore=explore, greedy=greedy)

    def run_update(self) -> dict:
        """One Algorithm-1 outer iteration: N episodes then a policy update.
        Against a FleetTuningEnv the N episodes run in parallel, one per
        cluster (as fused device batches when the §10 loop can run);
        serially otherwise."""
        reason = self.device_loop_reason()
        if reason is None:
            return self._run_update_device()
        if self.device_loop == "on":
            raise RuntimeError(f"device_loop='on' but: {reason}")
        trajs, all_records = [], []
        if self.fleet:
            # small fleets still need a real episode batch: the per-step
            # baseline is the across-episode mean, which degenerates (zero
            # advantages) with a single episode
            passes = max(1, -(-self.episodes_per_update // self.env.n_clusters))
            for _ in range(passes):
                t, r = self.run_fleet_episodes()
                trajs.extend(t)
                all_records.extend(r)
        else:
            for _ in range(self.episodes_per_update):
                t, r = self.run_episode()
                trajs.append(t)
                all_records.extend(r)
        t0 = time.perf_counter()
        stats = self.agent.update(trajs)
        upd_s = time.perf_counter() - t0
        return self._finish_update(stats, all_records, upd_s)

    def _run_update_device(self) -> dict:
        """§10 outer iteration: the fused episode batch(es), then ONE policy
        update whose device work overlaps the host's record materialisation
        and §2.4.1 bin replay (``DeviceEpisodeRunner.run_cycle``)."""
        runner = self._device_runner()
        passes = max(1, -(-self.episodes_per_update // self.env.n_clusters))
        stats, all_records, upd_s = runner.run_cycle(passes=passes)
        return self._finish_update(stats, all_records, upd_s)

    def _finish_update(self, stats: dict, all_records: list,
                       upd_s: float) -> dict:
        if all_records:
            all_records[-1].phases["update_s"] = upd_s
        self.history.extend(all_records)
        stats["p99_ms"] = all_records[-1].p99_ms if all_records else float("nan")
        return stats

    def run_cycle(self) -> dict:
        """One ``run_update`` whose freshly appended ``StepRecord``s ride
        back under ``stats["records"]`` (the serve loop's shadow pass)."""
        n0 = len(self.history)
        stats = self.run_update()
        stats["records"] = self.history[n0:]
        return stats

    def tune(self, n_updates: int, *, callback=None) -> list[StepRecord]:
        for i in range(n_updates):
            stats = self.run_update()
            if callback:
                callback(i, stats, self.history)
        return self.history

    def _fused_runner(self, what: str):
        """The fused loop's runner and the episode batches an update takes;
        ``what`` names the caller in the error when the loop cannot run."""
        reason = self.device_loop_reason()
        if reason is not None:
            raise RuntimeError(f"{what} needs the fused device loop: {reason}")
        return (self._device_runner(),
                max(1, -(-self.episodes_per_update // self.env.n_clusters)))

    def tune_pipelined(self, n_updates: int, *, depth: int = 2,
                       callback=None) -> list[StepRecord]:
        """``tune`` as a depth-``depth`` pipelined actor/learner (DESIGN.md
        §14): update k runs on the card behind batch k+1's episodes, the
        host's record materialisation deferred to one finalize per call (so
        §2.4.1 bin adaptation replays once per call, and episodes act on
        (depth-1)-update-stale parameters, IMPALA-style).

        ``depth=1`` is the sequential schedule: it delegates to ``tune``.
        Requires the fused device loop."""
        if depth <= 1 or n_updates <= 0:
            return self.tune(n_updates, callback=callback)
        runner, passes = self._fused_runner("pipelined tuning")
        stats_list, records, upd_s = runner.run_pipelined(
            n_updates, passes=passes, depth=depth)
        per = len(records) // n_updates if records else 0
        for k, stats in enumerate(stats_list):
            recs = records[k * per:(k + 1) * per] if per else []
            stats = self._finish_update(stats, recs, upd_s[k])
            if callback:
                callback(k, stats, self.history)
        return self.history

    def run_epoch(self, k: int = 8, *, records: str = "full") -> list[dict]:
        """``k`` outer Algorithm-1 iterations with no host sync between
        them — the epoch mega-scan (DESIGN.md §15): episode batch → reward →
        policy update, one captured body replayed per update. §2.4.1 bin
        adaptation defers to the epoch boundary (binning is frozen inside);
        ``records="full"`` materialises the sequential path's exact
        ``StepRecord`` stream into ``history``, ``"summary"``/``"off"``
        skip it and return per-update convergence stats only. Requires the
        fused device loop. Returns the per-update stats dicts."""
        runner, passes = self._fused_runner("epoch mega-scan")
        stats_list, recs = runner.run_epoch(k, passes=passes,
                                            records=records)
        if recs:
            # the update runs inside the epoch's body: no separable
            # update_s (generation_s carries the epoch's wall)
            per = len(recs) // max(len(stats_list), 1)
            for i, stats in enumerate(stats_list):
                self._finish_update(stats, recs[i * per:(i + 1) * per], 0.0)
        return stats_list

    def tune_megascan(self, n_updates: int, *, k: int = 8,
                      records: str = "full",
                      callback=None) -> list[StepRecord]:
        """``tune`` over epoch mega-scans (DESIGN.md §15): ``n_updates``
        outer iterations as ⌈n/k⌉ epochs of up to k updates. The callback
        fires per update, after the epoch holding it lands."""
        done = 0
        while done < n_updates:
            kk = min(k, n_updates - done)
            for j, stats in enumerate(self.run_epoch(kk, records=records)):
                if callback:
                    callback(done + j, stats, self.history)
            done += kk
        return self.history
