"""RL configuration feedback loop (paper Fig 3 bottom, §3, §4.2), on PyTorch.

The port of ``repro.core.configurator``: the ``Configurator`` drives the
paper's episode loop — observe heat-maps -> pick (lever, direction) ->
discretise -> apply config -> buffer events during loading -> wait for
stabilisation -> measure latency -> reward -> (end of episode) REINFORCE
update — as the fused device loop (``repro_torch.core.device_loop``) over a
``FleetEnv(backend="torch")``.

Ported so far: the constructor, state encoding, the fused-loop gate, one
fused episode batch (``run_fleet_episodes_device``), the device branch of
``run_update`` and ``tune``. The per-step host loops (``run_episode``,
``run_fleet_episodes``) and the safety shield raise ``NotImplementedError``
naming their ROADMAP item; they never fall back.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.discretize import LeverDiscretiser
from repro_torch.core.heatmap import HeatmapEncoder, HeatmapSpec
from repro_torch.core.policy import ReinforceAgent

_HOST_LOOP = ("the per-step host loop is not ported yet (ROADMAP queue 1, "
              "item 5: host-loop configurator); use a FleetEnv(backend="
              "'torch') with the fused device loop")


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


class Configurator:
    """Paper §3: runs tuning phases made of episodes of N configuration steps.

    ``device_loop`` selects the §10 fused training loop over a torch fleet:
    ``"auto"`` (default) uses it whenever ``device_loop_reason()`` is None,
    ``"on"`` fails loudly when it can't, ``"off"`` asks for the per-step host
    loop (not ported yet: it raises). ``device`` is where the policy lives;
    it defaults to the fleet's device.

    ``reward_mode="slo"`` (DESIGN.md §12) shapes the reward against a
    latency SLO: ``slo_ms`` is the p99 target, ``slo_hinge_w`` weights the
    hinge penalty on a window-p99 breach and ``slo_breach_w`` the
    breach-duration term (computed on device per window)."""

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
        safe: bool = False,
        device=None,
    ):
        assert device_loop in ("auto", "on", "off"), device_loop
        if safe:
            raise NotImplementedError(
                "the safety shield is not ported yet (ROADMAP queue 1, "
                "item 4: the shield carry of the episode runner)")
        from repro_torch.engine.fleet_torch import resolve_device

        self.env = env
        self.fleet = is_fleet_env(env)
        self.device_loop = device_loop
        self.device = resolve_device(
            device if device is not None else getattr(env, "device", None))
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
        self.history: list[StepRecord] = []
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

    # -- the per-step host loops (not ported) -----------------------------------
    def run_episode(self, *, explore: bool = True):
        raise NotImplementedError(_HOST_LOOP)

    def run_fleet_episodes(self, *, explore: bool = True):
        raise NotImplementedError(_HOST_LOOP)

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
        """One Algorithm-1 outer iteration: N episodes (one per cluster, in
        parallel, as fused device batches) then a policy update."""
        reason = self.device_loop_reason()
        if reason is None:
            return self._run_update_device()
        if self.device_loop == "on":
            raise RuntimeError(f"device_loop='on' but: {reason}")
        raise NotImplementedError(f"{_HOST_LOOP} (fused loop: {reason})")

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

    def tune(self, n_updates: int, *, callback=None) -> list[StepRecord]:
        for i in range(n_updates):
            stats = self.run_update()
            if callback:
                callback(i, stats, self.history)
        return self.history
