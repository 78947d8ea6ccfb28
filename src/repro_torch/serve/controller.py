"""The serve-loop controller (DESIGN.md §13) on PyTorch: shadow → canary →
promote — the port of ``repro.serve.controller``.

``ServeController`` owns three fleets built over the same workload roster,
all on one ``device`` (the card unless the caller asks for the CPU):

* **shadow** — the exploration fleet. One persistent ``Configurator`` runs
  the fused Algorithm-1 loop on it (``Configurator.run_cycle`` →
  ``DeviceEpisodeRunner.run_cycle``: the episode batch and the policy
  update as captured CUDA graphs, captured once and replayed every cycle —
  ``CAPTURE_COUNTS`` stays flat, the port's twin of the §13 no-retrace
  pin), or one epoch mega-scan a cycle with ``epoch_k > 1``.
* **canary** — a paired evaluation fleet of ``2·canary_pairs`` clusters:
  the challenger config runs on the first half, the incumbent on the
  matched second half, and both are scored with the SLO-shaped reward over
  the same evaluation windows. A ``FleetEnv(faults=...)`` table here makes
  outages hit the canary through the window kernel's ``fmult`` operand.
* **live** — the serving fleet. It only ever runs the incumbent; configs
  reach it exclusively through ``CanaryGate`` promotions.

Every promotion checkpoints the full control-plane state through
``checkpoint/store.py``: policy parameters and rmsprop state, encoder
running range, the three fleets' queueing/clock/RNG state, the device
runner's carried window metrics, config indices, deploy ring and shield
carry, the adaptive bin state, the gate's log and the counters. Where the
reference keeps a counter-based device key, the port keeps the state of
each ``torch.Generator`` — every fleet's ``PhiloxDraws`` and the agent's
device sampler — as a uint8 leaf, plus each engine's window counter.

A restore goes through the runner's own path: it sets the carried leaves
and leaves the carry buffers to the next batch's ``_load_fresh``, which
copies them into the buffers the captured programs read while shapes and
dtypes hold. Generator states are restored with ``set_state`` on the same
generator objects the graphs registered, so a graph captured before the
restore replays from the restored Philox offset. A killed service resumed
from the store therefore replays the uninterrupted run bitwise, in a fresh
process or in place (tests/test_torch_serve_crash.py, chip_smoke.py
phase 14).
"""
from __future__ import annotations

import ast
import time
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.core.configurator import Configurator
from repro_torch.distribution import sharding as shd
from repro_torch.engine import FleetEnv
from repro_torch.monitoring.metrics import ServeCounters, retrace_counts
from repro_torch.serve.canary import CanaryGate
from repro_torch.serve.history import (EpisodeStore, _jsonable,
                                       workload_features)


def _rng_state(gen) -> dict:
    """JSON-able ``np.random.Generator`` state (SFC64/PCG64 dicts hold
    uint64 arrays / 128-bit ints; python JSON ints are exact)."""
    return _jsonable(gen.bit_generator.state)


def _set_rng_state(gen, st: dict) -> None:
    gen.bit_generator.state = st


def _gen_state(draws) -> np.ndarray:
    """A ``PhiloxDraws`` source's generator state as a uint8 array (seed
    and offset on CUDA, the Mersenne state on the CPU)."""
    return draws.gen.get_state().numpy().copy()


def _set_gen_state(draws, st) -> None:
    """Restore in place: the generator object a captured graph registered
    stays the one it draws from."""
    draws.gen.set_state(torch.from_numpy(np.array(st, np.uint8)))


def _host(x) -> np.ndarray:
    """A window statistic as a host f64 array (an f32 device tensor widens
    exactly)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, float)


class ServeController:
    """Always-on control loop around the fused device loop (DESIGN.md §13).

    The reference's keywords, with ``backend="torch"`` only (as
    ``FleetEnv``), ``window_impl`` for the three fleets' windows (default
    ``"scan"``, the lean ``fleet_scan`` kernel, as the reference defaults
    to ``backend="jax"``; ``"kernel"`` is its ``"pallas"``) and ``device``
    for the three fleets and the policy; ``mesh`` shards the shadow
    fleet's cluster axis (``Configurator(mesh=...)``, DESIGN.md §11).
    Under a process group every rank runs the same controller; only rank
    0 writes ``history_path`` and the checkpoints."""

    def __init__(
        self,
        workloads: Sequence,
        *,
        metrics: Sequence[str],
        levers: Sequence[str],
        backend: str = "torch",
        window_impl: str = "scan",
        seed: int = 0,
        window_s: float = 240.0,
        steps_per_episode: int = 2,
        episodes_per_update: Optional[int] = None,
        f_exploit: float = 0.8,
        reward_mode: str = "slo",
        slo_ms: float = 2000.0,
        slo_hinge_w: float = 1.0,
        slo_breach_w: float = 1.0,
        k_promote: int = 2,
        margin: float = 0.02,
        demote_cooldown: int = 2,
        eval_windows: int = 1,
        canary_pairs: int = 2,
        n_live: int = 2,
        canary_faults=None,
        incumbent: Optional[dict] = None,
        device_loop: str = "auto",
        mesh="auto",
        epoch_k: int = 1,
        bin_kw: Optional[dict] = None,
        safe: bool = False,
        trust_radius: int = 2,
        breach_budget: int = 4,
        shield_kw: Optional[dict] = None,
        checkpoint_dir=None,
        checkpoint_keep: int = 3,
        history_path=None,
        device=None,
    ):
        workloads = list(workloads)
        n = len(workloads)
        self.seed = int(seed)
        self.window_s = float(window_s)
        self.reward_mode = reward_mode
        self.slo_ms = float(slo_ms)
        self.slo_hinge_w = float(slo_hinge_w)
        self.slo_breach_w = float(slo_breach_w)
        self.eval_windows = int(eval_windows)
        self.demote_cooldown = int(demote_cooldown)
        self.canary_pairs = M = int(canary_pairs)
        # epoch_k > 1: the shadow phase trains via the epoch mega-scan
        # (DESIGN.md §15) — K fused updates per cycle, one captured body
        # replayed K times, instead of one update
        self.epoch_k = int(epoch_k)

        # the three fleets: seeds are part of the service identity (the
        # generators derive from them), so a resumed controller must be
        # constructed with the same (workloads, seed, backend, window_impl)
        self.shadow_env = FleetEnv(
            workloads, seeds=[seed + i for i in range(n)], backend=backend,
            device=device, window_impl=window_impl)
        self.device = self.shadow_env.device
        # "auto" is resolved once, by the shadow fleet; the others follow it
        impl = self.shadow_env.window_impl
        cw = [workloads[i % n] for i in range(M)]
        self.canary_env = FleetEnv(
            cw + cw, seeds=[seed + 101 + i for i in range(2 * M)],
            backend=backend, faults=canary_faults, device=self.device,
            window_impl=impl)
        self.live_env = FleetEnv(
            [workloads[i % n] for i in range(int(n_live))],
            seeds=[seed + 211 + i for i in range(int(n_live))],
            backend=backend, device=self.device, window_impl=impl)

        # safe exploration (DESIGN.md §16): the shadow Configurator runs
        # its fused loop under the trust-region shield; the controller
        # additionally watches the per-episode breach budget — an
        # exhaustion demotes whatever is queued for canary on the spot
        # and contracts the trust region to its floor
        skw = dict(shield_kw or {})
        if safe:
            skw.setdefault("trust_radius", int(trust_radius))
            skw.setdefault("breach_budget", int(breach_budget))
        self.safe = bool(safe)
        self._budget_seen = 0

        self.cfgr = Configurator(
            self.shadow_env, list(metrics), list(levers),
            f_exploit=f_exploit, steps_per_episode=steps_per_episode,
            episodes_per_update=(episodes_per_update
                                 if episodes_per_update is not None else n),
            window_s=self.window_s, reward_mode=reward_mode, slo_ms=slo_ms,
            slo_hinge_w=slo_hinge_w, slo_breach_w=slo_breach_w, seed=seed,
            bin_kw=bin_kw, device_loop=device_loop, mesh=mesh, safe=safe,
            shield_kw=skw if safe else None, device=self.device)

        base = self.live_env.current_configs()[0]
        if incumbent:
            # a partial incumbent override (e.g. a deliberately degraded
            # starting config) is merged over the defaults and installed on
            # all three fleets — shadowing explores AROUND what is serving
            inc = dict(base)
            inc.update(incumbent)
            self.incumbent = inc
            for env in (self.shadow_env, self.canary_env, self.live_env):
                env.apply_configs([dict(inc)] * env.n_clusters)
        else:
            self.incumbent = dict(base)

        self.gate = CanaryGate(k=k_promote, margin=margin)
        self.counters = ServeCounters()
        # every rank reads the rows a resumed run left; rank 0 writes them
        self.history = EpisodeStore(history_path, write=shd.is_writer())
        shd.barrier()   # no rank reads a row another rank already wrote
        self.store = None
        if checkpoint_dir is not None:
            from repro_torch.checkpoint import CheckpointStore
            self.store = CheckpointStore(checkpoint_dir, keep=checkpoint_keep,
                                         device=self.device)
        self.cycle = 0
        #: wall seconds of the last cycle's phases (shadow, canary, live)
        self.phase_s: dict = {}

    # ------------------------------------------------------------------ cycle
    def run_cycle(self) -> dict:
        """One control-plane cycle: shadow training pass (the captured
        episode batch and update) → challenger pick → paired canary
        evaluation → gate decision (promote / hold / demote / rollback) →
        one live window under the incumbent. Returns a summary dict."""
        t0 = time.perf_counter()
        self.cycle += 1
        c = self.counters

        # ---- shadow: train + surface this cycle's candidate ---------------
        self._reset_queues(self.shadow_env)
        if self.epoch_k > 1:
            n0 = len(self.cfgr.history)
            stats_list = self.cfgr.run_epoch(self.epoch_k, records="full")
            stats = dict(stats_list[-1]) if stats_list else {}
            recs = self.cfgr.history[n0:]
        else:
            stats = self.cfgr.run_cycle()
            recs = stats.pop("records")
        c.inc("shadow_windows", len(recs))
        best = max(recs, key=lambda r: r.reward) if recs else None
        if best is not None:
            self.history.append(
                cycle=self.cycle, role="shadow",
                workload=workload_features(self.shadow_env.workloads[0],
                                           float(self.shadow_env.clock[0])),
                config=dict(best.config), reward=float(best.reward),
                p99_ms=float(best.p99_ms), clock_s=float(best.clock_s))
        if self.gate.challenger is None and recs:
            self._adopt_challenger(recs)

        # ---- §16 breach-budget trip: shadow exhausted its per-episode
        # breach budget this cycle → demote the queued challenger without
        # spending a canary cycle on it, and contract the shield's trust
        # region to its floor (expansion re-earned by clean windows)
        budget_tripped = False
        if self.safe:
            bx = self.cfgr.shield_counters.budget_exhaustions
            budget_tripped = bx > self._budget_seen
            self._budget_seen = bx
            if budget_tripped:
                self.cfgr.contract_shield()
                if self.gate.challenger is not None:
                    self.gate.force_demote(cycle=self.cycle,
                                           reason="breach_budget")
                    c.inc("demotions")
        t1 = time.perf_counter()

        # ---- canary: paired challenger-vs-incumbent evaluation ------------
        decision = "budget_demote" if budget_tripped else "shadow"
        cand_r = inc_r = None
        if self.gate.challenger is not None:
            challenger = dict(self.gate.challenger)
            cand_r, inc_r, breached = self._canary_eval(challenger)
            decision = self.gate.decide(cand_r, inc_r, breached,
                                        cycle=self.cycle)
            self.history.append(
                cycle=self.cycle, role="canary",
                workload=workload_features(self.canary_env.workloads[0],
                                           float(self.canary_env.clock[0])),
                config=challenger, reward=cand_r, p99_ms=float(
                    c.last_canary_p99_ms), clock_s=float(
                    self.canary_env.clock[0]), breached=breached)
            if decision == "promote":
                self._promote(challenger, cand_r)
            elif decision == "rollback":
                self._rollback()
            elif decision == "demote":
                c.inc("demotions")
            else:
                c.inc("holds")
        t2 = time.perf_counter()

        # ---- live: one serving window under the incumbent ------------------
        live = self._live_window()

        c.inc("cycles")
        # sample the process-wide capture total as a gauge: flat cycle-over-
        # cycle in steady state, climbing = the device programs are being
        # recaptured (the dashboard view of the §13 no-retrace pin)
        c.retraces = retrace_counts()
        t3 = time.perf_counter()
        wall = t3 - t0
        self.phase_s = {"shadow": t1 - t0, "canary": t2 - t1,
                        "live": t3 - t2}
        c.add_wall(wall)
        return {"cycle": self.cycle, "decision": decision,
                "cand_reward": cand_r, "inc_reward": inc_r,
                "live_reward": live["reward"], "live_p99_ms": live["p99_ms"],
                "incumbent": dict(self.incumbent),
                "mean_return": stats.get("mean_return"), "wall_s": wall}

    def run(self, cycles: int, *, callback=None) -> list[dict]:
        out = []
        for _ in range(int(cycles)):
            s = self.run_cycle()
            out.append(s)
            if callback:
                callback(s)
        return out

    # ---------------------------------------------------------------- phases
    @staticmethod
    def _config_key(cfg: dict) -> tuple:
        return tuple(sorted(cfg.items()))

    def _blocked_configs(self) -> set:
        """Configs the gate may not re-adopt, derived from its own log (so
        crash-resume needs no extra state): anything that ever BREACHED
        under canary is blocked for good — 'never serves a config that
        breached SLO during canary' includes not giving it a second canary
        — and margin losses sit out ``demote_cooldown`` cycles (a demote is
        often noise; a repeat offender shouldn't monopolise the canary)."""
        blocked = set()
        for e in self.gate.log:
            if e["event"] == "rollback":
                blocked.add(self._config_key(e["config"]))
            elif (e["event"] == "demote"
                  and e["cycle"] > self.cycle - self.demote_cooldown):
                blocked.add(self._config_key(e["config"]))
        return blocked

    def _adopt_challenger(self, recs) -> None:
        """Pick the best shadow record that is (a) not the incumbent,
        (b) not SLO-breaching in its own shadow window — a saturating
        config can post one deceptively fast window before its queue
        explodes, and the canary shouldn't waste a cycle discovering
        that — and (c) not on the rejection blocklist.

        A warm-start hint takes precedence over this cycle's shadow
        records: ``EpisodeStore.best_config_for`` over PROMOTED rows for
        the current workload features (arXiv 2504.12074's learn-from-the-
        past query). A service restarted against an existing history file
        re-canaries what history already proved instead of waiting for
        shadow exploration to rediscover it; in steady state the best
        promotion IS the incumbent, so the hint is a no-op."""
        blocked = self._blocked_configs()
        warm = self.history.best_config_for(
            workload_features(self.shadow_env.workloads[0],
                              float(self.shadow_env.clock[0])),
            roles=("promote",))
        if (warm is not None and warm != self.incumbent
                and self._config_key(warm) not in blocked):
            self.gate.adopt(dict(warm), cycle=self.cycle)
            return
        for r in sorted(recs, key=lambda x: x.reward, reverse=True):
            cfg = dict(r.config)
            if cfg == self.incumbent:
                continue
            if self.reward_mode == "slo" and r.p99_ms > self.slo_ms:
                continue
            if self._config_key(cfg) in blocked:
                continue
            self.gate.adopt(cfg, cycle=self.cycle,
                            shadow_reward=float(r.reward))
            return

    def _window_reward(self, mean_ms: np.ndarray,
                       p99_ms: np.ndarray) -> np.ndarray:
        """The cycle's evaluation reward from window stats — the same SLO
        shaping as ``reward_from_latency(mode="slo")`` with the breach term
        at window granularity (the plain observe path has no in-trace tick
        breach fraction; the shadow loop's rewards DO use the §12 tick-level
        ``breach_frac``). f64 on host arrays."""
        mean = np.asarray(mean_ms, float)
        p99 = np.asarray(p99_ms, float)
        if self.reward_mode == "neg_p99":
            return -p99 / 1000.0
        if self.reward_mode == "slo":
            return (-mean / 1000.0
                    - self.slo_hinge_w
                    * np.maximum(p99 - self.slo_ms, 0.0) / 1000.0
                    - self.slo_breach_w * (p99 > self.slo_ms).astype(float))
        return -mean / 1000.0

    @staticmethod
    def _reset_queues(env) -> None:
        """Spin an evaluation fleet's replicas up fresh: zero queues, free
        servers. Shadow and canary replicas are ephemeral — without the
        reset one saturating config leaves a backlog that contaminates
        every later window (inherited queueing delay reads as an SLO
        breach of an innocent config, and a saturated shadow fleet can
        never surface a viable candidate again). Touches no RNG stream, so
        resumed runs replay it exactly.

        The engine's queue tensors are rebound to zeros of the same shape:
        the fused loop's next ``_load_fresh`` copies the engine's state
        into the carry buffers its captured programs read, so the reset
        reaches them without a recapture."""
        env.backlog[:] = 0.0
        env.server_free[:] = env.clock
        dev = env._dev
        if dev._backlog is not None:
            dev._backlog = torch.zeros_like(dev._backlog)
            dev._sfree_rel = torch.zeros_like(dev._sfree_rel)
        dev._pending_arrivals[:] = 0.0
        dev._pending_gap[:] = 0.0

    def _canary_eval(self, challenger: dict) -> tuple[float, float, bool]:
        """Challenger on clusters [0:M], incumbent on the matched [M:2M]
        replicas — both slices start from freshly-reset queues — scored
        over ``eval_windows`` windows after the §4.2 stabilisation preroll.
        Breach = any challenger window p99 over the SLO (fault effects from
        the canary's ``DeviceFaultTable`` ride the same observation
        windows, §12)."""
        env, M = self.canary_env, self.canary_pairs
        self._reset_queues(env)
        env.apply_configs([dict(challenger) for _ in range(M)]
                          + [dict(self.incumbent) for _ in range(M)])
        stabs = env.stabilisation_times()
        rewards, p99_hw, breach_any = [], 0.0, False
        for w in range(self.eval_windows):
            s = env.observe_stats(self.window_s,
                                  preroll_s=stabs if w == 0 else None)
            mean = _host(s["mean_ms"])
            p99 = _host(s["p99_ms"])
            rewards.append(self._window_reward(mean, p99))
            self.counters.inc("canary_windows", 2 * M)
            n_breach = int((p99[:M] > self.slo_ms).sum())
            self.counters.inc("canary_breached", n_breach)
            breach_any |= n_breach > 0
            p99_hw = max(p99_hw, float(p99[:M].max()))
        self.counters.last_canary_p99_ms = p99_hw
        R = np.stack(rewards)                       # (W, 2M)
        return float(R[:, :M].mean()), float(R[:, M:].mean()), breach_any

    def _promote(self, challenger: dict, cand_reward: float) -> None:
        self.incumbent = dict(challenger)
        self.live_env.apply_configs(
            [dict(challenger)] * self.live_env.n_clusters)
        self.counters.inc("promotions")
        self.history.append(
            cycle=self.cycle, role="promote",
            workload=workload_features(self.live_env.workloads[0],
                                       float(self.live_env.clock[0])),
            config=dict(challenger), reward=float(cand_reward),
            p99_ms=float(self.counters.last_canary_p99_ms),
            clock_s=float(self.live_env.clock[0]))
        if self.store is not None:
            self.checkpoint()

    def _rollback(self) -> None:
        """Restore the incumbent on the whole canary fleet — the challenger
        slice gets the exact stored incumbent dict back (bit-for-bit; it IS
        the same values the live fleet serves)."""
        self.canary_env.apply_configs(
            [dict(self.incumbent)] * self.canary_env.n_clusters)
        self.counters.inc("rollbacks")

    def _live_window(self) -> dict:
        env = self.live_env
        s = env.observe_stats(self.window_s)
        mean = _host(s["mean_ms"])
        p99 = _host(s["p99_ms"])
        r = self._window_reward(mean, p99)
        breached = int((p99 > self.slo_ms).sum())
        c = self.counters
        c.inc("live_windows", env.n_clusters)
        c.inc("live_breached", breached)
        c.observe_live(reward=float(r.mean()), p99_ms=float(p99.max()))
        self.history.append(
            cycle=self.cycle, role="live",
            workload=workload_features(env.workloads[0],
                                       float(env.clock[0])),
            config=dict(self.incumbent), reward=float(r.mean()),
            p99_ms=float(p99.max()), clock_s=float(env.clock[0]),
            breached=breached > 0)
        return {"reward": float(r.mean()), "p99_ms": float(p99.max()),
                "breached": breached}

    # ------------------------------------------------------------ test hooks
    def greedy_actions(self, states: np.ndarray) -> np.ndarray:
        """Deterministic policy probe (crash-resume equality assertions)."""
        return self.cfgr.agent.act_batch(
            np.asarray(states, np.float32), greedy=True)

    # ------------------------------------------------------- checkpoint state
    def _fleet_state(self, env) -> dict:
        dev = env._dev
        st = {"clock": env.clock.copy(),
              "reconfigs": env.reconfigs.copy(),
              "last_service": env.last_service.copy(),
              "last_load_s": np.asarray(env.last_load_s, float).copy(),
              "rng_state": np.stack(
                  [np.asarray(g.bit_generator.state["state"]["state"],
                              np.uint64) for g in env.rngs]),
              "draws": _gen_state(dev.draws)}
        if dev._backlog is None:
            st["backlog"] = np.asarray(env.backlog, np.float32)
            st["sfree_rel"] = np.asarray(
                np.maximum(env.server_free - env.clock, 0.0), np.float32)
        else:
            st["backlog"] = dev._backlog
            st["sfree_rel"] = dev._sfree_rel
        st["pending_arrivals"] = dev._pending_arrivals.copy()
        st["pending_gap"] = dev._pending_gap.copy()
        return st

    def _load_fleet(self, env, st: dict, configs: list,
                    dev_extra: dict) -> None:
        env.configs = [dict(c) for c in configs]
        env.invalidate()
        env.clock[:] = np.asarray(st["clock"], np.float64)
        env.reconfigs[:] = np.asarray(st["reconfigs"], np.int64)
        env.last_service[:] = np.asarray(st["last_service"], np.float64)
        env.last_load_s = np.asarray(st["last_load_s"], np.float64).copy()
        for g, row in zip(env.rngs, np.asarray(st["rng_state"], np.uint64)):
            s = g.bit_generator.state
            s["state"]["state"] = row
            s["has_uint32"] = 0
            s["uinteger"] = 0
            g.bit_generator.state = s
        dev = env._dev
        f32 = dict(dtype=torch.float32, device=dev.device)
        dev._backlog = torch.as_tensor(np.asarray(st["backlog"]), **f32)
        dev._sfree_rel = torch.as_tensor(np.asarray(st["sfree_rel"]), **f32)
        dev._pending_arrivals[:] = np.asarray(st["pending_arrivals"])
        dev._pending_gap[:] = np.asarray(st["pending_gap"])
        dev._cc_dev = None
        dev.last_stats = None
        _set_gen_state(dev.draws, st["draws"])
        dev._windows = int(dev_extra["windows"])
        _set_rng_state(dev.host_rng, dev_extra["host_rng"])
        # the engine's high-water keys are tuples such as ("T", True) and
        # the string "E": repr / literal_eval round-trips both
        dev._hw = {ast.literal_eval(k): v for k, v in dev_extra["hw"].items()}

    def _state_tree(self) -> dict:
        ag = self.cfgr.agent
        rng_range = self.cfgr.encoder._range
        runner = self.cfgr._runner
        has_runner = runner is not None and runner._per_node is not None
        z64 = np.zeros((), np.int64)
        tree = {
            "agent": {"params": ag.params, "opt_state": ag.opt_state,
                      "act_draws": _gen_state(ag._act_draws)},
            "encoder": {"lo": rng_range.lo, "hi": rng_range.hi},
            "shadow": self._fleet_state(self.shadow_env),
            "canary": self._fleet_state(self.canary_env),
            "live": self._fleet_state(self.live_env),
            "bins": {name: {"edges": dyn._edges, "hits": dyn._hits,
                            "since_used": dyn._since_used}
                     for name, dyn in self.cfgr.disc.bins.items()},
            # placeholder zeros keep the tree structure stable for the
            # restore skeleton when no cycle has run yet (extra["runner"]
            # records whether the leaves are real)
            "runner": {
                "per_node": (runner._per_node if has_runner
                             else np.zeros((), np.float32)),
                "config_idx": runner._config_idx if has_runner else z64,
                "hist": (runner._hist if runner is not None
                         and runner._hist is not None else z64),
                "shard_draws": self._shard_draws()},
        }
        if self.cfgr.shield is not None:
            # shield carry rides the same placeholder pattern; the keys are
            # only present under safe=True
            sh = runner._shield if runner is not None else None
            tree["runner"].update(
                shield_lkg=sh[0] if sh is not None else z64,
                shield_radius=sh[1] if sh is not None else z64,
                shield_streak=sh[2] if sh is not None else z64,
                shield_risk=(sh[3] if sh is not None
                             else np.zeros((), np.float32)))
        return tree

    def _shard_draws(self) -> np.ndarray:
        """On a fleet mesh, every rank's own draw stream of the shadow
        fleet, in rank order: rank r draws its block's windows from
        ``draws.for_shard(r)`` (rank 0's is the fleet's own stream, saved
        with it), so a resume must give each rank back its own. One
        all-gather of the generator states, a (world, n) uint8 array; a
        placeholder 0-d array off a mesh or before the runner exists."""
        runner = self.cfgr._runner
        blk = None if runner is None else runner._block
        draws = self.shadow_env._dev.draws
        if blk is None or not hasattr(draws, "for_shard"):
            return np.zeros((), np.uint8)
        import torch.distributed as dist

        dev = runner.device if blk.backend == "nccl" else "cpu"
        mine = draws.for_shard(blk.rank).get_state().to(dev)
        world = dist.get_world_size(blk.group)
        out = torch.empty((world * mine.numel(),), dtype=torch.uint8,
                          device=dev)
        dist.all_gather_into_tensor(out, mine, group=blk.group)
        return out.cpu().numpy().reshape(world, -1)

    def _dev_extra(self, env) -> dict:
        dev = env._dev
        return {"windows": int(dev._windows),
                "host_rng": _rng_state(dev.host_rng),
                "hw": {repr(k): int(v) for k, v in dev._hw.items()}}

    def _state_extra(self) -> dict:
        ag = self.cfgr.agent
        runner = self.cfgr._runner
        has_runner = runner is not None and runner._per_node is not None
        bins_meta = {}
        for name, dyn in self.cfgr.disc.bins.items():
            bins_meta[name] = {
                "top_streak": int(dyn._top_streak),
                "bot_streak": int(dyn._bot_streak),
                "same_streak": int(dyn._same_streak),
                "last_bin": int(dyn._last_bin),
                "rng": _rng_state(dyn._rng)}
        extra = {
            "version": 1,
            "cycle": int(self.cycle),
            "incumbent": _jsonable(self.incumbent),
            "gate": _jsonable(self.gate.state()),
            "counters": _jsonable(self.counters.as_dict()),
            "n_updates": int(ag.n_updates),
            "agent_rng": _rng_state(ag._rng),
            "configs": {"shadow": _jsonable(self.shadow_env.configs),
                        "canary": _jsonable(self.canary_env.configs),
                        "live": _jsonable(self.live_env.configs)},
            "dev": {"shadow": self._dev_extra(self.shadow_env),
                    "canary": self._dev_extra(self.canary_env),
                    "live": self._dev_extra(self.live_env)},
            "bins_meta": bins_meta,
            "runner": {"has": bool(has_runner),
                       "hw_T": int(runner._hw_T) if runner else 0,
                       "hw_B": int(runner._hw_B) if runner else 0,
                       "hist": bool(runner is not None
                                    and runner._hist is not None),
                       "shield": bool(runner is not None
                                      and runner._shield is not None)},
        }
        if self.cfgr.shield is not None:
            extra["shield"] = {
                "budget_seen": int(self._budget_seen),
                "counters": _jsonable(self.cfgr.shield_counters.as_dict())}
        if runner is not None:
            ch = runner.chaos
            extra["chaos"] = {
                "windows": ch.windows,
                "breached_windows": ch.breached_windows,
                "fault_events": ch.fault_events,
                "reward_sum": ch.reward_sum,
                "breach_frac_sum": ch.breach_frac_sum,
                "p99_max_ms": ch.p99_max_ms,
                "wall_s": ch.wall_s}
        return extra

    def checkpoint(self, *, step: Optional[int] = None) -> int:
        """Snapshot the full control-plane state. Called automatically on
        every promotion; callable any time (e.g. a periodic cadence)."""
        assert self.store is not None, "construct with checkpoint_dir="
        step = int(step if step is not None else self.cycle)
        self.store.save(step, self._state_tree(), extra=self._state_extra())
        return step

    def restore(self, store=None, *, step: Optional[int] = None) -> int:
        """Rebuild the controller's state from a checkpoint taken by a
        same-configured controller (same workloads/seed/backend — the RNG
        streams derive from them), in a fresh controller or in one whose
        programs are already captured. Returns the restored cycle number."""
        store = store if store is not None else self.store
        assert store is not None, "no checkpoint store"
        skel = self._state_tree()
        if (self.cfgr.shield is not None
                and "runner/shield_lkg" not in store.leaf_keys(step)):
            # the checkpoint was taken with safe=False: restore everything
            # else and leave the shield at its fresh init (LKG seeds from
            # the restored config on the next batch)
            for k in ("shield_lkg", "shield_radius",
                      "shield_streak", "shield_risk"):
                skel["runner"].pop(k, None)
        if "runner/shard_draws" not in store.leaf_keys(step):
            skel["runner"].pop("shard_draws")   # an older checkpoint
        tree, step, x = store.restore(skel, step=step, host=True)

        ag = self.cfgr.agent
        dev = ag.device
        t = lambda a: torch.as_tensor(np.asarray(a), device=dev)
        ag._write_state(
            {k: t(v) for k, v in tree["agent"]["params"].items()},
            {"nu": {k: t(v) for k, v in
                    tree["agent"]["opt_state"]["nu"].items()},
             "count": t(tree["agent"]["opt_state"]["count"])})
        ag.n_updates = int(x["n_updates"])
        _set_rng_state(ag._rng, x["agent_rng"])
        _set_gen_state(ag._act_draws, tree["agent"]["act_draws"])

        rng_range = self.cfgr.encoder._range
        rng_range.lo = np.asarray(tree["encoder"]["lo"], np.float64)
        rng_range.hi = np.asarray(tree["encoder"]["hi"], np.float64)

        self._load_fleet(self.shadow_env, tree["shadow"],
                         x["configs"]["shadow"], x["dev"]["shadow"])
        self._load_fleet(self.canary_env, tree["canary"],
                         x["configs"]["canary"], x["dev"]["canary"])
        self._load_fleet(self.live_env, tree["live"],
                         x["configs"]["live"], x["dev"]["live"])

        for name, dyn in self.cfgr.disc.bins.items():
            b = tree["bins"][name]
            dyn._edges = np.asarray(b["edges"], np.float64).copy()
            dyn._hits = np.asarray(b["hits"], np.int64).copy()
            dyn._since_used = np.asarray(b["since_used"], np.int64).copy()
            m = x["bins_meta"][name]
            dyn._top_streak = m["top_streak"]
            dyn._bot_streak = m["bot_streak"]
            dyn._same_streak = m["same_streak"]
            dyn._last_bin = m["last_bin"]
            _set_rng_state(dyn._rng, m["rng"])

        self.incumbent = dict(x["incumbent"])
        self.gate.load_state(x["gate"])
        self.counters = ServeCounters.from_dict(x["counters"])
        self.cycle = int(x["cycle"])
        self.history.truncate_to_cycle(self.cycle)
        self.cfgr._last_fleet_windows = None

        if self.cfgr.device_loop_reason() is None:
            self._load_runner(tree["runner"], x)
        sh = x.get("shield")
        if sh is not None and self.cfgr.shield is not None:
            from repro_torch.monitoring.metrics import ShieldCounters
            self._budget_seen = int(sh["budget_seen"])
            self.cfgr.shield_counters = ShieldCounters.from_dict(
                sh["counters"])
            runner = self.cfgr._runner
            if runner is not None:
                runner.shield = self.cfgr.shield_counters
        return step

    def _load_runner(self, rt: dict, x: dict) -> None:
        """The device runner's carries, through its own path: with these
        set, the next batch's ``_load_fresh`` reuses the carried per-node
        window metrics and config indices instead of re-observing (which
        would advance the clock and fork the stream) and copies them into
        the carry buffers the captured programs read. Programs captured at
        another tick or table budget go: re-packing at the restored budget
        rebinds the tensors they read."""
        from repro_torch.core.discretize import DeviceLeverTable

        runner = self.cfgr._device_runner()
        if runner._inflight or runner._carry is not None:
            raise RuntimeError("restore with episode batches in flight")
        rx = x["runner"]
        hw = (int(rx["hw_T"]), int(rx["hw_B"]))
        if hw != (runner._hw_T, runner._hw_B):
            runner._programs.clear()
        runner._hw_T, runner._hw_B = hw
        dev = runner.device
        i64 = dict(dtype=torch.int64, device=dev)
        if not rx["has"]:
            runner._per_node = runner._config_idx = None
            runner._clock_mark = None
            runner._hist = runner._shield = None
        else:
            runner._per_node = torch.as_tensor(
                np.asarray(rt["per_node"]), dtype=torch.float32, device=dev)
            runner._config_idx = torch.as_tensor(
                np.asarray(rt["config_idx"]), **i64)
            runner._clock_mark = self.shadow_env.clock.copy()
            table = DeviceLeverTable.from_discretiser(self.cfgr.disc)
            runner._bins_sig = tuple(e.tobytes() if e is not None else b""
                                     for e in table._edges)
            runner._hist = (torch.as_tensor(np.asarray(rt["hist"]), **i64)
                            if rx.get("hist") else None)
            if rx.get("shield") and "shield_lkg" in rt:
                runner._shield = (
                    torch.as_tensor(np.asarray(rt["shield_lkg"]), **i64),
                    torch.as_tensor(np.asarray(rt["shield_radius"]), **i64),
                    torch.as_tensor(np.asarray(rt["shield_streak"]), **i64),
                    torch.as_tensor(np.asarray(rt["shield_risk"]),
                                    dtype=torch.float32, device=dev))
            else:
                runner._shield = None
        ch = x.get("chaos")
        if ch:
            for k, v in ch.items():
                setattr(runner.chaos, k, v)
        shards = np.asarray(rt.get("shard_draws", np.zeros((), np.uint8)))
        blk = runner._block
        if shards.ndim == 2 and blk is not None and blk.rank < len(shards):
            _set_gen_state(self.shadow_env._dev.draws.for_shard(blk.rank),
                           shards[blk.rank])
