"""Device-resident Algorithm 1 on PyTorch: the fused episode batch (DESIGN.md
§10, §11) — the port of ``repro.core.device_loop``.

One Algorithm-1 episode batch (S steps × N parallel episodes) runs on the
card with no host round-trip inside it:

    for each step (a Python loop over S; each op is an eager device op):
      encode    heat-map states from the carried per-node window metrics +
                integerised lever fractions (fleet-batch running range)
      act       ``repro_torch.core.policy._sample_actions`` (f-gated
                Gumbel-max sampling, or argmax when greedy)
      apply     integerised lever move (``DeviceLeverTable.step_index`` with
                ``xp=txp``) + packed-coefficient gather, loading-time
                buffering, reconfiguration accounting
      stabilise paper-§4.2 wait from the on-device service-term delta
      observe   ``repro_torch.engine.fleet_torch.build_step_window`` — one
                ``fleet_tick`` kernel launch per window, rate grids from the
                packed ``DeviceWorkloadTable`` at the carried clock
      reward    the window's device-computed mean (``neg_mean``), p99
                (``neg_p99``) or SLO-shaped penalty (``slo``)

The batch returns the (N, S) states/actions/rewards for
``ReinforceAgent.update_batch_async`` plus the per-step bookkeeping from
which ``StepRecord``s are materialised once per batch. The dict-based
``LeverDiscretiser`` stays authoritative for §2.4.1 adaptation: after each
batch the chosen (lever, bin) assignments are replayed into its
``DynamicBins`` host-side, and the next batch re-packs the table.

Where the reference donates its loop-state buffers, the port updates the
config-index carry IN PLACE on a per-batch clone (the caller's tensor is
never written); every other carry is rebound to fresh tensors per step.

Ported branches: one device (no fleet mesh), no fault table (no deploy
ring), no safety shield. ``run_pipelined``, ``run_epoch`` and the mesh wrap
wait (ROADMAP queue 1, item 4).
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as Fn

from repro_torch.core.discretize import DeviceLeverTable
from repro_torch.core.heatmap import node_grid_shape
from repro_torch.core.policy import _sample_actions
from repro_torch.data.workloads import (device_workload_reason,
                                        pack_device_workloads)
from repro_torch.engine.fleet_torch import (_bucket, build_step_window,
                                            workload_rate_grid)
from repro_torch.engine.simcluster import (_LEVER_TO_PACKED, _PACKERS,
                                           service_terms_arrays)
from repro_torch.utils import txp

#: padded tick budget when ``batch_interval_s`` is in the action set (the
#: episode can walk it low); clusters past (window+stab)/TICK_BUDGET see a
#: truncated window — the documented §10 deviation.
TICK_BUDGET = 192

#: padded bin-table ladder: §2.4.1 splits double a lever's bin count between
#: episode batches; tables are padded up this ladder so their shapes stay
#: stable. Indices are clipped to ``n_valid``, so padded slots are unreachable.
_BIN_BUCKETS = (16, 32, 64, 128, 256, 512)


def build_packed_tables(table: DeviceLeverTable,
                        pad_to: int = 0) -> list[tuple]:
    """Compile the service-model lever extractors (``_PACKERS``) into per-bin
    coefficient tables: entry ``tab[b]`` is the packed value of the source
    lever's bin b, so the device config -> ``cc`` arrays is one gather per
    packed key. ``pad_to`` edge-pads every table to one shape."""
    out = []
    for lever, keys in _LEVER_TO_PACKED.items():
        li = table.index_of[lever]
        vals = [table.value_of(li, b) for b in range(int(table.n_valid[li]))]
        for key in keys:
            tab = np.array([_PACKERS[key]({lever: v}) for v in vals],
                           np.float32)
            if pad_to > len(tab):
                tab = np.pad(tab, (0, pad_to - len(tab)), mode="edge")
            out.append((key, li, tab))
    return out


def env_device_reason(env) -> Optional[str]:
    """The environment-level half of ``DeviceEpisodeRunner.supported`` —
    usable before a configurator exists."""
    if getattr(env, "n_clusters", 0) < 1:
        return "serial TuningEnv (the fused loop is fleet-shaped)"
    if getattr(env, "backend", "numpy") != "torch":
        return (f"backend={getattr(env, 'backend', 'numpy')} "
                "(needs torch)")
    reason = device_workload_reason(env.workloads)
    if reason is not None:
        return f"workloads not device-packable ({reason})"
    return None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class DeviceEpisodeRunner:
    """Runs the fused episode batches of one ``Configurator`` and the
    host-side handoff around them."""

    def __init__(self, cfgr):
        self.cfgr = cfgr
        self.env = cfgr.env
        self.device = cfgr.device
        self._step_windows: dict = {}
        self._per_node = None          # device (N, nodes, M_sel) carry
        self._clock_mark: Optional[np.ndarray] = None
        self._config_idx = None        # device (N, n_levers) int64 carry
        self._table: Optional[DeviceLeverTable] = None
        self._bins_sig = None
        self._disc_sig = None          # oracle edge hash: re-pack skip
        self._hw_T = 0
        self._hw_B = 0
        self._wl_dev: Optional[dict] = None
        #: the not-yet-adopted device carry and the dispatched but not yet
        #: materialised episode batches
        self._carry = None
        self._inflight: list[dict] = []
        self._epoch_configs: Optional[list] = None
        self._epoch_t0 = 0.0
        self.last_wall_s = 0.0
        from repro_torch.monitoring.metrics import ChaosCounters
        self.chaos = ChaosCounters()

    # ------------------------------------------------------------------ gates
    def supported(self) -> Optional[str]:
        """None when the fused loop can run; otherwise the reason."""
        reason = env_device_reason(self.env)
        if reason is not None:
            return reason
        if self.cfgr.reward_mode not in ("neg_mean", "neg_p99", "slo"):
            return f"reward_mode={self.cfgr.reward_mode} has no device statistic"
        return None

    # -------------------------------------------------------------- geometry
    def _tick_budget(self) -> tuple[int, int]:
        env, cfgr = self.env, self.cfgr
        T_b = env.packed()["T_b"]
        need = int(np.max(np.round(cfgr.window_s / T_b)
                          + np.ceil(180.0 / T_b))) + 1
        if "batch_interval_s" in cfgr.levers:
            # the policy can walk the tick length mid-batch: CLAMP the
            # window to TICK_BUDGET instead of chasing ever-smaller T_b
            need = TICK_BUDGET
        T = max(_bucket(need), self._hw_T)
        self._hw_T = T
        E = _bucket(int(np.ceil(cfgr.window_s / 60.0)) + 1,
                    (1, 2, 4, 6, 8, 12, 16, 24, 32))
        return T, E

    def _step_window(self, T: int, E: int, slo_ms: float):
        key = (T, E, self._sel_cols, slo_ms)
        if key not in self._step_windows:
            self._step_windows[key] = build_step_window(
                self.env, self._sel_cols, T, E, slo_ms=slo_ms)
        return self._step_windows[key]

    # -------------------------------------------------------------- episode
    def _episode(self, draws, carry: tuple, *, S: int, exploit: bool,
                 greedy: bool) -> tuple:
        """One fused episode batch from ``carry`` (config_idx, backlog,
        sfree, clock, last_service, reconfigs, lo, hi, per_node). Returns the
        final carry and the (N, S) per-step outputs."""
        cfgr, env = self.cfgr, self.env
        spec = env.spec
        T, E = self._tick_budget()
        slo = cfgr.reward_mode == "slo"
        slo_ms, hinge_w, breach_w = ((cfgr.slo_ms, cfgr.slo_hinge_w,
                                      cfgr.slo_breach_w) if slo
                                     else (0.0, 0.0, 0.0))
        step_window = self._step_window(T, E, slo_ms)
        nodes = env.n_nodes
        r, c = node_grid_shape(nodes)
        rc = r * c
        M_sel = len(self._sel_cols)
        table, tabs = self._table, self._tabs
        n_valid, kind_code = self._n_valid, self._kind_code
        ranked = self._ranked
        policy, f = cfgr.agent.policy, float(cfgr.agent.f)

        (config_idx, backlog, sfree, clock, last_service, reconfigs, lo, hi,
         per_node) = carry
        config_idx = config_idx.clone()       # updated in place below
        N = config_idx.shape[0]
        rows = torch.arange(N, device=self.device)
        frac_den = torch.clamp(n_valid[ranked].to(torch.float32) - 1.0,
                               min=1.0)
        outs: dict = {}
        for t in range(S):
            sd = draws.step(t)
            # ---- encode: fleet-batch running range + heat-map grids ----
            raw = per_node.permute(0, 2, 1)               # (N, M_sel, nodes)
            lo = torch.minimum(lo, raw.amin(dim=(0, 2)))
            hi = torch.maximum(hi, raw.amax(dim=(0, 2)))
            span = torch.where(hi > lo, hi - lo, 1.0)
            lo_eff = torch.where(torch.isfinite(lo), lo, 0.0)
            normed = torch.clamp(torch.nan_to_num(
                (raw - lo_eff[None, :, None]) / span[None, :, None]), 0.0, 1.0)
            grids = Fn.pad(normed, (0, rc - nodes))
            fracs = config_idx[:, ranked].to(torch.float32) / frac_den
            states = torch.cat([grids.reshape(N, M_sel * rc), fracs],
                               dim=1).to(torch.float32)

            # ---- act (policy forward + f-gated sampling / argmax) ----
            a = _sample_actions(policy, states, sd, f, exploit, greedy)
            direction = 1 - 2 * (a % 2)
            l_idx = ranked[a // 2]

            # ---- integerised lever apply (the table's one implementation)
            cur = config_idx[rows, l_idx]
            new_bin = table.step_index(cur, l_idx, direction, xp=txp,
                                       n_valid=n_valid, kind_code=kind_code)
            config_idx[rows, l_idx] = new_bin
            cc = {kk: tabs[kk][config_idx[:, li]] for kk, li in self._cc_pairs}

            # ---- loading (Kafka buffers arrivals, paper §4.2) ----
            rate_now, _ = workload_rate_grid(self._wl_dev, clock)
            z = sd.load(N)
            load_s = (10.0 + 60.0 * self._reboot_f[l_idx]
                      + 8.0 * self._rejit_f[l_idx]) \
                * (1.0 + spec.noise * torch.abs(z))
            backlog = backlog + rate_now * load_s
            clock = clock + load_s
            sfree = torch.clamp(sfree - load_s, min=0.0)
            reconfigs = reconfigs + 1.0

            # ---- stabilisation wait from the service-term delta (rates at
            # the post-load clock) ----
            rate_st, size_st = workload_rate_grid(self._wl_dev, clock)
            s_new = service_terms_arrays(cc, self._mc, spec, env.chips,
                                         rate_st, size_st, xp=txp)["service"]
            prev = torch.where(last_service < 0.0, s_new, last_service)
            rel = torch.abs(s_new - prev) / torch.clamp(prev, min=1e-6)
            stab = torch.clamp(30.0 + 240.0 * rel, 30.0, 180.0)
            last_service = s_new

            # ---- fused preroll + observation window + reward ----
            (backlog, sfree, clock), stats = step_window(
                sd.window(), backlog, sfree, clock, cc, self._wl_dev, stab,
                reconfigs, float(cfgr.window_s))
            per_node = stats["per_node"]
            if cfgr.reward_mode == "neg_p99":
                reward = -stats["p99_ms"] / 1000.0
            elif slo:
                reward = (-stats["mean_ms"] / 1000.0
                          - hinge_w * torch.clamp(stats["p99_ms"] - slo_ms,
                                                  min=0.0) / 1000.0
                          - breach_w * stats["breach_frac"])
            else:
                reward = -stats["mean_ms"] / 1000.0
            step_out = {"states": states, "actions": a, "rewards": reward,
                        "p99_ms": stats["p99_ms"], "clock_s": clock,
                        "load_s": load_s, "stab_s": stab, "lever": l_idx,
                        "bin": new_bin}
            if slo:
                step_out["breach_frac"] = stats["breach_frac"]
            for k, v in step_out.items():
                outs.setdefault(k, []).append(v)
        # (S, N) -> (N, S): the episode axis leads, ready for the update
        outs = {k: torch.stack(v, dim=1) for k, v in outs.items()}
        carry = (config_idx, backlog, sfree, clock, last_service, reconfigs,
                 lo, hi, per_node)
        return carry, outs

    # ------------------------------------------------------------------- run
    def run(self, *, explore: bool = True, greedy: bool = False):
        """One fused episode batch, synchronously. Returns ``(batch,
        records)``: the device-resident (N, S) states/actions/rewards and
        the host-materialised ``StepRecord``s (cluster-major)."""
        batch = self.run_async(explore=explore, greedy=greedy)
        return batch, self.finalize()

    def run_cycle(self, *, passes: int = 1):
        """One outer Algorithm-1 iteration: ``passes`` chained episode
        batches plus one policy update, with the host's record
        materialisation and bin replay between the update's dispatch and its
        stats pull. Returns ``(stats, records, upd_s)``."""
        b = self._dispatch_group(passes)
        agent = self.cfgr.agent
        t0 = time.perf_counter()
        pending = agent.update_batch_async(b["states"], b["actions"],
                                           b["rewards"])
        dispatch_s = time.perf_counter() - t0
        records = self.finalize()   # host work, device update in flight
        t1 = time.perf_counter()
        stats = pending()
        upd_s = dispatch_s + time.perf_counter() - t1
        return stats, records, upd_s

    def _dispatch_group(self, passes: int) -> dict:
        """One update's worth of chained episode batches, stacked along the
        episode axis, still on device."""
        batches = [self.run_async() for _ in range(max(1, passes))]
        if len(batches) == 1:
            return batches[0]
        return {k: torch.cat([x[k] for x in batches], dim=0)
                for k in batches[0]}

    def run_async(self, *, explore: bool = True, greedy: bool = False):
        """Enqueue one fused episode batch and return its device-resident
        (N, S) batch. Consecutive calls before ``finalize`` chain on the
        device-carried loop state; ``finalize`` adopts the final state and
        materialises every pending batch's host bookkeeping."""
        cfgr = self.cfgr
        if self._carry is None:
            carry = self._fresh_inputs()
            self._epoch_t0 = time.perf_counter()
        else:
            carry = self._carry
        exploit = cfgr.agent.exploit_ready(explore=explore)
        greedy = bool(greedy or not explore)
        S = cfgr.steps_per_episode
        carry, outs = self._episode(self.env._dev.draws.episode(), carry,
                                    S=S, exploit=exploit, greedy=greedy)
        self._carry = carry
        self._inflight.append({"outs": outs, "S": S})
        return {"states": outs["states"], "actions": outs["actions"],
                "rewards": outs["rewards"]}

    def _fresh_inputs(self) -> tuple:
        """Host-side packing for the first batch of an epoch: re-pack the
        integerised lever table from the (possibly adapted) oracle, pack the
        workload table, borrow the engine's queueing state."""
        cfgr, env = self.cfgr, self.env
        dev = env._dev
        device = self.device
        i64 = dict(dtype=torch.int64, device=device)
        f32 = dict(dtype=torch.float32, device=device)

        # re-pack the integerised table unless the last §2.4.1 replay
        # changed no bin edge (exact edge-array hash)
        disc_sig = tuple(d._edges.tobytes()
                         for d in cfgr.disc.bins.values())
        repack = self._table is None or disc_sig != self._disc_sig
        self._disc_sig = disc_sig
        if repack:
            table = DeviceLeverTable.from_discretiser(cfgr.disc)
            self._table = table
            B_pad = max(_bucket(table.max_bins, _BIN_BUCKETS), self._hw_B)
            self._hw_B = B_pad
            packed_tabs = build_packed_tables(table, pad_to=B_pad)
            self._cc_pairs = tuple((k, li) for k, li, _ in packed_tabs)
            self._tabs = {k: torch.as_tensor(tab, **f32)
                          for k, li, tab in packed_tabs}
            self._kind_code = torch.as_tensor(table.kind_code, **i64)
            self._n_valid = torch.as_tensor(table.n_valid, **i64)
            self._reboot_f = torch.as_tensor(
                [1.0 if s.reboot else 0.0 for s in table.specs], **f32)
            self._rejit_f = torch.as_tensor(
                [1.0 if s.group in ("kernel", "memory", "parallel") else 0.0
                 for s in table.specs], **f32)
            self._ranked = torch.as_tensor(
                [table.index_of[n] for n in cfgr.levers], **i64)
        table = self._table
        if self._wl_dev is None:
            tbl = pack_device_workloads(env.workloads)
            self._wl_dev = {k: torch.as_tensor(v, device=device)
                            for k, v in tbl.asdict().items()}
        configs = env.current_configs()
        self._epoch_configs = configs
        # between consecutive fused batches the configs are exactly what the
        # previous batch wrote: reuse its final index tensor unless the
        # binning adapted or someone else stepped the env (clock)
        sig = tuple(e.tobytes() if e is not None else b""
                    for e in table._edges)
        if (self._config_idx is not None and sig == self._bins_sig
                and self._clock_mark is not None
                and np.array_equal(self._clock_mark, env.clock)):
            config_idx = self._config_idx
        else:
            config_idx = torch.as_tensor(table.index_configs(configs), **i64)
        self._bins_sig = sig

        self._sel_cols = tuple(env.metric_names.index(m)
                               for m in cfgr.hspec.metric_names)
        self._mc = dev._mc_dev
        # carried per-node metrics: reuse the previous batch's final window
        # unless someone stepped the env in between (clock moved)
        if (self._per_node is None or self._clock_mark is None
                or not np.array_equal(self._clock_mark, env.clock)):
            stats = env.observe_stats(cfgr.window_s)
            sel = torch.as_tensor(self._sel_cols, **i64)
            self._per_node = stats["per_node"][:, :, sel]
        per_node = self._per_node

        backlog, sfree, clock = dev.loop_state()
        last_service = np.where(np.isnan(env.last_service), -1.0,
                                env.last_service)
        rng_range = cfgr.encoder._range
        return (config_idx, backlog, sfree, clock,
                torch.as_tensor(last_service, **f32),
                torch.as_tensor(env.reconfigs, **f32),
                torch.as_tensor(rng_range.lo, **f32),
                torch.as_tensor(rng_range.hi, **f32), per_node)

    # -------------------------------------------------------------- finalize
    def finalize(self) -> list:
        """Wait for the dispatched batches, hand the queueing state back to
        the engine, materialise every batch's ``StepRecord``s and replay the
        chosen bins into the adaptive oracle (§2.4.1, batch order). Returns
        the records, cluster-major per batch."""
        if not self._inflight:
            return []
        cfgr, env = self.cfgr, self.env
        inflight, self._inflight = self._inflight, []
        carry, self._carry = self._carry, None
        _sync(self.device)
        self.last_wall_s = time.perf_counter() - self._epoch_t0
        total_steps = sum(e["S"] for e in inflight) * env.n_clusters
        self.chaos.add_wall(self.last_wall_s)

        (config_idx_f, backlog_f, sfree_f, clock_f, last_service_f,
         reconfigs_f, lo_f, hi_f, per_node_f) = carry
        env._dev.adopt_loop_state(backlog_f, sfree_f, clock_f)
        env.reconfigs[:] = reconfigs_f.cpu().numpy().astype(np.int64)
        env.last_service[:] = last_service_f.cpu().numpy().astype(np.float64)
        rng_range = cfgr.encoder._range
        rng_range.lo = lo_f.cpu().numpy().astype(np.float64)
        rng_range.hi = hi_f.cpu().numpy().astype(np.float64)
        self._per_node = per_node_f
        self._config_idx = config_idx_f
        self._clock_mark = env.clock.copy()

        configs = self._epoch_configs
        records: list = []
        gen_s = self.last_wall_s / max(total_steps, 1)
        for entry in inflight:
            configs = self._materialise(entry, configs, records, gen_s)
        env.configs = configs
        env.invalidate()
        return records

    def _materialise(self, entry: dict, configs: list, records: list,
                     gen_s: float) -> list:
        """StepRecords + §2.4.1 bin replay for ONE batch; returns the
        batch's final config dicts (the next chained batch starts there)."""
        env, table = self.env, self._table
        outs = {k: v.cpu().numpy() for k, v in entry["outs"].items()
                if k != "states"}
        S = entry["S"]
        N = env.n_clusters
        lever, new_bin = outs["lever"], outs["bin"]            # (N, S)
        lever_l, bin_l = lever.tolist(), new_bin.tolist()
        self.chaos.record_batch(outs["rewards"], outs["p99_ms"],
                                outs.get("breach_frac"),
                                slo_ms=self.cfgr.slo_ms)
        rewards = outs["rewards"].tolist()
        p99 = outs["p99_ms"].tolist()
        clock_s = outs["clock_s"].tolist()
        load_s = outs["load_s"].tolist()
        stab_s = outs["stab_s"].tolist()
        directions = (1 - 2 * (outs["actions"] % 2)).tolist()
        from repro_torch.core.configurator import StepRecord

        # the action set only reaches a few levers × bins: memoise the decode
        val_cache: dict = {}
        names = table.names
        final_configs = []
        for i in range(N):
            cfg = configs[i]
            lv_i, bn_i, dir_i = lever_l[i], bin_l[i], directions[i]
            rw_i, p_i, ck_i = rewards[i], p99[i], clock_s[i]
            ld_i, st_i = load_s[i], stab_s[i]
            for t in range(S):
                li, b = lv_i[t], bn_i[t]
                val = val_cache.get((li, b))
                if val is None:
                    val = val_cache[(li, b)] = table.value_of(li, b)
                cfg = dict(cfg)
                cfg[names[li]] = val
                records.append(StepRecord(
                    lever=names[li], direction=dir_i[t],
                    config=cfg, reward=rw_i[t],
                    p99_ms=p_i[t], clock_s=ck_i[t],
                    phases={"generation_s": gen_s,
                            "loading_s": ld_i[t],
                            "stabilisation_s": st_i[t],
                            "update_s": 0.0}))
            final_configs.append(dict(cfg))

        # ---- replay the chosen bins into the adaptive oracle (§2.4.1),
        # step-major, one batched record_many per lever ----
        bins = self.cfgr.disc.bins
        lever_sm = lever.T.ravel()
        bin_sm = new_bin.T.ravel()
        for li in np.unique(lever_sm):
            dyn = bins.get(names[li])
            if dyn is not None:
                dyn.record_many(bin_sm[lever_sm == li])
        return final_configs
