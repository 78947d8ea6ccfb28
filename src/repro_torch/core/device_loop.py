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
                kernel launch per window (``fleet_tick``, or ``fleet_scan``
                on a ``window_impl="scan"`` fleet), rate grids from the
                packed ``DeviceWorkloadTable`` at the carried clock
      reward    the window's device-computed mean (``neg_mean``), p99
                (``neg_p99``) or SLO-shaped penalty (``slo``)

The batch returns the (N, S) states/actions/rewards for
``ReinforceAgent.update_batch_async`` plus the per-step bookkeeping from
which ``StepRecord``s are materialised once per batch. The dict-based
``LeverDiscretiser`` stays authoritative for §2.4.1 adaptation: after each
batch the chosen (lever, bin) assignments are replayed into its
``DynamicBins`` host-side, and the next batch re-packs the table.

**Captured programs (§10, §14, §15).** Where the reference jits one
episode batch per static shape bundle (``_program``), the port captures it
as a CUDA graph (``repro_torch.core.graphs.Program``) and replays it. The
graph reads every input at a fixed address: the loop-state carry lives in
static buffers that ``_fresh_inputs`` fills at an epoch's start and the
captured batch overwrites with its final state (chained batches need no
copies), the lever tables are re-packed into the same tensors while their
``_BIN_BUCKETS`` rung holds, and the policy reads the agent's parameters,
which every update overwrites in place. A rung crossing or a longer tick
budget is a new bundle and a new capture, as it is a recompile for the
reference. On the CPU the same program objects run ``_episode`` eagerly on
the same buffers.

**Pipeline (§14) and epoch (§15).** ``run_pipelined`` keeps ``depth-1``
episode groups enqueued ahead of the update that uses them, on one stream,
so dispatch order alone gives the reference's staleness. ``run_epoch(K)``
replays one captured body — the episode groups, the policy update and the
records mode's reductions — K times with no host sync between updates
(``EPOCH_DISPATCHES`` counts the replays); the §2.4.1 replay runs at the
epoch boundary.

**Fault scenarios (§12).** When the fleet carries a ``DeviceFaultTable``
(``FleetEnv(..., faults=...)``), its device copy rides into every window
step: straggler/failure/backlog-shock events are evaluated on the device
(``fault_effect_grid``) and reach the window's kernel through its
``fmult`` operand, and ``DeployLatencyFault`` clusters run the config they
requested ``delays[i]`` steps ago — a carried (R_max+1, N, L) ring of
config indices — while the encoder still shows the requested knobs.

**Safety shield (§16).** With ``Configurator(safe=True)`` each step masks
the policy's logits to the trust region around the last-known-good (LKG)
config, takes the unmasked counterfactual pick from the same draws, clamps
the move into the region and falls back to the whole LKG row when a
cluster's breach risk or its episode budget says so; after the window
``shield_update`` advances the carry (LKG, radius, streak, risk; the
per-episode budget is dropped after the episode). The integer leaves are
int64, the dtype of the config-index carry (the reference's are int32:
the values are the same).

**Fleet mesh (§11).** With a 1-D ``DeviceMesh`` over a
``torch.distributed`` process group (``Configurator(mesh=...)``, or
``"auto"``: ``fleet_mesh()`` whenever the world size divides N) every rank
holds the whole fleet and runs the episode SPMD on its contiguous block of
clusters ``[r·N/R, (r+1)·N/R)``: the carry buffers, the workload, model,
emission and fault tables and the deploy lags are sliced by the one table
of ``repro_torch.distribution.sharding.fleet_episode_specs``; the draws
come from ``draws.for_shard(r)`` (shard 0 is the unsharded stream, so a
1-rank mesh replays the unsharded run bit for bit); each step all-reduces
the running range (MIN/MAX, the reference's ``pmin``/``pmax``); the
episode ends with one all-gather of the per-cluster carry and outputs, so
every rank holds the whole fleet again and the update runs replicated on
the whole batch (its baseline and advantage normalisation are means over
all N episodes), leaving the parameters equal on every rank. After each
epoch the engine's own draw stream is copied from rank 0, so the fleet's
state, stream included, is the same everywhere. Every rank issues the same
collectives in the same order: the episode's, once per batch, whatever
the schedule (sequential, pipelined, epoch). On an NCCL mesh the programs
capture their collectives into the CUDA graphs; on a gloo mesh they run
eagerly (``graph_reason`` says which).
"""
from __future__ import annotations

import operator
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as Fn

from repro_torch.core.discretize import DeviceLeverTable, shield_update
# CAPTURE_COUNTS: re-exported, the twin of the reference's TRACE_COUNTS
from repro_torch.core.graphs import CAPTURE_COUNTS, Program  # noqa: F401
from repro_torch.core.heatmap import node_grid_shape
from repro_torch.core.policy import _sample_actions
from repro_torch.data.workloads import (device_workload_reason,
                                        pack_device_workloads)
from repro_torch.distribution import sharding as shd
from repro_torch.engine.fleet_torch import (_bucket, build_step_window,
                                            workload_rate_grid)
from repro_torch.engine.simcluster import (_LEVER_TO_PACKED, _PACKERS,
                                           service_terms_arrays)
from repro_torch.monitoring.tracing import span
from repro_torch.utils import txp

#: epoch body calls (DESIGN.md §15): ``run_epoch(K)`` calls its captured
#: body once per update — K graph launches an epoch, never O(K·S·ops) eager
#: ones (the reference counts one jitted program per warm-up segment)
EPOCH_DISPATCHES = [0]

#: the batch prologue's static facts, derived again only when what they
#: read changes: ``support_checked`` counts the support check's walks of
#: the workload roster, ``support_reused`` the checks answered from the
#: runner's memo of the same roster, ``tick_pack_skipped`` the tick budgets
#: clamped to ``TICK_BUDGET`` without packing the fleet's configs,
#: ``tick_packed`` those read from the packed configs' tick lengths
PROLOGUE_COUNTS = {"support_checked": 0, "support_reused": 0,
                   "tick_pack_skipped": 0, "tick_packed": 0}

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


def env_device_reason(env, workload_reason=device_workload_reason
                      ) -> Optional[str]:
    """The environment-level half of ``DeviceEpisodeRunner.supported`` —
    usable before a configurator exists. ``workload_reason`` checks the
    roster (the runner passes its memoised check)."""
    if getattr(env, "n_clusters", 0) < 1:
        return "serial TuningEnv (the fused loop is fleet-shaped)"
    if getattr(env, "backend", "numpy") != "torch":
        return (f"backend={getattr(env, 'backend', 'numpy')} "
                "(needs torch)")
    reason = workload_reason(env.workloads)
    if reason is not None:
        return f"workloads not device-packable ({reason})"
    return None


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _take(x, name: str, lo: int, n: int):
    """This block's clusters ``[lo, lo+n)`` of the episode leaf ``name``
    (a tensor, a dict of tensors or None), by its cluster dimension in
    ``fleet_episode_specs``' table: views, so fixed addresses stay fixed."""
    d = shd.cluster_dim(name)
    if x is None or d is None:
        return x
    if isinstance(x, dict):
        return {k: v.narrow(d, lo, n) for k, v in x.items()}
    return x.narrow(d, lo, n)


class _Block:
    """The clusters this rank's episodes run on: ``[lo, lo+n)`` of the
    fleet, on the mesh's ``group`` as shard ``rank``."""

    def __init__(self, mesh, n_clusters: int):
        self.group = mesh.get_group(0)
        self.rank = mesh.get_local_rank(0)
        self.n = n_clusters // mesh.size()
        self.lo = self.rank * self.n
        self.backend = torch.distributed.get_backend(self.group)


def _into(old: Optional[torch.Tensor], new: torch.Tensor) -> torch.Tensor:
    """``new`` written into ``old`` when their shapes and dtypes match (a
    captured program reads ``old`` at its address), else ``new``."""
    if (old is not None and old.shape == new.shape
            and old.dtype == new.dtype):
        return old.copy_(new)
    return new


class DeviceEpisodeRunner:
    """Runs the fused episode batches of one ``Configurator`` as captured
    programs, one per static shape bundle, and the host-side handoff around
    them."""

    def __init__(self, cfgr):
        self.cfgr = cfgr
        self.env = cfgr.env
        self.device = cfgr.device
        self._programs: dict = {}
        self._step_windows: dict = {}
        self._per_node = None          # device (N, nodes, M_sel) carry
        self._clock_mark: Optional[np.ndarray] = None
        self._config_idx = None        # device (N, n_levers) int64 carry
        self._table: Optional[DeviceLeverTable] = None
        #: the packed lever tables (fixed addresses while the rung holds)
        self._tabs: Optional[dict] = None
        self._kind_code = self._n_valid = self._ranked = None
        self._reboot_f = self._rejit_f = None
        self._bins_sig = None
        self._disc_sig = None          # oracle edge hash: re-pack skip
        self._hw_T = 0
        self._hw_B = 0
        self._wl_dev: Optional[dict] = None
        #: (the roster last checked, its ``device_workload_reason``)
        self._roster_memo: Optional[tuple] = None
        self._ft_dev: Optional[dict] = None   # packed DeviceFaultTable (§12)
        self._delays = None                   # (N,) per-cluster deploy lag
        self._R_max = 0                       # deploy-ring depth
        self._hist = None                     # carried config-index ring
        #: §16 shield carry across batches: (lkg (N, L), radius (N,),
        #: streak (N,), risk (N,) f32); None until the first safe batch
        #: packs it (or after a table re-index)
        self._shield = None
        self._idx0 = None                     # pre-batch indices (shield sync)
        #: the static carry buffers every program reads and writes (the
        #: layout of ``_episode``'s carry), and the epoch's (lever, bin)
        #: count buffer
        self._bufs: Optional[tuple] = None
        self._counts = None
        #: the carry buffers while they hold a not-yet-adopted state, and
        #: the dispatched but not yet materialised episode batches
        self._carry = None
        self._inflight: list[dict] = []
        self._epoch_configs: Optional[list] = None
        self._epoch_t0 = 0.0
        self.last_wall_s = 0.0
        from repro_torch.monitoring.metrics import ChaosCounters, ShieldCounters
        self.chaos = ChaosCounters()
        #: one counter object per configurator: the host-loop twin feeds the
        #: same instance
        self.shield = getattr(cfgr, "shield_counters", None) or ShieldCounters()
        #: the fleet mesh (None: one device) and this rank's block on it
        self.mesh = self._resolve_mesh()
        self._block = (None if self.mesh is None
                       else _Block(self.mesh, self.env.n_clusters))
        #: per-cluster episode inputs of this rank's block (views of the
        #: whole fleet's; the whole tensors without a mesh)
        self._inputs: dict = {}
        #: why the programs run eagerly on the card, or None (captured)
        self.graph_reason = None
        if self._block is not None and self._block.backend == "gloo":
            self.graph_reason = (
                "eager: gloo collectives run on the host and cannot be "
                "captured into a CUDA graph")

    def _resolve_mesh(self):
        """The cluster-sharding mesh (DESIGN.md §11): an explicit 1-D
        ``DeviceMesh`` from the configurator, or (``"auto"``) ``fleet_mesh()``
        whenever the fleet size divides the world size."""
        opt = getattr(self.cfgr, "mesh_opt", "auto")
        if opt in (None, "off"):
            return None
        mesh = shd.fleet_mesh() if opt == "auto" else opt
        if mesh is not None and self.env.n_clusters % mesh.size() != 0:
            if opt != "auto":
                raise ValueError(
                    f"fleet N={self.env.n_clusters} does not divide the "
                    f"{mesh.size()}-device mesh")
            mesh = None
        return mesh

    # ------------------------------------------------------------------ gates
    def supported(self) -> Optional[str]:
        """None when the fused loop can run; otherwise the reason."""
        reason = env_device_reason(self.env, self._workload_reason)
        if reason is not None:
            return reason
        if self.cfgr.reward_mode not in ("neg_mean", "neg_p99", "slo"):
            return f"reward_mode={self.cfgr.reward_mode} has no device statistic"
        return None

    def _workload_reason(self, workloads) -> Optional[str]:
        """``device_workload_reason`` of the roster, walked again only when
        it holds other workload objects than the last walk's (compared by
        identity, element for element; the memo holds them, so no id is
        reused). ``_wl_dev`` is packed once: a replaced roster is checked,
        not re-packed."""
        memo = self._roster_memo
        if (memo is not None and len(memo[0]) == len(workloads)
                and all(map(operator.is_, memo[0], workloads))):
            PROLOGUE_COUNTS["support_reused"] += 1
            return memo[1]
        PROLOGUE_COUNTS["support_checked"] += 1
        reason = device_workload_reason(workloads)
        self._roster_memo = (tuple(workloads), reason)
        return reason

    # -------------------------------------------------------------- geometry
    def _tick_budget(self) -> tuple[int, int]:
        env, cfgr = self.env, self.cfgr
        if "batch_interval_s" in cfgr.levers:
            # the policy can walk the tick length mid-batch: CLAMP the
            # window to TICK_BUDGET instead of chasing ever-smaller T_b
            # (so the configs' T_b is not read, nor packed)
            need = TICK_BUDGET
            PROLOGUE_COUNTS["tick_pack_skipped"] += 1
        else:
            T_b = env.packed()["T_b"]
            PROLOGUE_COUNTS["tick_packed"] += 1
            need = int(np.max(np.round(cfgr.window_s / T_b)
                              + np.ceil(180.0 / T_b))) + 1
        T = max(_bucket(need), self._hw_T)
        self._hw_T = T
        E = _bucket(int(np.ceil(cfgr.window_s / 60.0)) + 1,
                    (1, 2, 4, 6, 8, 12, 16, 24, 32))
        return T, E

    def _step_window(self, T: int, E: int, slo_ms: float, impl: str):
        blk = self._block
        clusters = None if blk is None else (blk.lo, blk.n)
        key = (T, E, self._sel_cols, slo_ms, clusters, impl)
        if key not in self._step_windows:
            self._step_windows[key] = build_step_window(
                self.env, self._sel_cols, T, E, slo_ms=slo_ms,
                window_impl=impl, clusters=clusters)
        return self._step_windows[key]

    def _skey(self, exploit: bool, greedy: bool) -> tuple:
        """The static bundle of one episode batch (the reference's ``skey``
        without its mesh entry, plus N, the table rung and the exploitation
        factor, which the captured batch bakes in; the env's resolved
        window impl, last, stands for the reference's pallas entry)."""
        cfgr = self.cfgr
        with span("rt.epoch.tick_budget"):
            T, E = self._tick_budget()
        slo_sig = ((cfgr.slo_ms, cfgr.slo_hinge_w, cfgr.slo_breach_w)
                   if cfgr.reward_mode == "slo" else None)
        return (cfgr.steps_per_episode, T, E, self._sel_cols, exploit,
                greedy, cfgr.reward_mode, float(cfgr.window_s), slo_sig,
                self._R_max, self._ft_dev is not None, cfgr.shield,
                self.env.n_clusters, self._hw_B, float(cfgr.agent.f),
                self.env.window_impl)

    # -------------------------------------------------------------- episode
    def _episode(self, draws, carry: tuple, skey: tuple) -> tuple:
        """One fused episode batch from ``carry`` (config_idx, backlog,
        sfree, clock, last_service, reconfigs, lo, hi, per_node, then the
        deploy ring when the fleet has deploy latency, then the shield's
        lkg, radius, streak and risk when the configurator is safe) at the
        static bundle ``skey``. Returns the final carry in the same layout
        and the (N, S) per-step outputs."""
        cfgr, env = self.cfgr, self.env
        spec = env.spec
        S, T, E, _, exploit, greedy = skey[:6]
        slo = cfgr.reward_mode == "slo"
        slo_ms, hinge_w, breach_w = skey[8] if slo else (0.0, 0.0, 0.0)
        step_window = self._step_window(T, E, slo_ms, skey[15])
        nodes = env.n_nodes
        r, c = node_grid_shape(nodes)
        rc = r * c
        M_sel = len(self._sel_cols)
        table, tabs = self._table, self._tabs
        n_valid, kind_code = self._n_valid, self._kind_code
        ranked = self._ranked
        policy, f = cfgr.agent.policy, skey[14]
        inp, blk = self._inputs, self._block

        (config_idx, backlog, sfree, clock, last_service, reconfigs, lo, hi,
         per_node) = carry[:9]
        config_idx = config_idx.clone()       # updated in place below
        N = config_idx.shape[0]
        rows = torch.arange(N, device=self.device)
        R_max, pos = self._R_max, 9
        hist = None
        if R_max:
            hist = carry[9]
            pos = 10
        sh_spec = cfgr.shield
        if sh_spec is not None:
            lkg_idx, radius, streak, risk = carry[pos:pos + 4]
            # the breach budget is fresh at every episode start
            budget_left = torch.full((N,), sh_spec.breach_budget,
                                     dtype=torch.int64, device=self.device)
        frac_den = torch.clamp(n_valid[ranked].to(torch.float32) - 1.0,
                               min=1.0)
        outs: dict = {}
        for t in range(S):
            sd = draws.step(t)
            # ---- encode: fleet-batch running range + heat-map grids ----
            with span("rt.step.encode"):
                raw = per_node.permute(0, 2, 1)           # (N, M_sel, nodes)
                lo = torch.minimum(lo, raw.amin(dim=(0, 2)))
                hi = torch.maximum(hi, raw.amax(dim=(0, 2)))
                if blk is not None:   # the fleet-global range, all shards
                    lo, hi = shd.range_reduce(lo, hi, blk.group)
                width = torch.where(hi > lo, hi - lo, 1.0)
                lo_eff = torch.where(torch.isfinite(lo), lo, 0.0)
                normed = torch.clamp(torch.nan_to_num(
                    (raw - lo_eff[None, :, None]) / width[None, :, None]),
                    0.0, 1.0)
                grids = Fn.pad(normed, (0, rc - nodes))
                fracs = config_idx[:, ranked].to(torch.float32) / frac_den
                states = torch.cat([grids.reshape(N, M_sel * rc), fracs],
                                   dim=1).to(torch.float32)

            # ---- act (policy forward + f-gated sampling / argmax) ----
            with span("rt.step.act"):
                if sh_spec is not None:
                    # §16 trust-region mask before the pick; the unmasked
                    # counterfactual pick (same draws) feeds clamped_actions:
                    # a diversion is a step where the unshielded policy
                    # would have left the trust region
                    with span("rt.shield"):
                        mask = table.shield_mask(
                            config_idx, lkg_idx, radius, ranked, xp=txp,
                            n_valid=n_valid, kind_code=kind_code)
                    a, a_free = _sample_actions(policy, states, sd, f,
                                                exploit, greedy, mask=mask,
                                                unmasked=True)
                    with span("rt.shield"):
                        sh_diverted = ~torch.gather(mask, 1,
                                                    a_free[:, None])[:, 0]
                else:
                    a = _sample_actions(policy, states, sd, f, exploit,
                                        greedy)
                direction = 1 - 2 * (a % 2)
                l_idx = ranked[a // 2]

            # ---- integerised lever apply (the table's one implementation)
            with span("rt.step.apply"):
                cur = config_idx[rows, l_idx]
                new_bin = table.step_index(cur, l_idx, direction, xp=txp,
                                           n_valid=n_valid,
                                           kind_code=kind_code)
                if sh_spec is not None:
                    # hard trust-region clamp, then the risk/budget
                    # fallback: a cluster whose breach risk crossed the
                    # threshold (or whose episode budget is spent) deploys
                    # its whole LKG row
                    with span("rt.shield"):
                        clamped = table.shield_clamp(
                            new_bin, lkg_idx[rows, l_idx], radius, l_idx,
                            xp=txp, n_valid=n_valid, kind_code=kind_code)
                        sh_clamped = sh_diverted | (clamped != new_bin)
                        fallback = ((risk > sh_spec.risk_threshold)
                                    | (budget_left <= 0))
                        config_idx[rows, l_idx] = clamped
                        config_idx = torch.where(fallback[:, None], lkg_idx,
                                                 config_idx)
                        new_bin = config_idx[rows, l_idx]
                else:
                    config_idx[rows, l_idx] = new_bin
                eff_idx = config_idx
                if R_max:
                    # §12 deploy latency: the engine runs the config cluster
                    # i requested delays[i] steps ago; the encoder above
                    # still shows the requested knobs
                    hist = torch.cat([config_idx[None], hist[:-1]], dim=0)
                    eff_idx = hist[inp["delays"], rows]
                cc = {kk: tabs[kk][eff_idx[:, li]]
                      for kk, li in self._cc_pairs}

            with span("rt.step.loading"):
                # ---- loading (Kafka buffers arrivals, paper §4.2) ----
                rate_now, _ = workload_rate_grid(inp["wl"], clock)
                z = sd.load(N)
                load_s = (10.0 + 60.0 * self._reboot_f[l_idx]
                          + 8.0 * self._rejit_f[l_idx]) \
                    * (1.0 + spec.noise * torch.abs(z))
                backlog = backlog + rate_now * load_s
                clock = clock + load_s
                sfree = torch.clamp(sfree - load_s, min=0.0)
                reconfigs = reconfigs + 1.0

                # ---- stabilisation wait from the service-term delta (rates
                # at the post-load clock) ----
                rate_st, size_st = workload_rate_grid(inp["wl"], clock)
                s_new = service_terms_arrays(cc, inp["mc"], spec, env.chips,
                                             rate_st, size_st,
                                             xp=txp)["service"]
                prev = torch.where(last_service < 0.0, s_new, last_service)
                rel = torch.abs(s_new - prev) / torch.clamp(prev, min=1e-6)
                stab = torch.clamp(30.0 + 240.0 * rel, 30.0, 180.0)
                last_service = s_new

            # ---- fused preroll + observation window + reward ----
            with span("rt.step.window"):
                (backlog, sfree, clock), stats = step_window(
                    sd.window(), backlog, sfree, clock, cc, inp["wl"], stab,
                    reconfigs, float(cfgr.window_s), ft=inp["ft"])
                per_node = stats["per_node"]
                if cfgr.reward_mode == "neg_p99":
                    reward = -stats["p99_ms"] / 1000.0
                elif slo:
                    reward = (-stats["mean_ms"] / 1000.0
                              - hinge_w * torch.clamp(
                                  stats["p99_ms"] - slo_ms, min=0.0) / 1000.0
                              - breach_w * stats["breach_frac"])
                else:
                    reward = -stats["mean_ms"] / 1000.0
            step_out = {"states": states, "actions": a, "rewards": reward,
                        "p99_ms": stats["p99_ms"], "clock_s": clock,
                        "load_s": load_s, "stab_s": stab, "lever": l_idx,
                        "bin": new_bin}
            if slo:
                step_out["breach_frac"] = stats["breach_frac"]
            if sh_spec is not None:
                with span("rt.shield"):
                    (lkg_idx, radius, streak, risk, budget_left,
                     budget_out) = shield_update(
                        stats["breach_frac"], lkg_idx, config_idx, radius,
                        streak, risk, budget_left, sh_spec, xp=txp)
                step_out["shield_clamped"] = sh_clamped
                step_out["shield_fallback"] = fallback
                step_out["budget_out"] = budget_out
            for k, v in step_out.items():
                outs.setdefault(k, []).append(v)
        # (S, N) -> (N, S): the episode axis leads, ready for the update
        outs = {k: torch.stack(v, dim=1) for k, v in outs.items()}
        carry = (config_idx, backlog, sfree, clock, last_service, reconfigs,
                 lo, hi, per_node)
        if R_max:
            carry = carry + (hist,)
        if sh_spec is not None:
            carry = carry + (lkg_idx, radius, streak, risk)
        return carry, outs

    def _chained_episode(self, draws, skey: tuple) -> dict:
        """One episode batch from the carry buffers, its final state
        written back into them (so chained batches need no copies).
        Returns the per-step outputs. On a fleet mesh the episode runs on
        this rank's block of the buffers (views, by the table of
        ``fleet_episode_specs``) and ends with one all-gather of the
        per-cluster carry and outputs: the buffers and the outputs hold
        the whole fleet on every rank."""
        blk = self._block
        if blk is None:
            carry, outs = self._episode(draws.episode(), self._bufs, skey)
            for buf, x in zip(self._bufs, carry):
                buf.copy_(x)
            return outs
        names = shd.episode_carry_leaves(self._R_max,
                                         self.cfgr.shield is not None)
        local = tuple(_take(b, name, blk.lo, blk.n)
                      for b, name in zip(self._bufs, names))
        carry, outs = self._episode(draws.episode(), local, skey)
        dims = [shd.cluster_dim(name) for name in names]
        parts = [(x, d) for x, d in zip(carry, dims) if d is not None]
        whole = iter(shd.cluster_gather(
            parts + [(v, 0) for v in outs.values()], blk.n, blk.group))
        for buf, x, d in zip(self._bufs, carry, dims):
            # the replicated leaves (the running range) are global already
            buf.copy_(x if d is None else next(whole))
        return {k: next(whole) for k in outs}

    def _program(self, key: tuple, body) -> Program:
        """The captured program ``key`` (built on first use): ``body(draws)``
        over the env's current draw source (on a fleet mesh, this rank's
        shard of it), which the key names — a new source is a new
        program."""
        draws = self.env._dev.draws
        if self._block is not None:
            draws = draws.for_shard(self._block.rank)
        pkey = key + (id(draws),)
        prog = self._programs.get(pkey)
        if prog is None:
            prog = Program(key, lambda: body(draws), self.device, (draws,),
                           eager=self.graph_reason,
                           collectives=self._block is not None)
            self._programs[pkey] = prog
        return prog

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

    def run_pipelined(self, updates: int, *, passes: int = 1,
                      depth: int = 2):
        """``updates`` outer iterations as a depth-``depth`` pipelined
        actor/learner (DESIGN.md §14): episode group k+1 is enqueued before
        update k, so the card runs update k behind the episodes that
        explore with the parameters before it.

        One stream orders everything: update k overwrites the parameters in
        place after group k+1 was enqueued, so episodes act on
        (depth-1)-updates-stale parameters (IMPALA-style), as in the
        reference. A group's outputs are copies, not the captured batch's
        memory, because later groups replay before update k reads them.
        One ``finalize`` at the end materialises every batch's records and
        replays the §2.4.1 bins once (binning is frozen across the call).

        ``depth=1`` is the sequential schedule: ``run_cycle`` per update.
        Returns ``(stats_list, records, upd_s_list)``."""
        if updates <= 0:
            return [], [], []
        if depth <= 1:
            out, recs, upds = [], [], []
            for _ in range(updates):
                stats, records, upd_s = self.run_cycle(passes=passes)
                out.append(stats)
                recs.extend(records)
                upds.append(upd_s)
            return out, recs, upds
        agent = self.cfgr.agent
        ahead = depth - 1
        groups: list = []
        thunks: list = []
        upds: list = []
        nxt = 0
        for k in range(updates):
            # keep `ahead` episode groups enqueued past the current update
            while nxt <= min(k + ahead, updates - 1):
                groups.append(self._dispatch_group(passes))
                nxt += 1
            b = groups[k]
            t0 = time.perf_counter()
            thunks.append(agent.update_batch_async(
                b["states"], b["actions"], b["rewards"]))
            upds.append(time.perf_counter() - t0)
            groups[k] = None          # drop the group once its update is in
        records = self.finalize()     # waits for the tail episode batch
        t1 = time.perf_counter()
        stats_list = [t() for t in thunks]
        upds[-1] += time.perf_counter() - t1
        return stats_list, records, upds

    # ---------------------------------------------------------- epoch (§15)
    def run_epoch(self, k: int, *, passes: int = 1,
                  records: str = "full", explore: bool = True):
        """``k`` full outer Algorithm-1 iterations — episode batch → reward
        → policy update — with no host sync between them (DESIGN.md §15):
        one captured body per warm-up segment, replayed once per update.

        Inside the epoch the ``DeviceLeverTable`` is FROZEN; §2.4.1 bin
        adaptation defers to the epoch boundary. ``records`` controls the
        host materialisation: ``"full"`` keeps the per-step outputs and
        emits the sequential path's exact ``StepRecord`` stream;
        ``"summary"`` keeps a per-update reward/p99 summary (convergence
        curves, no records); ``"off"`` per-update loss scalars only. Both
        fold the chosen (lever, bin) pairs into a device count tensor for
        the replay.

        An epoch crossing the agent's exploit warm-up boundary runs two
        bodies (exploitation is static in the captured batch). Returns
        ``(stats_list, records)``; ``records`` is ``[]`` unless
        ``records="full"``."""
        if k <= 0:
            return [], []
        if records not in ("full", "summary", "off"):
            raise ValueError(f"records={records!r} (full|summary|off)")
        if self._inflight or self._carry is not None:
            raise RuntimeError("run_epoch with episode batches in flight")
        with span("rt.epoch"):
            cfgr, env = self.cfgr, self.env
            agent = cfgr.agent
            N, S = env.n_clusters, cfgr.steps_per_episode
            if explore:
                w = min(max(agent.f_warmup_updates - agent.n_updates, 0), k)
                segments = [(kk, ex) for kk, ex in ((w, False), (k - w, True))
                            if kk > 0]
            else:
                segments = [(k, False)]
            greedy = not explore

            sh_spec = cfgr.shield
            with span("rt.epoch.load"):
                self._load_fresh()
                self._epoch_t0 = time.perf_counter()
                # shield runs ALSO need the pre-epoch indices in "full"
                # mode: a fallback step reverts a whole row to LKG, which
                # the per-lever record stream cannot express — final
                # configs re-sync from indices
                idx0 = (None if records == "full" and sh_spec is None
                        else self._bufs[0].cpu().numpy())
                if records != "full":
                    shape = (len(self._table.specs), self._hw_B)
                    if (self._counts is None
                            or tuple(self._counts.shape) != shape):
                        self._counts = torch.zeros(
                            shape, dtype=torch.int32, device=self.device)
                    self._counts.zero_()

            ys_segs: list = []
            for k_seg, exploit in segments:
                with span("rt.epoch.program"):
                    prog = self._epoch_body(self._skey(exploit, greedy),
                                            passes, records)
                ys = []
                for _ in range(k_seg):
                    EPOCH_DISPATCHES[0] += 1
                    out = prog()
                    with span("rt.epoch.outputs"):
                        ys.append({name: v.clone()
                                   for name, v in out.items()})
                with span("rt.epoch.outputs"):
                    ys_segs.append((k_seg, {
                        name: torch.stack([y[name] for y in ys])
                        for name in ys[0]}))
            with span("rt.epoch.sync"):
                _sync(self.device)
            self.last_wall_s = time.perf_counter() - self._epoch_t0
            with span("rt.epoch.adopt"):
                agent.adopt_update(agent.params, agent.opt_state, k)
                total_steps = k * passes * N * S
                self.chaos.add_wall(self.last_wall_s)
                carry, self._carry = self._carry, None
                config_idx_f = self._adopt(carry)

            gen_s = self.last_wall_s / max(total_steps, 1)
            if records == "full":
                with span("rt.epoch.full"):
                    stats_list, recs = self._epoch_full(ys_segs, N, S,
                                                        passes, gen_s)
                    if sh_spec is not None:
                        touched = np.zeros((N, self._table.n_levers), bool)
                        rows = np.arange(N)[:, None]
                        for k_seg, ys in ys_segs:
                            lv = _np(ys["lever"]).reshape(k_seg * passes,
                                                          N, S)
                            for chunk in lv:
                                touched[rows, chunk] = True
                        self._sync_configs(idx0, _np(config_idx_f), touched)
            else:
                with span("rt.epoch.summary"):
                    stats_list = self._epoch_summary(ys_segs, self._counts,
                                                     idx0, config_idx_f, N, S,
                                                     passes)
                recs = []
            cfgr._last_fleet_windows = None   # host-loop cache is stale now
        return stats_list, recs

    def _epoch_body(self, skey: tuple, passes: int, rec_mode: str) -> Program:
        """The captured body of one epoch update: ``passes`` chained episode
        groups, the policy update on their stacked outputs (the agent's
        buffers, in place) and the records mode's per-update outputs —
        the per-step outputs for ``"full"``, the (lever, bin) counts and
        the summary reductions otherwise."""
        agent = self.cfgr.agent
        slo = skey[8] is not None
        slo_ms = float(self.cfgr.slo_ms)
        shield = skey[11] is not None
        B = skey[13]

        def body(draws) -> dict:
            groups = [self._chained_episode(draws, skey)
                      for _ in range(passes)]
            b = groups[0] if passes == 1 else {
                name: torch.cat([g[name] for g in groups], dim=0)
                for name in groups[0]}
            if rec_mode != "full":
                with span("rt.records"):
                    flat = (b["lever"] * B + b["bin"]).reshape(-1)
                    self._counts.view(-1).index_add_(
                        0, flat, torch.ones_like(flat, dtype=torch.int32))
            mask = torch.ones(b["actions"].shape, dtype=torch.float32,
                              device=self.device)
            loss, first = agent._update_in_place(
                b["states"], b["actions"], b["rewards"], mask)
            y = {"pg_loss": loss, "mean_return": first}
            if rec_mode == "full":
                y.update({name: v for name, v in b.items()
                          if name != "states"})
                return y
            with span("rt.records"):
                y["reward_sum"] = b["rewards"].sum()
                y["p99_max"] = b["p99_ms"].max()
                if slo:
                    y["breach_windows"] = (b["breach_frac"] > 0.0).sum()
                    y["breach_frac_sum"] = b["breach_frac"].sum()
                elif slo_ms > 0.0:
                    y["breach_windows"] = (b["p99_ms"] > slo_ms).sum()
                if shield:
                    y["shield_clamped"] = b["shield_clamped"].sum()
                    y["shield_fallbacks"] = b["shield_fallback"].sum()
                    y["budget_exhaustions"] = \
                        b["budget_out"].any(dim=1).sum()
                if rec_mode == "summary":
                    y["reward_mean"] = b["rewards"].mean(dim=1)
                    y["p99_mean"] = b["p99_ms"].mean(dim=1)
                    y["p99_last"] = b["p99_ms"][:, -1]
            return y

        return self._program(("epoch", skey, passes, rec_mode), body)

    def _epoch_full(self, ys_segs, N, S, passes, gen_s):
        """Materialise a ``records="full"`` epoch by replaying
        ``_materialise`` per (update, pass) chunk — record order, §2.4.1
        replay order and chaos accounting match the sequential schedule
        exactly."""
        env = self.env
        configs = self._epoch_configs
        stats_list: list = []
        recs: list = []
        for k_seg, ys in ys_segs:
            for i in range(k_seg):
                for p in range(passes):
                    sl = slice(p * N, (p + 1) * N)
                    outs = {k2: v[i, sl] for k2, v in ys.items()
                            if k2 not in ("pg_loss", "mean_return")}
                    configs = self._materialise(
                        {"outs": outs, "S": S}, configs, recs, gen_s)
                stats_list.append(
                    {"pg_loss": float(ys["pg_loss"][i]),
                     "mean_return": float(ys["mean_return"][i]),
                     "episodes": N * passes, "steps": N * passes * S})
        env.configs = configs
        env.invalidate()
        return stats_list, recs

    def _epoch_summary(self, ys_segs, counts, idx0, config_idx_f,
                       N, S, passes):
        """Host pass for ``records="summary"|"off"``: fold the per-update
        scalars into ``ChaosCounters``, replay the device-side (lever, bin)
        count tensor into the adaptive oracle in ONE pass, and rebuild
        ``env.configs`` from the final integerised indices (levers still at
        their initial index keep their original dict value).

        The count tensor compresses away the assignment ORDER the §2.4.1
        streak rules watch, so the replay reconstructs the maximum-entropy
        order consistent with the counts: each bin's occurrences spread
        evenly across the epoch. A same-bin streak then survives only when
        one bin truly dominated the epoch's choices — a sorted
        ``np.repeat`` replay would instead fabricate a run per bin and
        fire spurious splits (halving ``_hits`` each time)."""
        cfgr, env, table = self.cfgr, self.env, self._table
        stats_list: list = []
        for k_seg, ys in ys_segs:
            ys = {k2: _np(v) for k2, v in ys.items()}
            self.chaos.windows += k_seg * passes * N * S
            self.chaos.reward_sum += float(ys["reward_sum"].sum())
            self.chaos.p99_max_ms = max(self.chaos.p99_max_ms,
                                        float(ys["p99_max"].max()))
            if "breach_windows" in ys:
                self.chaos.breached_windows += int(
                    ys["breach_windows"].sum())
            if "breach_frac_sum" in ys:
                self.chaos.breach_frac_sum += float(
                    ys["breach_frac_sum"].sum())
            if "shield_clamped" in ys:
                self.shield.clamped_actions += int(
                    ys["shield_clamped"].sum())
                self.shield.fallbacks += int(ys["shield_fallbacks"].sum())
                self.shield.budget_exhaustions += int(
                    ys["budget_exhaustions"].sum())
            for i in range(k_seg):
                st = {"pg_loss": float(ys["pg_loss"][i]),
                      "mean_return": float(ys["mean_return"][i]),
                      "episodes": N * passes, "steps": N * passes * S}
                if "reward_mean" in ys:
                    st["reward_mean"] = float(ys["reward_mean"][i].mean())
                    st["p99_mean_ms"] = float(ys["p99_mean"][i].mean())
                    st["p99_ms"] = float(ys["p99_last"][i][-1])
                stats_list.append(st)
        # ---- one-pass §2.4.1 replay from the device count tensor ----
        bins = cfgr.disc.bins
        counts_np = _np(counts)
        names = table.names
        for li in np.nonzero(counts_np.any(axis=1))[0]:
            dyn = bins.get(names[li])
            if dyn is not None:
                c = counts_np[li]
                reps = np.repeat(np.arange(c.size), c)
                pos = np.concatenate([(np.arange(ci) + 0.5) / ci
                                      for ci in c if ci])
                dyn.record_many(reps[np.argsort(pos, kind="stable")])
        # ---- final configs from the integerised indices ----
        idx_f = _np(config_idx_f)
        configs = [dict(c) for c in self._epoch_configs]
        val_cache: dict = {}
        for ci, li in zip(*np.nonzero(idx_f != idx0)):
            kv = (int(li), int(idx_f[ci, li]))
            val = val_cache.get(kv)
            if val is None:
                val = val_cache[kv] = table.value_of(*kv)
            configs[ci][names[li]] = val
        env.configs = configs
        env.invalidate()
        return stats_list

    def run_async(self, *, explore: bool = True, greedy: bool = False):
        """Enqueue one fused episode batch (its captured program) and return
        its device-resident (N, S) batch. Consecutive calls before
        ``finalize`` chain on the carry buffers; ``finalize`` adopts the
        final state and materialises every pending batch's host
        bookkeeping."""
        cfgr = self.cfgr
        if self._carry is None:
            self._load_fresh()
            self._epoch_t0 = time.perf_counter()
        exploit = cfgr.agent.exploit_ready(explore=explore)
        greedy = bool(greedy or not explore)
        skey = self._skey(exploit, greedy)
        prog = self._program(
            ("episode", skey),
            lambda draws: self._chained_episode(draws, skey))
        # the outputs live in the program's memory: the next replay (a
        # chained pass, a pipelined group) overwrites them
        outs = {k: v.clone() for k, v in prog().items()}
        self._inflight.append({"outs": outs, "S": cfgr.steps_per_episode})
        return {"states": outs["states"], "actions": outs["actions"],
                "rewards": outs["rewards"]}

    def _load_fresh(self) -> None:
        """Fill the carry buffers for the first batch of an epoch: the
        fresh inputs, the deploy ring (the pre-episode config at every depth
        when none survives) and the shield carry."""
        carry = self._fresh_inputs()
        if self._R_max:
            hist = self._hist      # survives while the configs do
            if hist is None:
                hist = carry[0][None].expand(self._R_max + 1, -1, -1)
            carry = carry + (hist,)
        if self.cfgr.shield is not None:
            carry = carry + tuple(self._shield)
        if self._bufs is None or [(b.shape, b.dtype) for b in self._bufs] \
                != [(x.shape, x.dtype) for x in carry]:
            # new addresses: the programs that read the old ones go too
            self._bufs = tuple(x.clone(memory_format=torch.contiguous_format)
                               for x in carry)
            self._programs.clear()
        else:
            for buf, x in zip(self._bufs, carry):
                buf.copy_(x)
        if self.cfgr.shield is not None:
            # pre-batch indices: a fallback reverts whole rows to LKG, so
            # finalize re-syncs the configs from index differences
            self._idx0 = self._bufs[0].cpu().numpy()
        self._carry = self._bufs

    def _fresh_inputs(self) -> tuple:
        """Host-side packing for the first batch of an epoch: re-pack the
        integerised lever table from the (possibly adapted) oracle into the
        table tensors, pack the workload table, borrow the engine's
        queueing state."""
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
            # padded up the bin ladder, so a split inside a rung re-packs
            # into the same tensors (and the same captured programs)
            B_pad = max(_bucket(table.max_bins, _BIN_BUCKETS), self._hw_B)
            if B_pad != self._hw_B:
                self._programs.clear()   # a new rung: new table shapes
            self._hw_B = B_pad
            packed_tabs = build_packed_tables(table, pad_to=B_pad)
            self._cc_pairs = tuple((k, li) for k, li, _ in packed_tabs)
            # a split inside the rung re-packs into the same tensors, which
            # the captured programs read at their addresses
            old = self._tabs or {}
            self._tabs = {k: _into(old.get(k), torch.as_tensor(tab, **f32))
                          for k, li, tab in packed_tabs}
            self._kind_code = _into(self._kind_code, torch.as_tensor(
                table.kind_code, **i64))
            self._n_valid = _into(self._n_valid, torch.as_tensor(
                table.n_valid, **i64))
            self._reboot_f = _into(self._reboot_f, torch.as_tensor(
                [1.0 if s.reboot else 0.0 for s in table.specs], **f32))
            self._rejit_f = _into(self._rejit_f, torch.as_tensor(
                [1.0 if s.group in ("kernel", "memory", "parallel") else 0.0
                 for s in table.specs], **f32))
            self._ranked = _into(self._ranked, torch.as_tensor(
                [table.index_of[n] for n in cfgr.levers], **i64))
        table = self._table
        if self._wl_dev is None:
            tbl = pack_device_workloads(env.workloads)
            self._wl_dev = {k: torch.as_tensor(v, device=device)
                            for k, v in tbl.asdict().items()}
            # §12 fault table: tick effects ride the window step; deploy
            # lags drive the config-index ring
            ftab = getattr(env, "_faults", None)
            self._R_max = 0 if ftab is None else int(ftab.max_deploy_delay())
            self.chaos.fault_events = (0 if ftab is None
                                       else int((ftab.kind != 0).sum()))
            if ftab is not None and ftab.has_tick_effects():
                self._ft_dev = {k: torch.as_tensor(v, device=device)
                                for k, v in ftab.asdict().items()}
            if self._R_max:
                self._delays = torch.as_tensor(
                    np.clip(ftab.deploy_delays(), 0, self._R_max), **i64)
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
            self._hist = None     # a stale config ring cannot be replayed
            self._shield = None   # LKG indices refer to the old ladder
        self._bins_sig = sig
        sh_spec = cfgr.shield
        if sh_spec is not None and self._shield is None:
            # fresh shield: LKG = the current (pre-exploration) config, the
            # initial trust radius, a clean streak and risk
            n = config_idx.shape[0]
            self._shield = (config_idx.clone(),
                            torch.full((n,), sh_spec.trust_radius, **i64),
                            torch.zeros((n,), **i64),
                            torch.zeros((n,), **f32))

        self._sel_cols = tuple(env.metric_names.index(m)
                               for m in cfgr.hspec.metric_names)
        blk = self._block
        lo, n = (0, env.n_clusters) if blk is None else (blk.lo, blk.n)
        self._inputs = {"wl": _take(self._wl_dev, "wl", lo, n),
                        "mc": _take(dev._mc_dev, "mc", lo, n),
                        "ft": _take(self._ft_dev, "ft", lo, n),
                        "delays": _take(self._delays, "delays", lo, n)}
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
        config_idx_f = self._adopt(carry)

        configs = self._epoch_configs
        records: list = []
        gen_s = self.last_wall_s / max(total_steps, 1)
        for entry in inflight:
            configs = self._materialise(entry, configs, records, gen_s)
        env.configs = configs
        env.invalidate()
        if cfgr.shield is not None:
            N = env.n_clusters
            touched = np.zeros((N, self._table.n_levers), bool)
            rows = np.arange(N)[:, None]
            for entry in inflight:
                touched[rows, entry["outs"]["lever"].cpu().numpy()] = True
            self._sync_configs(self._idx0, config_idx_f.cpu().numpy(),
                               touched)
        return records

    def _adopt(self, carry: tuple):
        """Hand a finished epoch's final state (the carry buffers) back: the
        queueing state to the engine (as copies: the buffers are the next
        batch's), the host mirrors to the env and the encoder, the carried
        leaves to the runner. Returns the final config indices."""
        cfgr, env = self.cfgr, self.env
        (config_idx_f, backlog_f, sfree_f, clock_f, last_service_f,
         reconfigs_f, lo_f, hi_f, per_node_f) = carry[:9]
        pos = 9
        self._hist = None
        if self._R_max:
            self._hist = carry[9]
            pos = 10
        if cfgr.shield is not None:
            self._shield = tuple(carry[pos:pos + 4])
            self.shield.trust_radius = float(
                self._shield[1].cpu().numpy().mean())
        env._dev.adopt_loop_state(backlog_f.clone(), sfree_f.clone(),
                                  clock_f)
        self._sync_stream()
        env.reconfigs[:] = reconfigs_f.cpu().numpy().astype(np.int64)
        env.last_service[:] = last_service_f.cpu().numpy().astype(np.float64)
        rng_range = cfgr.encoder._range
        rng_range.lo = lo_f.cpu().numpy().astype(np.float64)
        rng_range.hi = hi_f.cpu().numpy().astype(np.float64)
        self._per_node = per_node_f
        self._config_idx = config_idx_f
        self._clock_mark = env.clock.copy()
        return config_idx_f

    def _sync_stream(self) -> None:
        """On a fleet mesh: copy rank 0's engine draw stream to every rank.
        Only shard 0 drew from it in the episodes (the other ranks drew
        from their shards' streams), and the engine's later windows must
        draw the same numbers on every rank. A source without a generator
        state (a test's replay of the reference's key stream) advances
        the same on every rank already."""
        draws = self.env._dev.draws
        if self._block is None or not hasattr(draws, "get_state"):
            return
        dev = self.device if self._block.backend == "nccl" else "cpu"
        draws.set_state(shd.broadcast_state(draws.get_state(),
                                            self._block.group, dev))

    def _sync_configs(self, idx0: np.ndarray, idx_f: np.ndarray,
                      touched: np.ndarray) -> None:
        """Exact final config dicts under the shield: a fallback step
        reverts a cluster's WHOLE row to LKG, which the per-lever
        ``StepRecord`` stream cannot express. The device index array is
        authoritative: rebuild ``env.configs`` from its difference to the
        pre-batch indices. ``touched`` (N, L bool) marks levers the batch's
        actions visited; they are decoded again even when they returned to
        their first bin, as the record path decodes every visited bin (so a
        neutral shield replays the shield-off configs bit for bit)."""
        table = self._table
        names = table.names
        configs = [dict(c) for c in self._epoch_configs]
        stale = (idx_f != idx0) | touched
        val_cache: dict = {}
        for ci, li in zip(*np.nonzero(stale)):
            kv = (int(li), int(idx_f[ci, li]))
            val = val_cache.get(kv)
            if val is None:
                val = val_cache[kv] = table.value_of(*kv)
            configs[ci][names[li]] = val
        self.env.configs = configs
        self.env.invalidate()

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
        if "shield_fallback" in outs:
            self.shield.clamped_actions += int(outs["shield_clamped"].sum())
            self.shield.fallbacks += int(outs["shield_fallback"].sum())
            # one exhaustion per (cluster, episode) whose budget ran dry
            self.shield.budget_exhaustions += int(
                outs["budget_out"].any(axis=1).sum())
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
