"""Auto-tuning launcher on PyTorch: the paper's full pipeline (collect ->
analyse -> tune) on the simulated cluster, on the card unless told
otherwise.

    PYTHONPATH=src python -m repro_torch.launch.tune --collect 1200 \
        --updates 8 --f 0.8 --out experiments/tune

    # fleet-parallel offline phase + N-parallel REINFORCE episodes
    PYTHONPATH=src python -m repro_torch.launch.tune --fleet 16 \
        --fleet-mix --collect 1200 --updates 8 --out experiments/tune_fleet

    # off the card: the kernels' plain versions on the CPU
    PYTHONPATH=src python -m repro_torch.launch.tune --device cpu --fleet 4 \
        --collect 80 --updates 1 --steps-per-episode 2 --out /tmp/t

    # safe exploration (the shield, DESIGN.md §16) under the SLO reward
    PYTHONPATH=src python -m repro_torch.launch.tune --fleet 16 \
        --reward slo --slo-ms 12000 --safe --out experiments/tune_safe

    # the real StreamEngine on wall-clock windows (LocalEngine)
    PYTHONPATH=src python -m repro_torch.launch.tune --env local \
        --collect 24 --updates 2 --window 2 --out experiments/tune_local

    # the cluster axis sharded over 2 ranks (DESIGN.md §11): gloo on the
    # CPU, or NCCL with a card a rank (drop --device cpu)
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.tune \
        --device cpu --fleet 4 --collect 80 --updates 1 \
        --steps-per-episode 2 --out /tmp/t2

``--fleet 1`` (or less) runs the serial ``SimCluster``. Prints the
Fig-5-style latency trajectory and writes ``analysis.json``,
``history.json`` and ``metrics.prom`` (the fused loop's ``ChaosCounters``,
plus the ``ShieldCounters`` under ``--safe``). Under ``torchrun``
(``WORLD_SIZE`` > 1) every rank runs the whole pipeline on the whole
fleet, the fused loop's episodes sharded over the ranks, and only rank 0
writes the files.
"""
from __future__ import annotations

import argparse
import contextlib
import json
from pathlib import Path

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--env", choices=["sim", "local"], default="sim",
                    help="'sim' tunes the simulated cluster; 'local' the "
                         "real StreamEngine (LocalEngine) on wall-clock "
                         "windows of at most 6 s")
    ap.add_argument("--arch", default="smollm_135m",
                    help="--env local: the model the StreamEngine serves "
                         "(its reduced config)")
    ap.add_argument("--workload", default="poisson_low")
    ap.add_argument("--fleet", type=int, default=1,
                    help="simulate N clusters in one batched FleetEnv "
                         "(the paper's ~80-cluster sweep); 1 or less runs "
                         "the serial SimCluster")
    ap.add_argument("--fleet-mix", action="store_true",
                    help="heterogeneous fleet over the FLEET_MIX workload "
                         "roster instead of N copies of --workload")
    ap.add_argument("--backend", choices=["torch"], default="torch",
                    help="fleet tick engine: the torch engine on the "
                         "fleet_tick kernel (the port has no other)")
    ap.add_argument("--window-impl", choices=["kernel", "scan", "auto"],
                    default="kernel",
                    help="a fleet's observation window: 'kernel' runs the "
                         "fleet_tick kernel with its latency lanes (the "
                         "reference's --backend pallas), 'scan' the lean "
                         "lane-free fleet_scan kernel (its --backend jax), "
                         "'auto' the faster of the two by a timed probe")
    ap.add_argument("--device", default=None,
                    help="torch device of the simulation (or of --env "
                         "local's model), the k-means, the Lasso and the "
                         "policy (default: the CUDA card; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--device-loop", choices=["auto", "on", "off"],
                    default="auto",
                    help="fused Algorithm-1 training loop over a fleet: "
                         "'auto' uses it whenever the env supports it "
                         "(device-packable workloads) and logs the reason "
                         "once when not; 'on' fails with that reason; 'off' "
                         "runs the per-step host loop")
    ap.add_argument("--reward", choices=["neg_mean", "neg_p99", "neg_inv",
                                         "slo"],
                    default="neg_mean",
                    help="episode reward shaping: 'slo' adds a hinge penalty "
                         "on p99 over --slo-ms plus a breach-duration term")
    ap.add_argument("--slo-ms", type=float, default=1000.0,
                    help="latency SLO for --reward slo (ms)")
    ap.add_argument("--safe", action="store_true",
                    help="safe exploration (DESIGN.md §16): trust-region "
                         "shield over the lever lattice + breach-risk "
                         "fallback to last-known-good configs (needs "
                         "--reward slo)")
    ap.add_argument("--trust-radius", type=int, default=2,
                    help="--safe: initial ±bin trust radius around the "
                         "last-known-good config")
    ap.add_argument("--breach-budget", type=int, default=4,
                    help="--safe: per-episode SLO-breach budget per cluster; "
                         "exhaustion pins the cluster to last-known-good "
                         "for the rest of the episode")
    ap.add_argument("--collect", type=int, default=1200)
    ap.add_argument("--updates", type=int, default=8)
    ap.add_argument("--steps-per-episode", type=int, default=5)
    ap.add_argument("--episodes", type=int, default=4)
    ap.add_argument("--f", type=float, default=0.8)
    ap.add_argument("--window", type=float, default=240.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="experiments/tune")
    args = ap.parse_args(argv)

    if args.safe and args.reward != "slo":
        # before the collect budget is spent
        raise SystemExit("--safe needs --reward slo (the shield's breach "
                         "signal is the in-trace window breach fraction)")

    from repro_torch.core import AutoTuner
    from repro_torch.data.workloads import fleet_workloads, get_workload
    from repro_torch.distribution.sharding import init_from_env, is_writer
    from repro_torch.engine import FleetEnv, LocalEngine, SimCluster

    args.device = init_from_env(args.device)
    writer = is_writer()

    fleet = args.env == "sim" and args.fleet > 1
    window = args.window
    if fleet:
        wls = (fleet_workloads(args.fleet, seed=args.seed) if args.fleet_mix
               else [get_workload(args.workload) for _ in range(args.fleet)])
        env = FleetEnv(wls, seed=args.seed, backend=args.backend,
                       device=args.device, window_impl=args.window_impl)
        print(f"[fleet] {args.fleet} clusters "
              f"({'mixed roster' if args.fleet_mix else args.workload}, "
              f"{args.backend} engine, {env.window_impl} window on "
              f"{env.device})")
    elif args.env == "sim":
        env = SimCluster(get_workload(args.workload), seed=args.seed,
                         device=args.device)
    else:
        env = LocalEngine(get_workload(args.workload), seed=args.seed,
                          arch=args.arch, device=args.device)
        window = min(args.window, 6.0)  # real seconds

    if args.device_loop == "on":
        # env-level gates are checkable now: fail before the collect
        # budget is spent (the reward-mode gate is re-checked below)
        from repro_torch.core.device_loop import env_device_reason

        env_reason = env_device_reason(env)
        if env_reason is not None:
            raise SystemExit(f"--device-loop=on but the fused device loop "
                             f"cannot run: {env_reason}")
    tuner = AutoTuner(env, seed=args.seed, window_s=window)
    print(f"[collect] {args.collect} windows …")
    tuner.collect(args.collect)
    mets, levs = tuner.analyse()
    print(f"[analyse] metrics k={tuner.selection.k} "
          f"(reduction {tuner.selection.reduction:.0%}): {mets}")
    print(f"[analyse] ranked levers: {levs}")

    env.reset()
    if fleet:
        # fleet-mean baseline: under --fleet-mix the clusters carry different
        # workloads, so comparing the cross-fleet best against any single
        # cluster's default would misstate the gain
        base_p99 = float(np.mean([w.p99_ms for w in env.observe(window)]))
        steps_per_update = args.steps_per_episode * max(env.n_clusters,
                                                        args.episodes)
    else:
        base_p99 = env.observe(window).p99_ms
        steps_per_update = args.steps_per_episode * args.episodes
    print(f"[tune] default p99 = {base_p99:.0f} ms")
    cfgr = tuner.build_configurator(
        steps_per_episode=args.steps_per_episode,
        episodes_per_update=args.episodes, window_s=window, f_exploit=args.f,
        device_loop=args.device_loop, reward_mode=args.reward,
        slo_ms=args.slo_ms, safe=args.safe,
        shield_kw=(dict(trust_radius=args.trust_radius,
                        breach_budget=args.breach_budget)
                   if args.safe else None))
    if args.safe:
        print(f"[tune] safe exploration (§16): shield ACTIVE — trust radius "
              f"±{args.trust_radius} bins, breach budget "
              f"{args.breach_budget}/episode")
    reason = cfgr.device_loop_reason()
    if args.device_loop == "on" and reason is not None:
        # fail before the tuning loop starts: a host-loop run here would
        # spend the whole --updates budget at per-step host speed
        raise SystemExit(f"--device-loop=on but the fused device loop "
                         f"cannot run: {reason}")
    if args.device_loop == "auto" and reason is not None:
        print(f"[tune] fused device loop (§10): off — {reason} "
              "(per-step host loop)")
    if fleet and reason is None:
        mesh = cfgr._device_runner().mesh
        print("[tune] fused device loop (§10): ACTIVE — one fused episode "
              "batch + one update per outer iteration"
              + (f", cluster axis sharded over {mesh.size()} devices (§11)"
                 if mesh is not None else ""))

    def cb(i, stats, history):
        last = history[-steps_per_update:]
        print(f"[tune] update {i}: p99 mean {np.mean([r.p99_ms for r in last]):.0f} "
              f"min {np.min([r.p99_ms for r in last]):.0f} ms  "
              f"return {stats['mean_return']:.2f}")

    from repro_torch.monitoring import ChaosCounters, flush_guard

    out = Path(args.out)
    if writer:
        out.mkdir(parents=True, exist_ok=True)

    def metrics_text():
        runner = cfgr._runner
        chaos = runner.chaos if runner is not None else ChaosCounters()
        text = chaos.prometheus_text()
        if args.safe:
            text += cfgr.shield_counters.prometheus_text()
        return text

    # the guard remaps SIGTERM to KeyboardInterrupt and writes the dump in
    # its finally: a Ctrl-C'd or killed tune run leaves a metrics.prom
    interrupted = False
    guard = (flush_guard(out / "metrics.prom", metrics_text) if writer
             else contextlib.nullcontext())
    try:
        with guard:
            cfgr.tune(args.updates, callback=cb)
    except KeyboardInterrupt:
        interrupted = True
        print(f"[interrupted] final metrics dump at {out}/metrics.prom")
    if interrupted and not cfgr.history:
        return
    best = min(cfgr.history, key=lambda r: r.p99_ms)
    print(f"[done] best p99 {best.p99_ms:.0f} ms "
          f"({100 * (1 - best.p99_ms / base_p99):.0f}% below default)")
    if not writer:
        return

    tuner.save_analysis(out / "analysis.json")
    hist = [
        dict(lever=r.lever, direction=r.direction, reward=r.reward,
             p99_ms=r.p99_ms, clock_s=r.clock_s, phases=r.phases)
        for r in cfgr.history
    ]
    (out / "history.json").write_text(json.dumps(
        {"default_p99_ms": base_p99, "best_p99_ms": best.p99_ms,
         "best_config": best.config, "history": hist}, indent=2))
    print(f"[done] wrote {out}/analysis.json and {out}/history.json")


if __name__ == "__main__":
    main()
