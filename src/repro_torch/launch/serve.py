"""Continuous-tuning service launcher (DESIGN.md §13) on PyTorch, on the
card unless told otherwise.

The always-on twin of ``launch/tune.py``: instead of one optimisation run
that exits, this stands up the shadow/canary/live control plane and loops —
each cycle trains the policy on the shadow fleet (the captured episode
batch and update, replayed every cycle, never recaptured),
canary-evaluates the best candidate against the incumbent, and only a
K-consecutive-wins margin victory promotes it to the live fleet. SLO
breaches during canary roll back immediately. Every promotion checkpoints
the full control-plane state, so

    PYTHONPATH=src python -m repro_torch.launch.serve --cycles 20 --reward slo

can be killed at any point and resumed with ``--resume`` bit-for-bit.

    # 3-cycle smoke: preset metrics/levers, no offline collect phase
    PYTHONPATH=src python -m repro_torch.launch.serve --cycles 3 --quick

    # off the card: the kernels' plain versions on the CPU
    PYTHONPATH=src python -m repro_torch.launch.serve --cycles 2 --quick \\
        --fleet 3 --device cpu --out /tmp/serve

    # the shadow fleet's cluster axis sharded over 2 ranks (DESIGN.md §11)
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.serve \
        --cycles 2 --quick --fleet 4 --device cpu --out /tmp/serve2

Writes ``metrics.prom`` (Prometheus text exposition), ``history.jsonl``
(the episode store) and ``ck/step_*`` checkpoints under ``--out``; the
metrics dump is flushed through ``flush_guard`` even on Ctrl-C/SIGTERM.
Under ``torchrun`` (``WORLD_SIZE`` > 1) every rank runs the controller,
the shadow fleet's episodes sharded over the ranks, and only rank 0 writes.
"""
from __future__ import annotations

import argparse
import contextlib
import json
from pathlib import Path

#: --quick presets: the §2.2/§2.3 analysis outputs the serve tests pin,
#: skipping the offline collect phase entirely (CI smoke, local hacking)
QUICK_METRICS = ["latency_p99_ms", "latency_mean_ms", "queue_depth",
                 "device_util", "sched_queue_depth"]
QUICK_LEVERS = ["max_batch_events", "prefetch_depth", "driver_memory_gb",
                "sink_partitions", "backup_tasks"]


def switching_fleet(n: int):
    """The serve-path workload roster: N diurnal ``SwitchingWorkload``s with
    staggered periods (the §12 time-varying fleet the acceptance run uses)."""
    from repro_torch.data.workloads import PoissonWorkload, SwitchingWorkload

    return [SwitchingWorkload(PoissonWorkload(6_000, 0.5),
                              PoissonWorkload(12_000, 0.5),
                              period_s=700.0 + 60.0 * i) for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cycles", type=int, default=20)
    ap.add_argument("--quick", action="store_true",
                    help="skip the offline collect+analyse phase and use the "
                         "preset metric/lever selection (CI smoke)")
    ap.add_argument("--fleet", type=int, default=4,
                    help="shadow fleet size (one training episode per "
                         "cluster per pass)")
    ap.add_argument("--backend", choices=["torch"], default="torch",
                    help="fleet tick engine: the torch engine on the "
                         "fleet_tick kernel (the port has no other)")
    ap.add_argument("--window-impl", choices=["kernel", "scan", "auto"],
                    default="scan",
                    help="the fleets' observation window: 'scan' (the "
                         "default, as the reference's --backend jax) runs "
                         "the lean lane-free fleet_scan kernel, 'kernel' the "
                         "fleet_tick kernel with its latency lanes (its "
                         "--backend pallas), 'auto' the faster of the two "
                         "by a timed probe")
    ap.add_argument("--device", default=None,
                    help="torch device of the fleets and the policy "
                         "(default: the CUDA card; 'cpu' runs the kernels' "
                         "plain versions)")
    ap.add_argument("--device-loop", choices=["auto", "on", "off"],
                    default="auto")
    ap.add_argument("--reward", choices=["neg_mean", "neg_p99", "slo"],
                    default="slo")
    ap.add_argument("--slo-ms", type=float, default=12000.0,
                    help="latency SLO (ms); the default switching fleet "
                         "idles around p99 ≈ 10 s, so 12 s breaches on real "
                         "regressions, not at rest")
    ap.add_argument("--window", type=float, default=240.0)
    ap.add_argument("--steps-per-episode", type=int, default=2)
    ap.add_argument("--k-promote", type=int, default=2,
                    help="consecutive canary wins required to promote")
    ap.add_argument("--margin", type=float, default=0.02,
                    help="relative reward margin a challenger must clear")
    ap.add_argument("--canary-pairs", type=int, default=2,
                    help="matched challenger/incumbent replica pairs")
    ap.add_argument("--live", type=int, default=2, help="live fleet size")
    ap.add_argument("--safe", action="store_true",
                    help="safe exploration (DESIGN.md §16): the shadow "
                         "fleet trains under the trust-region shield; a "
                         "breach-budget exhaustion demotes the queued "
                         "challenger immediately")
    ap.add_argument("--trust-radius", type=int, default=2,
                    help="--safe: initial ±bin trust radius around the "
                         "last-known-good config")
    ap.add_argument("--breach-budget", type=int, default=4,
                    help="--safe: per-episode SLO-breach budget per shadow "
                         "cluster")
    ap.add_argument("--collect", type=int, default=400,
                    help="offline collect windows (ignored with --quick)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="experiments/serve")
    ap.add_argument("--resume", action="store_true",
                    help="restore the latest checkpoint under --out/ck and "
                         "continue mid-tuning")
    args = ap.parse_args(argv)

    from repro_torch.distribution.sharding import init_from_env, is_writer
    from repro_torch.monitoring import flush_guard
    from repro_torch.serve import ServeController

    args.device = init_from_env(args.device)
    writer = is_writer()
    out = Path(args.out)
    if writer:
        out.mkdir(parents=True, exist_ok=True)
    workloads = switching_fleet(args.fleet)

    kw = dict(backend=args.backend, window_impl=args.window_impl,
              seed=args.seed, window_s=args.window,
              steps_per_episode=args.steps_per_episode,
              reward_mode=args.reward, slo_ms=args.slo_ms,
              k_promote=args.k_promote, margin=args.margin,
              canary_pairs=args.canary_pairs, n_live=args.live,
              device_loop=args.device_loop, checkpoint_dir=out / "ck",
              safe=args.safe, trust_radius=args.trust_radius,
              breach_budget=args.breach_budget,
              history_path=out / "history.jsonl", device=args.device)
    if args.quick:
        ctl = ServeController(workloads, metrics=QUICK_METRICS,
                              levers=QUICK_LEVERS, **kw)
    else:
        from repro_torch.core import AutoTuner
        from repro_torch.engine import FleetEnv

        probe = FleetEnv(workloads, seed=args.seed, backend=args.backend,
                         device=args.device, window_impl=args.window_impl)
        tuner = AutoTuner(probe, seed=args.seed, window_s=args.window)
        print(f"[collect] {args.collect} windows …")
        tuner.collect(args.collect)
        mets, levs = tuner.analyse()
        print(f"[analyse] metrics: {mets}\n[analyse] levers: {levs}")
        ctl = tuner.build_serve_controller(workloads, **kw)

    if args.resume and ctl.store.latest_step() is not None:
        step = ctl.restore()
        print(f"[resume] restored checkpoint step {step} "
              f"(cycle {ctl.cycle}, incumbent {ctl.incumbent})")

    reason = ctl.cfgr.device_loop_reason()
    mesh = ctl.cfgr._device_runner().mesh if reason is None else None
    print(f"[serve] fleets on {ctl.device}, window "
          f"{ctl.shadow_env.window_impl}; fused device loop (§10): "
          + ("ACTIVE" if reason is None else f"off — {reason}")
          + (f", cluster axis sharded over {mesh.size()} devices (§11)"
             if mesh is not None else ""))
    if args.safe:
        print(f"[serve] safe exploration (§16): shield ACTIVE — trust "
              f"radius ±{args.trust_radius} bins, breach budget "
              f"{args.breach_budget}/episode")

    def metrics_text():
        text = ctl.counters.prometheus_text()
        if args.safe:
            text += ctl.cfgr.shield_counters.prometheus_text()
        return text

    def cb(s):
        print(f"[cycle {s['cycle']:>3}] {s['decision']:<8} "
              f"live reward {s['live_reward']:+.3f} "
              f"p99 {s['live_p99_ms']:.0f} ms "
              f"promotions {ctl.counters.promotions} "
              f"rollbacks {ctl.counters.rollbacks}")

    # SIGTERM/Ctrl-C unwind through the guard: the final metrics dump is
    # always written (the same guard launch/tune.py uses)
    guard = (flush_guard(out / "metrics.prom", metrics_text) if writer
             else contextlib.nullcontext())
    try:
        with guard:
            ctl.run(args.cycles, callback=cb)
    except KeyboardInterrupt:
        print(f"[interrupted] final metrics dump at {out}/metrics.prom")
    finally:
        ctl.checkpoint()  # resumable even when no promotion fired

    c = ctl.counters
    print(f"[done] cycles {c.cycles}  promotions {c.promotions}  "
          f"rollbacks {c.rollbacks}  breach_rate {c.breach_rate:.2%}  "
          f"incumbent {json.dumps(ctl.incumbent)}")
    if writer:
        print(f"[done] wrote {out}/metrics.prom, {out}/history.jsonl, "
              f"{out}/ck/")


if __name__ == "__main__":
    main()
