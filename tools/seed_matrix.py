"""Seed sweeps of the port against the reference, on the CPU: the
statistical checks that one seed cannot settle.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/seed_matrix.py megascan \\
        --seeds 0-31
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/seed_matrix.py serve \\
        --seeds 0-7 --side ref
    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/seed_matrix.py serve \\
        --seeds 0-31 --side port --window-impl scan

``megascan``: the exploring K=4 "full" epoch mega-scan on the 24-cluster
stable fleet of tests/test_torch_slice.py (3 steps, 240 s windows, frozen
bins; fleet seeds ``seed * 1000 + i``), each package on its own initial
weights and draws. Prints, per update, the seed medians of the window
reward's trimmed mean and of the records' median, the share of moves of
``max_batch_events`` down and up, then the pooled streams against
``tests/chaos_harness.py``'s ``assert_loop_equivalent`` and a Mann-Whitney
test of the per-seed trimmed means of updates 3 and 4 (scipy, if present).

``serve``: per seed, the cycle of the first promotion of the saturated
degraded incumbent within 8 cycles, and the promotions and rollbacks of
the 20-cycle switching acceptance run (tests/test_serve.py's
configurations, 3 shadow clusters). ``--side`` picks the package(s);
``--window-impl`` the port controllers' window (``kernel``, what the
tests' pins name, or ``scan``, the controller's default and the twin of
the reference's jax backend).

The reference's megascan runs its pallas backend on the compiled CPU tier
(as tests/test_torch_epoch.py does), its serve controllers the jax backend
(as tests/test_serve.py does); the port runs on the CPU with one thread.
``--json PATH`` also writes the raw streams.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tests"))
sys.path.insert(0, str(ROOT / "src"))

METRICS = ["latency_p99_ms", "latency_mean_ms", "queue_depth", "device_util",
           "sched_queue_depth"]
LEVERS = ["max_batch_events", "prefetch_depth", "driver_memory_gb",
          "sink_partitions", "backup_tasks"]
FROZEN = dict(split_after=10**9, extend_after=10**9, merge_after=10**9)
N, STEPS, K = 24, 3, 4


def _seeds(spec: str) -> list[int]:
    out = []
    for part in spec.split(","):
        lo, _, hi = part.partition("-")
        out += list(range(int(lo), int(hi or lo) + 1))
    return out


def _fleet(P, S):
    return [P(10_000, 0.5) if i % 2 == 0 else
            S(P(6_000, 0.5), P(12_000, 0.5), period_s=700.0 + 60.0 * i)
            for i in range(N)]


def _megascan(side: str, seed: int) -> dict:
    kw = dict(seed=seed, steps_per_episode=STEPS, window_s=240.0,
              device_loop="on", bin_kw=FROZEN)
    seeds = [seed * 1000 + i for i in range(N)]
    if side == "ref":
        from repro.core.configurator import Configurator
        from repro.data.workloads import PoissonWorkload, SwitchingWorkload
        from repro.engine import FleetEnv
        env = FleetEnv(_fleet(PoissonWorkload, SwitchingWorkload),
                       seeds=seeds, backend="pallas")
        cfgr = Configurator(env, METRICS, LEVERS, mesh="off", **kw)
    else:
        from repro_torch.core import Configurator
        from repro_torch.data.workloads import (PoissonWorkload,
                                                SwitchingWorkload)
        from repro_torch.engine import FleetEnv
        env = FleetEnv(_fleet(PoissonWorkload, SwitchingWorkload),
                       seeds=seeds, backend="torch", device="cpu")
        cfgr = Configurator(env, METRICS, LEVERS, **kw)
    cfgr.tune_megascan(K, k=K, records="full")
    h = cfgr.history
    return {"reward": [r.reward for r in h], "p99": [r.p99_ms for r in h],
            "lever": [r.lever for r in h], "dir": [r.direction for r in h]}


def _megascan_report(runs: dict, seeds: list[int]) -> None:
    from chaos_harness import assert_loop_equivalent, rel, trim_mean

    per = N * STEPS
    upd = [slice(k * per, (k + 1) * per) for k in range(K)]

    def per_seed(d):
        r, lv, dr = (np.asarray(d[k]) for k in ("reward", "lever", "dir"))
        mbe = lv == "max_batch_events"
        return {"tm": [trim_mean(r[u]) for u in upd],
                "med": [float(np.median(r[u])) for u in upd],
                "down": [float((mbe & (dr == -1))[u].mean()) for u in upd],
                "up": [float((mbe & (dr == 1))[u].mean()) for u in upd]}

    st = {side: [per_seed(runs[side][s]) for s in seeds] for side in runs}
    for k in range(K):
        line = [f"update {k + 1}:"]
        for name in ("tm", "med", "down", "up"):
            agg = np.median if name in ("tm", "med") else np.mean
            line.append(name + " " + " / ".join(
                f"{side} {agg([x[name][k] for x in st[side]]):.4f}"
                for side in st))
        print("  ".join(line))
    if set(runs) != {"ref", "port"}:
        return
    for k in (2, 3):
        print(f"update {k + 1} trimmed means by seed:")
        for side in ("ref", "port"):
            tm = [x["tm"][k] for x in st[side]]
            print(f"  {side:4s} " + " ".join(f"{t:.1f}" for t in tm)
                  + "; quartiles " + " / ".join(
                      f"{q:.2f}" for q in np.percentile(tm, [25, 50, 75])))
    pooled = {side: [np.concatenate([runs[side][s][key] for s in seeds])
                     for key in ("reward", "p99")] for side in runs}
    (rr, pr), (rp, pp) = pooled["ref"], pooled["port"]
    ret = [np.median(x.reshape(-1, STEPS).sum(1)) for x in (rp, rr)]
    print(f"pooled over {len(seeds)} seeds, port vs ref relative: median "
          f"reward {rel(np.median(rp), np.median(rr)):.6f}, median p99 "
          f"{rel(np.median(pp), np.median(pr)):.6f}, trimmed-mean reward "
          f"{rel(trim_mean(rp), trim_mean(rr)):.6f}, median return "
          f"{rel(*ret):.6f}")
    try:
        assert_loop_equivalent(rr, pr, rp, pp, steps=STEPS)
        print("assert_loop_equivalent (DEFAULT_TOL): pass")
    except AssertionError as e:
        print(f"assert_loop_equivalent (DEFAULT_TOL): FAIL {e}")
    try:
        from scipy.stats import mannwhitneyu
    except ImportError:
        return
    for k in (2, 3):
        res = mannwhitneyu([x["tm"][k] for x in st["ref"]],
                           [x["tm"][k] for x in st["port"]])
        print(f"Mann-Whitney, update {k + 1} trimmed means: U "
              f"{res.statistic:.1f}, p {res.pvalue:.4f}")


def _serve(side: str, seed: int, window_impl: str = "kernel") -> dict:
    import functools

    from test_torch_serve import (DEGRADED, DEGRADED_STATIONARY, _controller,
                                  _ref_controller)

    make = (functools.partial(_controller, window_impl=window_impl)
            if side == "port" else _ref_controller)
    ctl = make(seed=seed, k_promote=2, margin=0.02, slo_ms=400_000.0,
               incumbent=DEGRADED)
    first = None
    for i in range(8):
        if ctl.run_cycle()["decision"] == "promote":
            first = i + 1
            break
    acc = make(seed=seed, k_promote=2, margin=0.02, slo_ms=20_000.0,
               eval_windows=2, incumbent=DEGRADED_STATIONARY)
    acc.run(20)
    return {"first_promote": first, "promotions": acc.counters.promotions,
            "rollbacks": acc.counters.rollbacks}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("what", choices=["megascan", "serve"])
    ap.add_argument("--seeds", default="0-15", help="e.g. 0-31 or 0,11,23")
    ap.add_argument("--side", choices=["both", "ref", "port"],
                    default="both")
    ap.add_argument("--window-impl", choices=["kernel", "scan"],
                    default="kernel",
                    help="serve: the port controllers' window")
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    import torch
    torch.set_num_threads(1)

    seeds = _seeds(args.seeds)
    sides = ["ref", "port"] if args.side == "both" else [args.side]
    run = (_megascan if args.what == "megascan" else
           lambda side, s: _serve(side, s, args.window_impl))
    runs = {side: {} for side in sides}
    for side in sides:
        for s in seeds:
            t0 = time.perf_counter()
            runs[side][s] = run(side, s)
            if args.what == "serve":
                print(f"{side} seed {s}: {runs[side][s]} "
                      f"({time.perf_counter() - t0:.1f} s)", flush=True)
    if args.what == "megascan":
        _megascan_report(runs, seeds)
    else:
        for side in sides:
            r = runs[side].values()
            print(f"{side}: degraded promoted within 8 cycles at "
                  f"{sum(x['first_promote'] is not None for x in r)} of "
                  f"{len(seeds)} seeds; acceptance promoted at "
                  f"{sum(x['promotions'] >= 1 for x in r)} of {len(seeds)}")
    if args.json:
        Path(args.json).write_text(json.dumps(runs))


if __name__ == "__main__":
    main()
