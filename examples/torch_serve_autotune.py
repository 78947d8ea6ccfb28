"""End-to-end example on the PyTorch/CUDA port: serve a small LM with batched
requests through the REAL StreamEngine while the paper's tuner adjusts
engine levers live, on the card (``--device cpu`` runs on the host).

    PYTHONPATH=src python examples/torch_serve_autotune.py [--seconds-per-window 4]
    PYTHONPATH=src python examples/torch_serve_autotune.py --device cpu

This is the real-hardware counterpart of torch_quickstart.py: every latency
number below is measured wall-clock on the device — first calls of new
shapes, batch formation, padding and all. The tuner runs the identical
pipeline (collect -> FA/k-means -> Lasso -> REINFORCE); only the environment
changed, which is the paper's whole point: the method is engine-agnostic.
"""
import argparse

import numpy as np

from repro_torch.core import AutoTuner
from repro_torch.data.workloads import PoissonWorkload
from repro_torch.engine import LocalEngine

ap = argparse.ArgumentParser()
ap.add_argument("--seconds-per-window", type=float, default=4.0)
ap.add_argument("--collect-windows", type=int, default=24)
ap.add_argument("--updates", type=int, default=4)
ap.add_argument("--device", default=None,
                help="torch device of the engine and the tuner (default: "
                     "the CUDA card)")
args = ap.parse_args()

env = LocalEngine(PoissonWorkload(lam=30.0, event_size_mb=0.5), seed=0,
                  device=args.device)
print(f"started the real StreamEngine (reduced smollm-135m on {env.device})")

base = env.observe(args.seconds_per_window)
print(f"default config: p99 {base.p99_ms:.0f} ms over "
      f"{base.latencies_ms.size} events")

tuner = AutoTuner(env, seed=0, window_s=args.seconds_per_window, top_levers=5)
print(f"collecting {args.collect_windows} real windows "
      f"(~{args.collect_windows * args.seconds_per_window:.0f}s) ...")
tuner.collect(args.collect_windows, windows_per_cluster=8)
metrics, levers = tuner.analyse()
print(f"selected metrics: {metrics}")
print(f"ranked levers:    {levers}")

env.reset()
cfgr = tuner.build_configurator(steps_per_episode=3, episodes_per_update=2,
                                window_s=args.seconds_per_window, f_exploit=0.8)
for u in range(args.updates):
    stats = cfgr.run_update()
    recent = [r.p99_ms for r in cfgr.history[-6:]]
    print(f"update {u}: p99 (last 6 changes) mean {np.mean(recent):.0f} ms, "
          f"min {np.min(recent):.0f} ms")

best = min(cfgr.history, key=lambda r: r.p99_ms)
e = env.engine
print(f"\nbest p99 {best.p99_ms:.0f} ms "
      f"({100 * (1 - best.p99_ms / base.p99_ms):.0f}% below default)")
print(f"winning lever deltas: "
      f"{ {k: v for k, v in best.config.items() if v != dict((s.name, s.default_value()) for s in env.lever_specs)[k]} }")
print(f"engine totals: {e.buffer.stats.total_out} events served, "
      f"{e.jit_compiles} first calls of new shapes ({e.jit_time_s:.1f}s), "
      f"{e.buffer.stats.replayed} replays, {e.sink.duplicates} sink dupes")
