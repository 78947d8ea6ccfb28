"""Fig-8 style demo on the PyTorch/CUDA port: the tuner adapts when the
workload switches λ1 -> λ2 (``cpu`` as the first argument runs off the
card).

    PYTHONPATH=src python examples/torch_adapt_to_workload_change.py

Distribution 1: 10k ev/s of 0.5 MB events. Distribution 2: 100k ev/s of
5 MB events. The switch spikes p99; the configurator claws it back (to a
higher baseline — bigger events simply cost more, as the paper notes).
"""
import sys

import numpy as np

from repro_torch.core import AutoTuner
from repro_torch.data.workloads import PoissonWorkload, SwitchingWorkload
from repro_torch.engine import SimCluster

device = sys.argv[1] if len(sys.argv) > 1 else None
wl = SwitchingWorkload(PoissonWorkload(10_000, 0.5),
                       PoissonWorkload(100_000, 5.0), period_s=1e12)
env = SimCluster(wl, seed=1, device=device)
tuner = AutoTuner(env, seed=1, window_s=240.0, top_levers=8)

print(f"offline phase on {env.device}: collect + analyse ...")
tuner.collect(900)
tuner.analyse()
print(f"ranked levers: {tuner.ranked_levers}")

env.reset()
cfgr = tuner.build_configurator(steps_per_episode=5, episodes_per_update=4,
                                window_s=240.0, f_exploit=0.7)
print("\ntuning on distribution 1 ...")
cfgr.tune(6)
lam1 = np.mean([r.p99_ms for r in cfgr.history[-8:]])
print(f"λ1 baseline p99 ≈ {lam1:.0f} ms")

print("\n-- workload switches to distribution 2 (100k ev/s, 5 MB events) --")
wl.period_s = 1.0  # flip the active distribution
spike = env.observe(240.0).p99_ms
print(f"immediate post-switch p99 = {spike:.0f} ms "
      f"({spike / lam1:.1f}x the λ1 baseline)")

print("\nadapting ...")
cfgr.tune(6)
lam2 = np.mean([r.p99_ms for r in cfgr.history[-8:]])
best = np.min([r.p99_ms for r in cfgr.history[-24:]])
print(f"λ2 baseline p99 ≈ {lam2:.0f} ms (best window {best:.0f} ms)")
print("note: λ2 settles above λ1 — distribution 2 events are 10x larger, "
      "exactly the paper's Fig 8 observation.")
