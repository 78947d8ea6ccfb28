"""Quickstart on the PyTorch/CUDA port: the paper's pipeline against the
simulated cluster, on the card (``cpu`` as the first argument runs the
kernels' plain versions on the host).

    PYTHONPATH=src python examples/torch_quickstart.py          # the card
    PYTHONPATH=src python examples/torch_quickstart.py cpu

1. Spin up a simulated 10-node streaming cluster under a Poisson workload.
2. Collect training windows with random single-lever perturbations (§2.1).
3. Select metrics with FA + k-means (§2.2) and rank levers with the Lasso
   path (§2.3, the lasso_cd kernel).
4. Run the REINFORCE configurator (§2.4) and watch p99 latency fall.
"""
import sys

import numpy as np

from repro_torch.core import AutoTuner
from repro_torch.data.workloads import PoissonWorkload
from repro_torch.engine import SimCluster

device = sys.argv[1] if len(sys.argv) > 1 else None
env = SimCluster(PoissonWorkload(lam=10_000, event_size_mb=0.5), seed=0,
                 device=device)
tuner = AutoTuner(env, seed=0, window_s=240.0, top_levers=8)

print(f"collecting training windows (random lever exploration) on "
      f"{env.device} ...")
tuner.collect(800)
metrics, levers = tuner.analyse()
print(f"selected metrics ({tuner.selection.reduction:.0%} reduction): {metrics}")
print(f"ranked levers: {levers}")

env.reset()
base = env.observe(300.0)
print(f"\ndefault config p99 = {base.p99_ms:.0f} ms")

cfgr = tuner.build_configurator(steps_per_episode=5, episodes_per_update=4,
                                window_s=240.0, f_exploit=0.8)
for update in range(8):
    stats = cfgr.run_update()
    recent = [r.p99_ms for r in cfgr.history[-20:]]
    print(f"update {update}: p99 (last 20 changes) mean {np.mean(recent):.0f} ms, "
          f"min {np.min(recent):.0f} ms")

best = min(cfgr.history, key=lambda r: r.p99_ms)
defaults = {s.name: s.default_value() for s in env.lever_specs}
print(f"\nbest p99 {best.p99_ms:.0f} ms "
      f"({100 * (1 - best.p99_ms / base.p99_ms):.0f}% below default)")
print(f"best lever deltas: "
      f"{ {k: v for k, v in best.config.items() if v != defaults[k]} }")
