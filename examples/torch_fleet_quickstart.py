"""Fleet quickstart on the PyTorch/CUDA port: the paper's 80-cluster offline
sweep + N-parallel REINFORCE episodes, batched in one FleetEnv on the card.

    PYTHONPATH=src python examples/torch_fleet_quickstart.py          # 80
    PYTHONPATH=src python examples/torch_fleet_quickstart.py 256
    PYTHONPATH=src python examples/torch_fleet_quickstart.py 16 cpu

1. Build an N-cluster fleet (default 80) over the device-packable slice of
   the heterogeneous workload roster (steady, ramping and regime-switching
   arrivals; the IoT trace's burst schedule is a host array and would send
   the configurator to its per-step host loop).
2. Collect training windows fleet-wide through the integerised §2.1 sweep:
   every cluster perturbs its own random lever per window, all clusters
   advance in one fleet_tick launch.
3. Select metrics (FA + k-means, §2.2) and rank levers (Lasso path, §2.3).
4. Run the configurator with N parallel REINFORCE episodes per update — as
   the fused device loop — and report the training windows/s.
"""
import sys
import time

import numpy as np

from repro_torch.core import AutoTuner
from repro_torch.engine import FleetEnv

N = int(sys.argv[1]) if len(sys.argv) > 1 else 80
device = sys.argv[2] if len(sys.argv) > 2 else None

env = FleetEnv.heterogeneous(
    N, seed=0, device=device,
    mix=("poisson_low", "trapezoid", "yahoo_ads", "switching"))
tuner = AutoTuner(env, seed=0, window_s=240.0, top_levers=8)

print(f"collecting training windows across {N} clusters on {env.device} ...")
t0 = time.perf_counter()
tuner.collect(1200, windows_per_cluster=6)  # integerised §2.1 sweep
print(f"  {len(tuner.matrix.target) / (time.perf_counter() - t0):.0f} windows/s")
metrics, levers = tuner.analyse()
print(f"selected metrics ({tuner.selection.reduction:.0%} reduction): {metrics}")
print(f"ranked levers: {levers}")

env.reset()
base = [w.p99_ms for w in env.observe(300.0)]
print(f"\ndefault config p99 (fleet mean) = {np.mean(base):.0f} ms")

cfgr = tuner.build_configurator(steps_per_episode=5, window_s=240.0,
                                f_exploit=0.8)
reason = cfgr.device_loop_reason()
print("fused device loop (§10): "
      + ("ACTIVE" if reason is None else f"off ({reason})"))
for update in range(6):
    t0 = time.perf_counter()
    stats = cfgr.run_update()  # N parallel episodes -> one policy update
    dt = time.perf_counter() - t0
    recent = [r.p99_ms for r in cfgr.history[-5 * N:]]
    print(f"update {update}: p99 mean {np.mean(recent):.0f} ms, "
          f"min {np.min(recent):.0f} ms ({stats['episodes']} episodes, "
          f"{stats['steps']} steps, {stats['steps'] / dt:.0f} win/s)")

best = min(cfgr.history, key=lambda r: r.p99_ms)
print(f"\nbest p99 {best.p99_ms:.0f} ms "
      f"({100 * (1 - best.p99_ms / np.mean(base)):.0f}% below default)")
