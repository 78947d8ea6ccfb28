"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. facts    the card's name and power limit (nvidia-smi), torch and CUDA
2. build    nvcc builds every kernel of the main path from the checkout's
            sources into build/kernels/ and prints ptxas's report
3. kernels  each kernel against its plain PyTorch version on the card at the
            main path's shapes (and ragged / K>S ones), with the stated
            tolerance, then both timed with CUDA events beside the bound
4. main     the port's main path through its entry points: FleetEnv of
            N=1024 clusters (10 nodes, 109 levers) + Configurator with the
            --quick metric/lever preset, 3 run_update outer iterations of 5
            fused steps with 240 s windows; the kernel launch count is read
            around exactly this run. Then the steady rate over 10 more
            updates (all their windows over all their time) and one
            profiled update
5. check    a 16-cluster greedy episode batch on the card, once through the
            kernel and once through its plain version, must agree

The last two lines are the kernels JSON and the contract JSON. The script
imports neither jax nor the JAX package; it needs one card.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

QUICK_METRICS = ["latency_p99_ms", "latency_mean_ms", "queue_depth",
                 "device_util", "sched_queue_depth"]
QUICK_LEVERS = ["max_batch_events", "prefetch_depth", "driver_memory_gb",
                "sink_partitions", "backup_tasks"]
MIX = ("poisson_low", "trapezoid", "yahoo_ads", "switching")
#: frozen §2.4.1 bin adaptation, as the reference's N=1024 training rows run
#: it (benchmarks/fleet_scaling.py): replaying 5k assignments per lever per
#: batch otherwise splits bins every few steps and the tables explode
FROZEN = dict(split_after=10**9, extend_after=10**9, merge_after=10**9)
#: published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 non-tensor
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
#: kernel vs plain tolerance: the kernel is built with -fmad=false and does
#: the plain version's f32 operations in its order (exact min/max sorting,
#: the same adjacent-pair lane sum), so they should agree to the bit; rtol
#: 1e-5 leaves room only for libm differences
RTOL, ATOL = 1e-5, 1e-6


def _gpu_facts() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int = 100, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _kernel_inputs(N: int, T: int, S: int, seed: int, dev):
    """Operands at one (N, T, S) point: real packed constants of a
    heterogeneous fleet, seeded noise, a non-trivial fault multiplier and a
    window mask with a stabilisation preroll."""
    from repro_torch.engine import FleetEnv
    from repro_torch.kernels.fleet_tick import pack_tick_consts

    env = FleetEnv.heterogeneous(N, seed=seed, mix=MIX, backend="torch",
                                 device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    cc = {k: torch.as_tensor(v, **f32) for k, v in env.packed().items()}
    mc = {k: torch.as_tensor(v, device=dev,
                             dtype=torch.bool if v.dtype == bool else torch.float32)
          for k, v in env.mc.items()}
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    n_ticks = rng.integers(T // 2, T + 1, N)
    n_skip = rng.integers(0, T // 4 + 1, N)
    t_ax = np.arange(T)[:, None]
    ops = dict(
        state=t(np.stack([rng.uniform(0, 5e4, N), rng.uniform(0, 5, N)])),
        consts=pack_tick_consts(cc, mc, env.spec, env.chips).contiguous(),
        rate=t(rng.uniform(5e3, 6e4, (T, N))),
        size=t(rng.uniform(0.001, 5.0, (T, N))),
        z=t(rng.standard_normal((T, N))),
        u_strag=t(rng.random((T, N))), u_raw=t(rng.random((T, N))),
        u_fail=t(rng.random((T, N))),
        active=t(t_ax < n_ticks[None, :]),
        u_wait=t(rng.random((T, S, N))),
        z2a=t(np.abs(rng.standard_normal((T, S, N)))),
        fmult=t(np.where(rng.random((T, N)) < 0.1,
                         rng.uniform(1.0, 4.0, (T, N)), 1.0)),
        wmask=t((t_ax < n_ticks[None, :]) & (t_ax >= n_skip[None, :])))
    kw = dict(noise=env.spec.noise, retention_s=env.spec.retention_s,
              straggler_prob=env.spec.straggler_prob,
              slo=env.spec.straggler_slow[0], shi=env.spec.straggler_slow[1])
    return ops, kw


def phase_kernels(dev) -> dict:
    from repro_torch.engine.fleet_torch import p99_depth
    from repro_torch.kernels import fleet_tick as ft

    # (N, T, S): the fused step's window, the observe window, a ragged long
    # window, and a K > S head
    shapes = [(1024, 48, 32), (1024, 24, 64), (1000, 192, 8), (777, 32, 16)]
    main = None
    for N, T, S in shapes:
        p99_k = 40 if (N, T, S) == (777, 32, 16) else p99_depth(T, S)
        K = ft.head_budget(S, p99_k)
        ops, kw = _kernel_inputs(N, T, S, seed=N + T + S, dev=dev)
        args = list(ops.values())
        got = ft.fleet_tick_window(*args, **kw, p99_k=p99_k)
        ref = ft.fleet_tick_window_ref(*args, **kw, p99_k=p99_k)
        torch.cuda.synchronize()
        worst = 0.0
        for name, a, b in zip(("state", "ys", "stats", "head"), got, ref):
            a, b = a.cpu().numpy(), b.cpu().numpy()
            fin = np.isfinite(b)
            if not np.array_equal(fin, np.isfinite(a)):
                raise AssertionError(f"{name}: finite masks differ at {N, T, S}")
            # the non-finite entries (-inf padding, quantiles of ticks outside
            # the window) must be the same values: sign of inf, NaN slots
            if not np.array_equal(a[~fin], b[~fin], equal_nan=True):
                raise AssertionError(f"{name}: non-finite entries differ at "
                                     f"{N, T, S}")
            err = np.abs(a[fin] - b[fin])
            rel = err / np.maximum(np.abs(b[fin]), 1e-30)
            ok = np.all(err <= ATOL + RTOL * np.abs(b[fin]))
            exact = np.array_equal(a, b, equal_nan=True)
            mx = float(err.max()) if err.size else 0.0
            worst = max(worst, mx)
            print(f"  N={N} T={T} S={S} K={K} {name:5s} max_abs={mx:.3e} "
                  f"max_rel={float(rel.max()) if rel.size else 0.0:.3e} "
                  f"bitwise={exact} (rtol {RTOL}, atol {ATOL})")
            if not ok:
                raise AssertionError(f"{name} out of tolerance at {N, T, S}")
        ms = _time_ms(lambda: ft.fleet_tick_window(*args, **kw, p99_k=p99_k))
        plain_ms = _time_ms(
            lambda: ft.fleet_tick_window_ref(*args, **kw, p99_k=p99_k),
            reps=100, warmup=2)
        nbytes, nops = ft.window_cost(T, S, K, N, fmult=True)
        bound_ms = max(nbytes / HBM_BYTES_S, nops / F32_OPS_S) * 1e3
        by = "bytes" if nbytes / HBM_BYTES_S >= nops / F32_OPS_S else "operations"
        print(f"  N={N} T={T} S={S}: kernel {ms * 1e3:.1f} us, plain "
              f"{plain_ms * 1e3:.1f} us, bound {bound_ms * 1e3:.2f} us by "
              f"{by} ({nbytes / 1e6:.2f} MB, {nops / 1e6:.1f} Mop)")
        if main is None:
            main = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": by}
    return main


def phase_main(dev, facts: str) -> dict:
    from repro_torch.core import Configurator
    from repro_torch.engine import FleetEnv
    from repro_torch.kernels import fleet_tick as ft

    N, S, updates = 1024, 5, 3
    env = FleetEnv.heterogeneous(N, seed=0, backend="torch", mix=MIX)
    assert env.device.type == "cuda" and env.n_nodes == 10
    assert len(env.lever_specs) == 109
    cfgr = Configurator(env, QUICK_METRICS, QUICK_LEVERS, device_loop="on",
                        window_s=240.0, steps_per_episode=S, bin_kw=FROZEN)
    assert cfgr.hspec.state_dim == 65 and cfgr.agent.n_actions == 10
    w0 = {k: v.detach().clone() for k, v in cfgr.agent.params.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ft.LAUNCHES = 0
    t0 = time.perf_counter()
    per_update = []
    for _ in range(updates):
        t1 = time.perf_counter()
        stats = cfgr.run_update()
        torch.cuda.synchronize()
        per_update.append(time.perf_counter() - t1)
    wall = time.perf_counter() - t0
    launches = ft.LAUNCHES
    expected = 1 + updates * S      # first batch's observe + one per step
    print(f"  fleet_tick launches {launches} (expected {expected})")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    r = np.array([rec.reward for rec in cfgr.history])
    p = np.array([rec.p99_ms for rec in cfgr.history])
    assert r.shape == (updates * N * S,), r.shape
    assert np.isfinite(r).all(), "non-finite rewards"
    assert (p > 0).all() and np.isfinite(p).all(), "bad p99"
    assert np.isfinite(stats["pg_loss"]), stats
    moved = [k for k, v in cfgr.agent.params.items()
             if not torch.equal(v.detach(), w0[k])]
    assert moved, "policy parameters did not change"
    mem = torch.cuda.max_memory_allocated()
    print(f"  {updates} run_updates at N={N}: {wall:.3f} s "
          f"(per update {', '.join(f'{x:.3f}' for x in per_update)} s; the "
          f"first carries one-time set-up), {updates * N * S / wall:.1f} "
          f"windows/s, peak device memory {mem / 2**20:.1f} MiB [{facts}]")
    print(f"  reward mean {r.mean():.4f} median {np.median(r):.4f}, p99 median "
          f"{np.median(p):.1f} ms, last pg_loss {stats['pg_loss']:.5f}, "
          f"params moved: {moved}")
    _steady_rate(cfgr, N, S, facts)
    _profile_update(cfgr)
    return {"launches": launches}


def _steady_rate(cfgr, N: int, S: int, facts: str, updates: int = 10) -> None:
    """Training windows/s after warm-up: all N·S windows of ``updates`` more
    outer iterations over their whole wall time (after the main path's launch
    count was read), with the spread of the per-update times."""
    from repro_torch.kernels import fleet_tick as ft

    before = ft.LAUNCHES
    times = []
    for _ in range(updates):
        t1 = time.perf_counter()
        cfgr.run_update()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t1)
    if ft.LAUNCHES - before != updates * S:
        raise AssertionError(f"steady run: {ft.LAUNCHES - before} launches, "
                             f"expected {updates * S}")
    t = np.array(times)
    print(f"  steady: {updates} more run_updates, {updates * N * S} windows in "
          f"{t.sum():.6f} s = {updates * N * S / t.sum():.1f} windows/s; per "
          f"update min {t.min():.6f}, median {np.median(t):.6f}, max "
          f"{t.max():.6f} s [{facts}]")
    print(f"  steady per update, in order: "
          f"{', '.join(f'{x:.6f}' for x in t)} s")


def _profile_update(cfgr) -> None:
    """One more outer iteration under torch.profiler: device busy share
    and the kernels that take the device time (after the launch count was
    read, so the main-path count is untouched)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        cfgr.run_update()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side rows only (kernels, copies): the CPU-side aten rows carry
    # the same device time again
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    print(f"  profiled run_update: wall {wall * 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms ({100 * busy_us / 1e6 / wall:.1f} %), "
          f"{launches} device launches")
    for e in sorted(rows, key=lambda e: e.device_time_total,
                    reverse=True)[:8]:
        print(f"    {e.device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:70]}")


def phase_check(dev) -> None:
    """A small greedy batch through the kernel and through its plain
    version, with identical draws, on the card."""
    from repro_torch.core import Configurator
    from repro_torch.engine import FleetEnv
    from repro_torch.engine.draws import PhiloxDraws
    from repro_torch.kernels import fleet_tick as ft

    def run():
        env = FleetEnv.heterogeneous(16, seed=3, backend="torch", mix=MIX)
        env._dev.draws = PhiloxDraws(1234, dev)
        cfgr = Configurator(env, QUICK_METRICS, QUICK_LEVERS,
                            device_loop="on", window_s=240.0,
                            steps_per_episode=3)
        batch, recs = cfgr.run_fleet_episodes_device(explore=False)
        return (batch["actions"].cpu().numpy(), batch["rewards"].cpu().numpy(),
                np.array([x.p99_ms for x in recs]), env.clock.copy())

    kern = run()
    saved = ft.fleet_tick_window
    ft.fleet_tick_window = ft.fleet_tick_window_ref
    try:
        plain = run()
    finally:
        ft.fleet_tick_window = saved
    assert np.array_equal(kern[0], plain[0]), "greedy actions differ"
    for name, a, b in zip(("rewards", "p99", "clock"), kern[1:], plain[1:]):
        assert np.isfinite(a).all(), name
        if not np.allclose(a, b, rtol=RTOL, atol=0.0):
            raise AssertionError(f"{name}: kernel path {a} vs plain {b}")
        print(f"  greedy N=16 {name}: max_rel "
              f"{float(np.max(np.abs(a - b) / np.abs(b))):.3e} (rtol {RTOL})")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import fleet_tick as ft

    dev = torch.device("cuda")
    print("[1] facts")
    facts = _gpu_facts()
    print(f"  {facts}")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}")
    print("[2] build")
    t0 = time.perf_counter()
    lib = ft.build(force=True)
    print(f"  {lib.relative_to(Path(__file__).resolve().parent)} built in "
          f"{time.perf_counter() - t0:.1f} s")
    for line in ft.BUILD_LOG.strip().splitlines():
        print(f"  | {line}")
    print("[3] kernel against plain")
    row = phase_kernels(dev)
    print("[4] main path")
    main_row = phase_main(dev, facts)
    print("[5] small-input check")
    phase_check(dev)
    kern = {"name": "fleet_tick_window", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/fleet_tick.cu",
            "replaces": "src/repro/kernels/fleet_tick.py:387",
            "launches": main_row["launches"], **row, "library_ms": None}
    print(facts)
    print(json.dumps({"kernels": [kern]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
