"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. facts    the card's name and power limit (nvidia-smi), torch and CUDA
2. build    nvcc builds every kernel of every path from the checkout's
            sources into build/kernels/ (one nvcc per source, all started
            together) and prints ptxas's report, and a line per kernel of
            its registers, spills and shared memory
3. kernels  fleet_tick against its plain PyTorch version on the card at the
            tuning path's shapes (and ragged / K>S ones), with the stated
            tolerance, then the kernel's device time (a CUDA graph of 100
            launches) and host-loop time and the plain version's time
            beside the bound
4. main     the tuning path through its entry points: FleetEnv of
            N=1024 clusters (10 nodes, 109 levers) + Configurator with the
            --quick metric/lever preset, 3 run_update outer iterations of 5
            fused steps with 240 s windows; the kernel launch count is read
            around exactly this run. Then the steady rate over 10 more
            updates (all their windows over all their time) and one
            profiled update
5. check    a 16-cluster greedy episode batch on the card, once through the
            kernel and once through its plain version, must agree
6. attn     the flash-attention kernel against its plain version at the
            serve shape, SmolLM's heads with a ragged tail, a q_offset case,
            full (non-causal) cases, group 1 and group 8, group 7 with a
            ragged Sq, Sq=1 decode at q_offset 511, causal S=2048 (several
            key tiles), each in bf16 and f32 with the stated tolerances;
            the kernel's device time (a CUDA graph of 100 launches) and
            host-loop time, the plain version's time, and at the serve shape
            scaled_dot_product_attention's device and host-loop times (the
            library yardstick, never on a path), beside the bound
7. serve    the serving path through its entry points: StreamEngine over
            the full Qwen2-7B config (28 layers, bf16, random weights from a
            seed, attn_impl="pallas"), a 640-event backlog of LocalEngine's
            default traffic drained in full micro-batches, then a short batch
            of 5 events; the attention kernel's launches must be 28 per
            forward pass. Then forward_prefill on the same weights and
            tokens with the kernel and with naive attention must agree
8. wkv      the RWKV-6 wkv kernel against its plain versions at the
            rwkv6-7b train shape (B=4, H=64, S=4096, hd=64; bf16 r/k/v with
            f32 logw/u, and all-f32; chunks 32 and 64), a ragged S, S <
            chunk and logw at both clip ends, with the stated tolerances;
            the kernel's device time (a CUDA graph of 20 launches) and
            host-loop time and the plain chunked version's time beside the
            bound (bf16 on the tensor cores' peak)
9. rwkv     the RWKV-6 path at full rwkv6-7b width (32 layers, bf16,
            random weights from a seed): forward_train on a 4x4096
            make_batch (the reference's route, the plain chunked wkv), then
            the same 32 layers walked as _rwkv_block composes them but with
            rwkv6_time_mix(impl="pallas"), exactly 32 kernel launches a
            pass, each layer's time mix against the chunked one, loss and
            logits against forward_train's, logits on an f32 copy of the
            weights, forward_prefill (no kernel launch) against score_last
10. ssd     the Mamba2 SSD kernel through ops.mamba2_ssd at zamba2-2.7b's
            mixer shape (B=4, nh=80, S=4096, hd=64, ns=64, chunk 128; f32
            and bf16), a ragged S and S < chunk, against the plain chunked
            and sequential versions; times beside the bound

Each path's kernel launches are counted from 0 just before the path runs
and read just after. The last two lines are the kernels JSON and the
contract JSON. The script imports neither jax nor the JAX package; it
needs one card.
"""
from __future__ import annotations

import dataclasses
import gc
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
#: published H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
BF16_OPS_S = 989e12
#: flash attention vs its plain version: the tolerances of
#: tests/test_kernels.py (online vs full softmax, f32 sums in other orders;
#: bf16 outputs one rounding apart)
ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
#: the whole 28-layer model in f32, kernel vs naive attention: the per-call
#: 2e-5, compounded over 28 layers of 3584-wide matmuls (measured ~1e-5 of
#: growth per layer at most), with room
F32_DEPTH_TOL = 1e-3
#: the whole 28-layer model in bf16, kernel vs naive attention: at most this
#: many times the distance between the two plain implementations (chunked vs
#: naive) on the same weights and tokens, the floor that bf16 rounding of
#: each layer's attention output sets at depth
BF16_DEPTH_FLOOR_X = 1.5
#: wkv kernel vs its plain versions, max |difference| over the plain
#: output's scale max(1, max |plain|) (printed beside it: at S=4096 with
#: slow decays the state sums thousands of k vT products, and o reaches
#: hundreds). f32: tests/test_kernels.py's 1e-3 (the Pallas kernel against
#: the sequential oracle; the f32 kernel runs the recurrence token by token,
#: the chunked plain version sums in another order). bf16 r/k/v: o is rounded
#: to bf16 on both sides, one bf16 ulp is 2^-8 of the value: the bf16 3e-2 of
#: tests/test_kernels.py (the bf16 kernel's chunked products keep ~2^-16 of
#: each term before that rounding). S_fin is f32 in both cases: 1e-3
WKV_TOL = {torch.float32: 1e-3, torch.bfloat16: 3e-2}
#: SSD kernel vs its plain versions, on the same scale: tests/test_kernels.py's
#: f32 2e-4 (chunked vs sequential) and bf16 3e-2
SSD_TOL = {torch.float32: 2e-4, torch.bfloat16: 3e-2}
#: the RWKV-6 loss in bf16, kernel route vs forward_train's chunked route:
#: the loss is the f32 mean over 16384 positions of CE on bf16 logits; the
#: two routes' logits differ by single bf16 ulps (2^-8 relative) of both
#: signs, so the mean moves far less than one ulp; 1e-3 of the loss would
#: take a systematic quarter-ulp shift of every logit
RWKV_LOSS_RTOL = 1e-3


def _gpu_facts() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _bound(nbytes: float, ops: float, peak: float) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes at
    HBM_BYTES_S and the operations at ``peak``, and which of the two."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, ops / peak
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations"


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


def phase_kernels(dev, facts: str) -> dict:
    from repro_torch.engine.fleet_torch import p99_depth
    from repro_torch.kernels import fleet_tick as ft

    # (N, T, S, p99_k): the fused step's window, the observe window, a
    # ragged long window, a K > S head, a window of 768 ticks (16 merge
    # values a lane), one of 3328 ticks (its head merged by rank in shared
    # memory), and a head too long for shared memory (in global memory);
    # None takes the port's own depth
    shapes = [(1024, 48, 32, None), (1024, 24, 64, None),
              (1000, 192, 8, None), (777, 32, 16, 40), (1024, 768, 8, None),
              (1024, 3328, 8, None), (1000, 16, 8, 8000)]
    main = None
    for N, T, S, p99_k in shapes:
        p99_k = p99_depth(T, S) if p99_k is None else p99_k
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
        run = lambda: ft.fleet_tick_window(*args, **kw, p99_k=p99_k)
        geo = ft.launch_geometry(N, T, S, K)
        reps = 100 if geo["head"] == "registers" else 5  # these take ms
        ms, host_ms = _graph_ms(run, reps=reps), _time_ms(run, reps=reps)
        plain_ms = _time_ms(   # ~1k torch ops a tick: fewer reps when long
            lambda: ft.fleet_tick_window_ref(*args, **kw, p99_k=p99_k),
            reps=min(100, max(3, 4800 // T)), warmup=2)
        nbytes, nops = ft.window_cost(T, S, K, N, fmult=True)
        bound_ms, by = _bound(nbytes, nops, F32_OPS_S)
        print(f"  N={N} T={T} S={S}: kernel device {ms * 1e3:.3f} us (host "
              f"loop {host_ms * 1e3:.3f} us), plain {plain_ms * 1e3:.1f} us, "
              f"bound {bound_ms * 1e3:.3f} us by {by} ({nbytes / 1e6:.2f} MB, "
              f"{nops / 1e6:.1f} Mop), {bound_ms / ms:.4f} of the bound; "
              f"{geo['blocks']} blocks of {geo['threads']} threads, "
              f"{geo['smem_bytes']} B shared, head in {geo['head']} "
              f"[{facts}]")
        if main is None:
            main = {"max_abs_err": worst, "ms": ms, "ms_host_loop": host_ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": by}
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
    _zero_counts()
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


def _attn_inputs(B, Hq, Hkv, Sq, Skv, hd, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device=dev).to(dtype)
    return mk(B, Hq, Sq, hd), mk(B, Hkv, Skv, hd), mk(B, Hkv, Skv, hd)


def phase_attention(dev, facts: str) -> dict:
    """The flash-attention kernel against its plain version on the same
    tensors at the serve shape and the edge cases, then its times beside the
    bound: device time from a CUDA graph of captured launches, and the
    host-loop CUDA-event time (which includes the wrapper's host cost)."""
    bf16, f32 = torch.bfloat16, torch.float32
    # (label, B, Hq, Hkv, Sq, Skv, hd, causal, q_offset, dtypes)
    shapes = [
        ("qwen2-serve", 32, 28, 4, 64, 64, 128, True, 0, (bf16, f32)),
        ("smollm-ragged", 8, 9, 3, 40, 40, 64, True, 0, (f32, bf16)),
        ("qwen2-offset", 2, 28, 4, 16, 80, 128, True, 64, (bf16, f32)),
        ("full", 4, 8, 2, 50, 72, 32, False, 0, (f32, bf16)),
        ("group1-mha", 4, 8, 8, 64, 64, 128, True, 0, (bf16, f32)),
        ("group8", 4, 32, 4, 64, 64, 64, True, 0, (bf16, f32)),
        ("group7-ragged", 3, 28, 4, 40, 40, 128, True, 0, (bf16, f32)),
        ("decode", 4, 28, 4, 1, 512, 128, True, 511, (bf16, f32)),
        ("long-causal", 1, 28, 4, 2048, 2048, 128, True, 0, (bf16, f32)),
        ("full-bf16", 2, 28, 4, 100, 300, 128, False, 0, (bf16, f32)),
    ]
    main = None
    seed = 0
    for label, B, Hq, Hkv, Sq, Skv, hd, causal, off, dts in shapes:
        for dt in dts:
            q, k, v = _attn_inputs(B, Hq, Hkv, Sq, Skv, hd, dt, dev, seed=seed)
            seed += 1
            row = _attention_case(label, q, k, v, causal, off, facts)
            if main is None:
                sdpa_ms, sdpa_host_ms = _sdpa_ms(q, k, v, Hq // Hkv)
                main = {**row, "library_ms": sdpa_ms,
                        "library_ms_host_loop": sdpa_host_ms}
                print(f"    scaled_dot_product_attention(is_causal=True, "
                      f"enable_gqa=True): device {sdpa_ms * 1e3:.3f} us, host "
                      f"loop {sdpa_host_ms * 1e3:.3f} us (yardstick only, never "
                      f"on a path); the kernel's device time is "
                      f"{row['ms'] / sdpa_ms:.3f}x SDPA's [{facts}]")
            del q, k, v
    return main


def _attention_case(label, q, k, v, causal, off, facts) -> dict:
    """One shape: the kernel against its plain version, then the kernel's
    device and host-loop times and the plain version's beside the bound."""
    from repro_torch.kernels import flash_attention as fa

    B, Hq, Sq, hd = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    dt = q.dtype
    kw = dict(causal=causal, q_offset=off)
    got = fa.flash_attention_bhsd(q, k, v, **kw)
    want = fa.flash_attention_bhsd_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    a, b = got.float(), want.float()
    if not torch.isfinite(a).all():
        raise AssertionError(f"flash_attention: non-finite output at {label}")
    err = float((a - b).abs().max())
    tol = ATTN_TOL[dt]
    ok = bool(((a - b).abs() <= tol + tol * b.abs()).all())
    shape = f"B={B} Hq={Hq} Hkv={Hkv} Sq={Sq} Skv={Skv} hd={hd}"
    print(f"  {label} {shape} causal={causal} q_offset={off} "
          f"{str(dt).removeprefix('torch.')}: max_abs={err:.3e} "
          f"(rtol=atol={tol})")
    if not ok:
        raise AssertionError(f"flash_attention out of tolerance at {label} "
                             f"{dt}")
    ms = _graph_ms(lambda: fa.flash_attention_bhsd(q, k, v, **kw))
    host_ms = _time_ms(lambda: fa.flash_attention_bhsd(q, k, v, **kw))
    plain_ms = _time_ms(lambda: fa.flash_attention_bhsd_ref(q, k, v, **kw),
                        reps=20, warmup=2)
    nbytes, flops = fa.attention_cost(B, Hq, Hkv, Sq, Skv, hd, causal=causal,
                                      q_offset=off, itemsize=q.element_size())
    bound_ms, by = _bound(nbytes, flops,
                          BF16_OPS_S if dt == torch.bfloat16 else F32_OPS_S)
    print(f"    kernel device {ms * 1e3:.3f} us (host loop {host_ms * 1e3:.3f}"
          f" us), plain {plain_ms * 1e3:.3f} us, bound {bound_ms * 1e3:.3f} us "
          f"by {by} ({nbytes / 1e6:.2f} MB, {flops / 1e9:.4f} GFLOP), "
          f"{bound_ms / ms:.3f} of the bound [{facts}]")
    return {"max_abs_err": err, "ms": ms, "ms_host_loop": host_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by}


def _graph_ms(fn, reps: int = 100, replays: int = 5) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph,
    the graph replayed ``replays`` times under CUDA events; the median
    replay over ``reps``. The host's launch cost is out of the figure."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):  # warm-up off the capture (one-time set-up)
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return float(np.median(times))


def _sdpa_ms(q, k, v, group: int) -> tuple[float, float]:
    """One PyTorch call computing the same function, causal GQA attention,
    the library's yardstick for the table: (device ms, host-loop ms)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = sdpa(q, k, v, is_causal=True, enable_gqa=True)
    want = sdpa(q, k.repeat_interleave(group, 1), v.repeat_interleave(group, 1),
                is_causal=True)
    torch.cuda.synchronize()
    assert out.shape == q.shape and torch.isfinite(out.float()).all()
    assert float((out.float() - want.float()).abs().max()) <= 3e-2
    fn = lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True)
    return _graph_ms(fn), _time_ms(fn)


def _serve_events(n: int, seed: int):
    """n events of LocalEngine's default traffic (Poisson, 24 events/s,
    0.5 MB mean, sizes drawn +-30 %: ~32 tokens each)."""
    from repro_torch.data.workloads import PoissonWorkload

    wl = PoissonWorkload(lam=24.0, event_size_mb=0.5)
    rng = np.random.default_rng(seed)
    evs, t = [], 0.0
    while len(evs) < n:
        evs += wl.sample_events(t, t + 10.0, rng)
        t += 10.0
    return evs[:n]


def phase_serve(dev, facts: str) -> dict:
    """StreamEngine on full-width Qwen2-7B: a 640-event backlog in full
    micro-batches, then a short batch; the attention kernel's launches are read around
    exactly this run. Then the kernel path against naive attention on the
    same weights and tokens."""
    from repro_torch.configs import qwen2_7b
    from repro_torch.engine import EngineConfig, StreamEngine
    from repro_torch.kernels import fleet_tick as ft
    from repro_torch.kernels import flash_attention as fa

    cfg = qwen2_7b.CONFIG
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.d_ff, cfg.vocab_size) == (28, 3584, 28, 4, 18944, 152064)
    econf = EngineConfig(compute_dtype="bfloat16", attn_impl="pallas",
                         max_batch_events=32, max_seq=64)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = StreamEngine(cfg, seed=0, econf=econf)
    torch.cuda.synchronize()
    assert eng.device.type == dev.type
    n_params = sum(t.numel() for t in _leaves(eng.params))
    print(f"  StreamEngine({cfg.name}, {cfg.num_layers} layers, bf16): "
          f"{n_params} parameters "
          f"drawn on the card in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    assert n_params == cfg.param_count()
    evs = _serve_events(645, seed=0)
    backlog, short = evs[:640], evs[640:]
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    passes0 = eng.forward_passes
    t_start = time.perf_counter()
    eng.buffer.put(backlog)
    reports = []
    while len(eng.buffer):
        reports.append(eng.process_batch(backlog[-1].arrival_s))
    eng.buffer.put(short)
    reports.append(eng.process_batch(short[-1].arrival_s))
    wall = time.perf_counter() - t_start
    launches, passes = fa.LAUNCHES, eng.forward_passes - passes0
    print(f"  flash_attention launches {launches} over {passes} forward passes "
          f"(expected {cfg.num_layers} each); fleet_tick launches {ft.LAUNCHES}")
    if launches != cfg.num_layers * passes or launches == 0:
        raise AssertionError(f"attention launches {launches} != "
                             f"{cfg.num_layers} x {passes}")
    if ft.LAUNCHES:
        raise AssertionError("fleet_tick launched on the serve path")
    sizes = [r.n_events for r in reports]
    assert sizes == [32] * 20 + [5], sizes
    rows = eng.sink.rows
    assert len(rows) == 645 and len({r["event_key"] for r in rows}) > 1
    toks_out = np.array([r["next_token"] for r in rows])
    assert ((toks_out >= 0) & (toks_out < cfg.vocab_size)).all()
    svc = np.array([r.service_s for r in reports])
    seq_of = lambda r_events: eng._bucket_seq(max(e.tokens for e in r_events))
    batches = [backlog[i:i + 32] for i in range(0, 640, 32)] + [short]
    real_tokens = sum(min(e.tokens, seq_of(b)) for b in batches for e in b)
    padded = sum((1 << int(np.ceil(np.log2(len(b))))) * seq_of(b)
                 for b in batches)
    mem = torch.cuda.max_memory_allocated()
    print(f"  {len(reports)} batches ({sizes[0]} x{len(sizes) - 1} + "
          f"{sizes[-1]}), shapes {sorted(eng._step_cache)}; service "
          f"{svc.sum():.6f} s: {645 / svc.sum():.1f} events/s, "
          f"{real_tokens / svc.sum():.1f} tokens/s ({real_tokens} real of "
          f"{padded} scored tokens); wall {wall:.3f} s with the first calls")
    print(f"  batch service ms: median {np.median(svc[:-1]) * 1e3:.3f} (full "
          f"batches), max {svc.max() * 1e3:.3f}, short batch "
          f"{svc[-1] * 1e3:.3f}; in order: "
          f"{', '.join(f'{x * 1e3:.2f}' for x in svc)}")
    print(f"  padding fraction: {1 - real_tokens / padded:.4f} overall, per "
          f"batch mean {np.mean([r.padding_frac for r in reports]):.4f}; "
          f"jit_compiles {eng.jit_compiles} (first calls, "
          f"{eng.jit_time_s:.3f} s); peak device memory "
          f"{mem / 2**30:.3f} GiB [{facts}]")

    _profile_serve_batch(eng, _serve_events(32, seed=1))
    # the kernel path against plain attention on the same weights and tokens
    # (the last full batch, at its own bucket)
    seq = seq_of(batches[-2])
    toks = torch.from_numpy(eng._tokens_of(batches[-2], seq)).to(dev)
    engine_tok = torch.as_tensor(toks_out[608:640], device=dev)
    _prefill_agreement(eng, cfg, toks, engine_tok)
    return {"launches": launches}


def _profile_serve_batch(eng, events) -> None:
    """One more full micro-batch under torch.profiler (after the launch
    count was read): device busy share and where the device time goes."""
    from torch.profiler import ProfilerActivity, profile

    eng.buffer.put(events)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        rep = eng.process_batch(events[-1].arrival_s)
        wall = time.perf_counter() - t0
    assert rep.n_events == len(events) and not rep.compiled
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in rows)
    launches = sum(e.count for e in rows)
    groups = {"attention kernel": 0.0, "matmul (cuBLAS)": 0.0, "other": 0.0}
    for e in rows:
        key = e.key.lower()
        if "attn_kernel" in key:
            groups["attention kernel"] += e.device_time_total
        elif any(w in key for w in ("gemm", "nvjet", "cutlass", "xmma")):
            groups["matmul (cuBLAS)"] += e.device_time_total
        else:
            groups["other"] += e.device_time_total
    print(f"  profiled batch of {rep.n_events}: wall {wall * 1e3:.3f} ms "
          f"(profiler on), service {rep.service_s * 1e3:.3f} ms, device busy "
          f"{busy_us / 1e3:.3f} ms ({100 * busy_us / 1e6 / wall:.1f} % of the "
          f"wall), {launches} device launches")
    print("  device time by group: " + ", ".join(
        f"{k} {v / 1e3:.3f} ms ({100 * v / max(busy_us, 1e-9):.1f} %)"
        for k, v in groups.items()))
    for e in sorted(rows, key=lambda e: e.device_time_total,
                    reverse=True)[:12]:
        print(f"    {e.device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:70]}")


def _prefill_agreement(eng, cfg, toks, engine_tok) -> None:
    """forward_prefill's last-position logits with the kernel ("pallas")
    against the plain "naive" and "chunked" attention, on the engine's bf16
    weights and on an f32 copy of the same values.

    In bf16, each attention output is rounded to bf16 once per layer by
    every implementation, and 28 layers carry those one-ulp differences into
    the logits; two plain implementations (chunked vs naive) differ by as
    much. So in bf16 the kernel's distance to naive must stay within
    BF16_DEPTH_FLOOR_X times that floor, and the argmax must agree on every
    row whose naive top-2 margin exceeds twice the floor. In f32 the rounding is gone and the whole model
    is held to F32_DEPTH_TOL."""
    import dataclasses

    from repro_torch.engine.engine import _cast_floats
    from repro_torch.models import forward_prefill

    def run(params, dtype):
        out = {}
        with torch.inference_mode():
            for impl in ("pallas", "naive", "chunked"):
                c = dataclasses.replace(eng.model_cfg, attn_impl=impl,
                                        dtype=dtype)
                logits, state = forward_prefill(params, c, {"tokens": toks},
                                                max_seq=64)
                out[impl] = logits[:, -1].float()
                assert torch.isfinite(out[impl]).all(), (dtype, impl)
                assert out[impl].shape == (toks.shape[0], cfg.vocab_size)
                assert tuple(state.kv_k.shape) == (
                    cfg.num_layers, toks.shape[0], 64, cfg.num_kv_heads,
                    cfg.resolved_head_dim)
                assert torch.isfinite(state.kv_k.float()).all()
        return out

    dist = lambda a, b: float((a - b).abs().max())
    agree = lambda a, b: float((a.argmax(-1) == b.argmax(-1)).float().mean())
    out = run(eng.params, "bfloat16")
    a, b, c = out["pallas"], out["naive"], out["chunked"]
    floor = dist(c, b)
    top2 = b.topk(2, dim=-1).values
    robust = (top2[:, 0] - top2[:, 1]) > 2 * floor
    print(f"  forward_prefill bf16 last-position logits (scale "
          f"{float(b.abs().max()):.3f}): pallas vs naive max_abs "
          f"{dist(a, b):.4e}, chunked vs naive {floor:.4e} (the plain floor; "
          f"ratio {dist(a, b) / max(floor, 1e-30):.3f}, limit "
          f"{BF16_DEPTH_FLOOR_X}); "
          f"argmax agreement pallas/naive {agree(a, b):.4f}, chunked/naive "
          f"{agree(c, b):.4f}; {int(robust.sum())} of {len(robust)} rows with "
          f"a top-2 margin above twice the floor")
    if dist(a, b) > BF16_DEPTH_FLOOR_X * floor:
        raise AssertionError(f"bf16 serve logits: kernel vs naive "
                             f"{dist(a, b):.4e} > {BF16_DEPTH_FLOOR_X} x the "
                             f"plain floor {floor:.4e}")
    if not torch.equal(a.argmax(-1)[robust], b.argmax(-1)[robust]):
        raise AssertionError("bf16 serve logits: the kernel's argmax differs "
                             "from naive on a row with a robust margin")
    same_engine = float((a.argmax(-1) == engine_tok).float().mean())
    print(f"  forward_prefill (pallas) argmax = the engine's sink on "
          f"{same_engine:.4f} of the batch")
    if same_engine != 1.0:
        raise AssertionError("forward_prefill's argmax differs from the "
                             "engine's step on the same tokens")
    params32 = _cast_floats(eng.params, torch.float32)
    out = run(params32, "float32")
    del params32
    a, b, c = out["pallas"], out["naive"], out["chunked"]
    err = dist(a, b)
    ok = bool(((a - b).abs() <= F32_DEPTH_TOL * (1 + b.abs())).all())
    print(f"  forward_prefill f32 (same weights) logits: pallas vs naive "
          f"max_abs {err:.4e}, chunked vs naive {dist(c, b):.4e} "
          f"(rtol=atol={F32_DEPTH_TOL}); argmax agreement {agree(a, b):.4f}")
    if not ok:
        raise AssertionError("f32 serve logits: kernel vs naive out of "
                             "tolerance")


KERNEL_MODULES = ("fleet_tick", "flash_attention", "rwkv6_wkv", "mamba2_ssd")


def _kernel_mods():
    import importlib

    return {n: importlib.import_module(f"repro_torch.kernels.{n}")
            for n in KERNEL_MODULES}


def _zero_counts() -> None:
    for mod in _kernel_mods().values():
        mod.LAUNCHES = 0


def _counts() -> dict:
    return {n: mod.LAUNCHES for n, mod in _kernel_mods().items()}


def _scaled_err(got, want) -> tuple[float, float]:
    """(max |got - want|, the scale max(1, max |want|)), in f32."""
    a, b = got.float(), want.float()
    if not torch.isfinite(a).all():
        raise AssertionError("non-finite kernel output")
    return float((a - b).abs().max()), max(1.0, float(b.abs().max()))


def _wkv_inputs(B, H, S, hd, dtype, dev, seed, logw="clip"):
    """Model-layout (B, S, H, hd) operands: r, k, v ~ N(0, 1) in ``dtype``;
    logw f32 log-uniform over the model's whole clip range [-8, -1e-6]
    (layers.py clamps it there) with both ends present, or all at one end
    (``logw`` = -8.0 or -1e-6); u ~ N(0, 1) f32."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device=dev)
    r, k, v = (mk(B, S, H, hd).to(dtype) for _ in range(3))
    if logw == "clip":
        lo, hi = np.log(1e-6), np.log(8.0)
        lw = -torch.exp(lo + (hi - lo) * torch.rand(
            (B, S, H, hd), generator=g, device=dev))
        lw.view(-1)[0], lw.view(-1)[-1] = -8.0, -1e-6
    else:
        lw = torch.full((B, S, H, hd), float(logw), device=dev)
    return r, k, v, lw, mk(H, hd)


def phase_wkv(dev, facts: str) -> dict:
    """The wkv kernel against the plain chunked wkv6_chunked (every shape)
    and the sequential rwkv6_wkv_ref (shorter S), on the same tensors, in
    the model layout the path gives it (strided (B,H,S,hd) views); then
    CUDA-event times at the main shape beside the bound."""
    from repro_torch.kernels import rwkv6_wkv as wkv
    from repro_torch.models.layers import wkv6_chunked

    bf16, f32 = torch.bfloat16, torch.float32
    bhsd = lambda *a: [x.transpose(1, 2) for x in a]
    # (label, B, H, S, hd, chunk, dtype, logw, sequential oracle too)
    shapes = [
        ("rwkv6-7b-train", 4, 64, 4096, 64, 32, bf16, "clip", False),
        ("rwkv6-7b-train", 4, 64, 4096, 64, 64, bf16, "clip", False),
        ("rwkv6-7b-train", 4, 64, 4096, 64, 32, f32, "clip", False),
        ("rwkv6-7b-train", 4, 64, 4096, 64, 64, f32, "clip", False),
        ("ragged", 2, 8, 1000, 64, 32, bf16, "clip", True),
        ("ragged", 2, 8, 1000, 64, 64, f32, "clip", True),
        ("S<chunk", 3, 4, 20, 64, 64, f32, "clip", True),
        ("logw=-8", 1, 8, 512, 64, 32, f32, -8.0, True),
        ("logw=-1e-6", 1, 8, 512, 64, 32, f32, -1e-6, True),
        ("reduced-hd32", 2, 4, 300, 32, 32, f32, "clip", True),
    ]
    main = None
    for i, (label, B, H, S, hd, ch, dt, lwr, seq) in enumerate(shapes):
        r, k, v, lw, u = _wkv_inputs(B, H, S, hd, dt, dev, seed=i, logw=lwr)
        o, sfin = wkv.rwkv6_wkv(*bhsd(r, k, v, lw), u, chunk=ch)
        oc, sc = wkv6_chunked(r, k, v, lw, u, chunk=ch)
        torch.cuda.synchronize()
        checks = [("chunked", o, oc.transpose(1, 2).to(dt), sfin, sc)]
        if seq:
            oq, sq = wkv.rwkv6_wkv_ref(*bhsd(r, k, v, lw), u)
            checks.append(("sequential", o, oq, sfin, sq))
        for name, a, b, sa, sb in checks:
            err, scale = _scaled_err(a, b)
            serr, sscale = _scaled_err(sa, sb)
            tol = WKV_TOL[dt]
            print(f"  {label} B={B} H={H} S={S} hd={hd} chunk={ch} "
                  f"{str(dt).removeprefix('torch.')} vs {name}: o max_abs "
                  f"{err:.3e} (scale {scale:.2f}, scaled {err / scale:.3e}, "
                  f"tol {tol}); S_fin max_abs {serr:.3e} (scale {sscale:.2f},"
                  f" scaled {serr / sscale:.3e}, tol {WKV_TOL[f32]})")
            if err / scale > tol or serr / sscale > WKV_TOL[f32]:
                raise AssertionError(f"wkv kernel vs {name} out of tolerance "
                                     f"at {label} chunk {ch} {dt}")
        # chunk is the f32 kernel's staging tile; the bf16 kernel has its own
        # (MMA_CHUNK), so it is timed once
        if label != "rwkv6-7b-train" or (dt == bf16 and ch != 32):
            continue
        run = lambda: wkv.rwkv6_wkv(*bhsd(r, k, v, lw), u, chunk=ch)
        ms, host_ms = _graph_ms(run, reps=20), _time_ms(run, reps=20,
                                                         warmup=2)
        plain_ms = _time_ms(lambda: wkv6_chunked(r, k, v, lw, u, chunk=ch),
                            reps=3, warmup=1)
        nbytes, flops = wkv.wkv_cost(B, H, S, hd, itemsize=r.element_size())
        peak = BF16_OPS_S if dt == bf16 else F32_OPS_S
        bound_ms, by = _bound(nbytes, flops, peak)
        print(f"    kernel device {ms:.4f} ms (host loop {host_ms:.4f} ms), "
              f"plain wkv6_chunked {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"by {by} ({nbytes / 1e9:.4f} GB, {flops / 1e9:.3f} GFLOP at "
              f"{peak / 1e12:.0f} TFLOP/s), {bound_ms / ms:.3f} of the bound "
              f"[{facts}]")
        if main is None:
            n = B * H * S
            dv = min(hd, wkv.MMA_VALUE_COLUMNS)
            splits = hd // dv
            print(f"    bf16 kernel: {B * H * splits} blocks of {dv // 8} "
                  f"warps, {wkv.mma_smem_bytes(hd, dv)} B of dynamic shared "
                  f"memory a block (the launch refuses any other size)")
            print(f"    exp count: the kernel {n * hd * splits} (one per token "
                  f"and key channel in each of {splits} value-column "
                  f"block(s); the decay factors are running products); the "
                  f"chunked form at chunk {ch} "
                  f"{n // ch * (ch * (ch - 1) // 2 + 3 * ch) * hd} (the "
                  f"C(C-1)/2 x hd intra-chunk decays and 3 C x hd more per "
                  f"chunk); no PyTorch call computes this function "
                  f"(library: none)")
            main = {"max_abs_err": err, "ms": ms, "ms_host_loop": host_ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": by, "library_ms": None}
        del r, k, v, lw, o, oc, sfin, sc
    return main


def _rwkv_walk(params, cfg, tokens, impl: str, check: bool = False):
    """The backbone walked as lm._rwkv_block composes its layers, with
    rwkv6_time_mix(..., impl=impl); with ``check``, each layer's time mix
    is also run with impl="chunked" on the same input and the scaled
    distance kept. Returns (final hidden states, per-layer distances)."""
    from repro_torch.models import layers as L
    from repro_torch.models.lm import _layers

    x = params["embed"][tokens]
    dists = []
    for p in _layers(params["layers"], cfg):
        hn = L.rmsnorm(p["tm_norm"], x, cfg.norm_eps)
        h, _ = L.rwkv6_time_mix(p, cfg, hn, impl=impl)
        if check:
            h_ref, _ = L.rwkv6_time_mix(p, cfg, hn, impl="chunked")
            err, scale = _scaled_err(h, h_ref)
            dists.append(err / scale)
            del h_ref
        x = x + h
        h, _ = L.rwkv6_channel_mix(p, cfg, L.rmsnorm(p["cm_norm"], x,
                                                     cfg.norm_eps))
        x = x + h
    return x, dists


def _masked_loss(logits, batch):
    from repro_torch.utils import softmax_cross_entropy

    ce = softmax_cross_entropy(logits, batch["labels"])
    return float((ce * batch["mask"]).sum() / batch["mask"].sum())


def _profile_pass(fn) -> None:
    """One call under torch.profiler: wall, device busy share, launches,
    and the device time by group and by kernel."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.device_time_total for e in rows)
    groups = {"wkv kernel": 0.0, "matmul (cuBLAS)": 0.0, "other": 0.0}
    for e in rows:
        key = e.key.lower()
        if "wkv_kernel" in key:
            groups["wkv kernel"] += e.device_time_total
        elif any(w in key for w in ("gemm", "nvjet", "cutlass", "xmma")):
            groups["matmul (cuBLAS)"] += e.device_time_total
        else:
            groups["other"] += e.device_time_total
    print(f"  profiled pass: wall {wall:.3f} s (profiler on), device busy "
          f"{busy_us / 1e6:.3f} s ({100 * busy_us / 1e6 / wall:.1f} %), "
          f"{sum(e.count for e in rows)} device launches; by group: " +
          ", ".join(f"{k} {v / 1e3:.3f} ms ({100 * v / max(busy_us, 1e-9):.1f}"
                    f" %)" for k, v in groups.items()))
    for e in sorted(rows, key=lambda e: e.device_time_total,
                    reverse=True)[:10]:
        print(f"    {e.device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:70]}")


def phase_rwkv(dev, facts: str, seed: int = 0) -> dict:
    """The RWKV-6 path at full rwkv6-7b width (see the module docstring),
    with weights and batch drawn from ``seed``."""
    from repro_torch.configs import rwkv6_7b
    from repro_torch.data.synthetic import make_batch
    from repro_torch.engine.engine import _cast_floats
    from repro_torch.models import lm

    cfg = rwkv6_7b.CONFIG
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.ssm_head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.dtype, cfg.wkv_chunk) == (
        32, 4096, 64, 64, 14336, 65536, "bfloat16", 32)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  before the model: {torch.cuda.memory_allocated() / 2**30:.3f} "
          f"GiB allocated")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_params(cfg,
                            torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"  {cfg.name}: {cfg.num_layers} layers, bf16, {n_params} parameters "
          f"drawn on the card in {time.perf_counter() - t0:.2f} s, "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    B, S = 4, 4096
    batch = make_batch(cfg, B, S, seed=seed, device=dev)
    toks = batch["tokens"]
    with torch.inference_mode():
        # forward_train, the reference's route: the plain chunked wkv
        walls = []
        for _ in range(2):  # the first call carries one-time set-up
            _zero_counts()
            t0 = time.perf_counter()
            loss_c, _ = lm.forward_train(params, cfg, batch)
            loss_c = float(loss_c)
            walls.append(time.perf_counter() - t0)
            train_counts = _counts()
        print(f"  forward_train (chunked wkv) loss {loss_c:.6f}; wall "
              f"{walls[1]:.3f} s ({walls[0]:.3f} s first), "
              f"{B * S / walls[1]:.1f} tokens/s; kernel launches "
              f"{train_counts}")
        if any(train_counts.values()):
            raise AssertionError("forward_train launched a kernel")
        _profile_pass(lambda: lm.forward_train(params, cfg, batch))
        # the kernel route: counts read around exactly this pass
        _zero_counts()
        x_k, dists = _rwkv_walk(params, cfg, toks, "pallas", check=True)
        torch.cuda.synchronize()
        counts = _counts()
        print(f"  kernel walk (rwkv6_time_mix impl=pallas): launches {counts} "
              f"(expected {cfg.num_layers} rwkv6_wkv); time mix vs chunked "
              f"per layer, scaled max_abs: max {max(dists):.3e} (layer "
              f"{int(np.argmax(dists))}), mean {np.mean(dists):.3e} (tol "
              f"{WKV_TOL[torch.bfloat16]})")
        if counts != {**{n: 0 for n in KERNEL_MODULES},
                      "rwkv6_wkv": cfg.num_layers}:
            raise AssertionError(f"kernel walk launches {counts}")
        if max(dists) > WKV_TOL[torch.bfloat16]:
            raise AssertionError("a layer's time mix: kernel vs chunked out "
                                 "of tolerance")
        logits_k = lm._logits(params, cfg, x_k)
        del x_k
        loss_k = _masked_loss(logits_k, batch)
        logits_c = lm._logits(params, cfg, lm._backbone(
            params, cfg, params["embed"][toks]))
        loss_cc = _masked_loss(logits_c, batch)
        cfg64 = dataclasses.replace(cfg, wkv_chunk=64)
        logits_64 = lm._logits(params, cfg64, lm._backbone(
            params, cfg64, params["embed"][toks]))
        loss_64 = _masked_loss(logits_64, batch)
        dist = lambda a, b: float((a.float() - b.float()).abs().max())
        d_k, floor = dist(logits_k, logits_c), dist(logits_64, logits_c)
        top2 = logits_c.float().topk(2, dim=-1).values
        robust = (top2[..., 0] - top2[..., 1]) > 2 * floor
        agree = lambda a, b: float((a.argmax(-1) == b.argmax(-1))
                                   .float().mean())
        same_robust = bool(torch.equal(logits_k.argmax(-1)[robust],
                                       logits_c.argmax(-1)[robust]))
        print(f"  bf16 logits (scale {float(logits_c.float().abs().max()):.3f}"
              f", {B * S} positions): kernel route vs forward_train's chunked "
              f"route max_abs {d_k:.4e}; chunk 64 vs chunk 32 {floor:.4e} (the "
              f"plain floor; ratio {d_k / max(floor, 1e-30):.3f}, limit "
              f"{BF16_DEPTH_FLOOR_X}); argmax agreement "
              f"{agree(logits_k, logits_c):.4f} (chunk 64 vs 32: "
              f"{agree(logits_64, logits_c):.4f}), equal on "
              f"all {int(robust.sum())} rows with a top-2 margin above twice "
              f"the floor: {same_robust}")
        print(f"  bf16 loss: kernel route {loss_k:.6f}, forward_train "
              f"{loss_c:.6f} (recomputed from the chunked route's logits: "
              f"{loss_cc:.6f}), chunk 64 {loss_64:.6f}; relative difference "
              f"{abs(loss_k - loss_c) / loss_c:.3e} (tol {RWKV_LOSS_RTOL})")
        del logits_k, logits_c, logits_64, top2, robust
        if d_k > BF16_DEPTH_FLOOR_X * floor or not same_robust:
            raise AssertionError("bf16 rwkv logits: the kernel route is "
                                 "farther from the chunked route than the "
                                 "plain floor allows")
        if abs(loss_k - loss_c) > RWKV_LOSS_RTOL * abs(loss_c) or \
                abs(loss_cc - loss_c) > 1e-6 * abs(loss_c):
            raise AssertionError("bf16 rwkv loss out of tolerance")
        # the path's speed: one timed pass and one profiled pass
        _zero_counts()
        t0 = time.perf_counter()
        x_k, _ = _rwkv_walk(params, cfg, toks, "pallas")
        loss_t = _masked_loss(lm._logits(params, cfg, x_k), batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if _counts()["rwkv6_wkv"] != cfg.num_layers:
            raise AssertionError("timed kernel pass: launches != 32")
        del x_k
        print(f"  kernel route forward + loss: wall {wall:.3f} s, "
              f"{B * S / wall:.1f} tokens/s (loss {loss_t:.6f}); peak device "
              f"memory {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
              f"[{facts}]")
        _profile_pass(lambda: _masked_loss(lm._logits(
            params, cfg, _rwkv_walk(params, cfg, toks, "pallas")[0]), batch))
        # forward_prefill's ssm branch: a state, so wkv6_chunked, no kernel
        _zero_counts()
        lp, st = lm.forward_prefill(params, cfg, {"tokens": toks},
                                    max_seq=S)
        torch.cuda.synchronize()
        pre_counts = _counts()
        ls = lm.score_last(params, cfg, toks)
        err, scale = _scaled_err(lp, ls)
        print(f"  forward_prefill (ssm branch): last-position logits vs "
              f"score_last (chunked backbone) max_abs {err:.3e} (scale "
              f"{scale:.2f}, tol {WKV_TOL[torch.bfloat16]}), bitwise "
              f"{bool(torch.equal(lp, ls))}; kernel launches {pre_counts} "
              f"(with a state the route falls back to wkv6_chunked, as in the "
              f"reference); state pos {int(st.pos)}, wkv state "
              f"{tuple(st.ssm['wkv'].shape)} finite "
              f"{bool(torch.isfinite(st.ssm['wkv']).all())}")
        if any(pre_counts.values()) or err / scale > WKV_TOL[torch.bfloat16] \
                or not torch.isfinite(st.ssm["wkv"]).all():
            raise AssertionError("forward_prefill (ssm) check failed")
        del lp, st, ls
    mem_bf16 = torch.cuda.max_memory_allocated()
    # the whole model in f32 on a copy of the same weights, at 2 x 2048
    params32 = _cast_floats(params, torch.float32)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    b32 = make_batch(cfg32, 2, 2048, seed=1, device=dev)
    with torch.inference_mode():
        _zero_counts()
        x_k, _ = _rwkv_walk(params32, cfg32, b32["tokens"], "pallas")
        n32 = _counts()["rwkv6_wkv"]
        a = lm._logits(params32, cfg32, x_k)
        del x_k
        loss32_c, _ = lm.forward_train(params32, cfg32, b32)
        b = lm._logits(params32, cfg32, lm._backbone(
            params32, cfg32, params32["embed"][b32["tokens"]]))
        ok = bool(((a - b).abs() <= F32_DEPTH_TOL * (1 + b.abs())).all())
        loss32_k = _masked_loss(a, b32)
        print(f"  f32 copy, 2 x 2048: logits kernel route vs chunked max_abs "
              f"{dist(a, b):.4e} (scale {float(b.abs().max()):.3f}, rtol=atol "
              f"{F32_DEPTH_TOL}); loss {loss32_k:.6f} vs forward_train "
              f"{float(loss32_c):.6f}; rwkv6_wkv launches {n32}")
        if not ok or n32 != cfg.num_layers or \
                abs(loss32_k - float(loss32_c)) > 1e-4 * float(loss32_c):
            raise AssertionError("f32 rwkv logits or loss out of tolerance")
    del params32, a, b
    print(f"  peak device memory: {mem_bf16 / 2**30:.3f} GiB (bf16 model "
          f"and checks), {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
          f"overall with the f32 copy")
    return {"launches": counts["rwkv6_wkv"]}


def _ssd_inputs(B, nh, S, hd, ns, dtype, dev, seed):
    """Operands as mamba2_mix feeds its scan: dt = softplus(N(0, 1)) per
    (token, head), A = -exp(U(0, log 16)) per head (Mamba2's A in [1, 16]),
    x = N(0, 1) dt (the Δ-scaled input), loga = dt A (f32), B and C
    ~ N(0, 1); x, B and C in ``dtype``."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device=dev)
    dt = torch.nn.functional.softplus(mk(B, nh, S))
    A = -torch.exp(np.log(16.0) * torch.rand((nh,), generator=g, device=dev))
    x = (mk(B, nh, S, hd) * dt[..., None]).to(dtype)
    return (x, mk(B, S, ns).to(dtype), mk(B, S, ns).to(dtype),
            dt * A[None, :, None])


def phase_ssd(dev, facts: str) -> dict:
    """The SSD kernel through ops.mamba2_ssd (its path, counted around the
    main-shape call), then against the plain chunked and sequential
    versions on the same tensors, and CUDA-event times beside the bound."""
    from repro_torch.kernels import mamba2_ssd as ssd
    from repro_torch.kernels import ops

    bf16, f32 = torch.bfloat16, torch.float32
    B, nh, S, hd, ns, ch = 4, 80, 4096, 64, 64, 128
    x, bm, cm, la = _ssd_inputs(B, nh, S, hd, ns, f32, dev, seed=0)
    torch.cuda.synchronize()
    _zero_counts()
    y = ops.mamba2_ssd(x, bm, cm, la, chunk=ch)
    torch.cuda.synchronize()
    counts = _counts()
    print(f"  ops.mamba2_ssd at zamba2-2.7b's mixer shape: launches {counts} "
          f"(expected 1 mamba2_ssd); y {tuple(y.shape)} finite "
          f"{bool(torch.isfinite(y).all())}")
    if counts != {**{n: 0 for n in KERNEL_MODULES}, "mamba2_ssd": 1}:
        raise AssertionError(f"ssd path launches {counts}")
    del x, bm, cm, la, y
    # (label, B, nh, S, hd, ns, chunk, dtype, sequential oracle too)
    shapes = [
        ("zamba2-mixer", 4, 80, 4096, 64, 64, 128, f32, False),
        ("zamba2-mixer", 4, 80, 4096, 64, 64, 64, f32, False),
        ("zamba2-mixer", 4, 80, 4096, 64, 64, 128, bf16, False),
        ("ragged", 2, 8, 1000, 64, 64, 128, f32, True),
        ("ragged", 2, 8, 1000, 64, 64, 128, bf16, True),
        ("S<chunk", 3, 4, 100, 64, 64, 128, f32, True),
        ("ns128", 1, 4, 300, 64, 128, 64, f32, True),
    ]
    main = None
    for i, (label, B, nh, S, hd, ns, ch, dt, seq) in enumerate(shapes):
        x, bm, cm, la = _ssd_inputs(B, nh, S, hd, ns, dt, dev, seed=i + 1)
        y = ssd.mamba2_ssd(x, bm, cm, la, chunk=ch)
        yc = ssd.mamba2_ssd_chunked(x, bm, cm, la, chunk=ch)
        torch.cuda.synchronize()
        checks = [("chunked", yc)]
        if seq:
            checks.append(("sequential", ssd.mamba2_ssd_ref(x, bm, cm, la)))
        for name, want in checks:
            err, scale = _scaled_err(y, want)
            print(f"  {label} B={B} nh={nh} S={S} hd={hd} ns={ns} chunk={ch} "
                  f"{str(dt).removeprefix('torch.')} vs {name}: max_abs "
                  f"{err:.3e} (scale {scale:.2f}, scaled {err / scale:.3e}, "
                  f"tol {SSD_TOL[dt]})")
            if err / scale > SSD_TOL[dt]:
                raise AssertionError(f"ssd kernel vs {name} out of tolerance "
                                     f"at {label} chunk {ch} {dt}")
        if label != "zamba2-mixer":
            continue
        ms = _time_ms(lambda: ssd.mamba2_ssd(x, bm, cm, la, chunk=ch),
                      reps=20, warmup=2)
        plain_ms = _time_ms(lambda: ssd.mamba2_ssd_chunked(x, bm, cm, la,
                                                           chunk=ch),
                            reps=5, warmup=1)
        nbytes, flops = ssd.ssd_cost(B, nh, S, hd, ns,
                                     itemsize=x.element_size())
        bound_ms, by = _bound(nbytes, flops, F32_OPS_S)
        print(f"    kernel {ms:.4f} ms, plain chunked {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms by {by} ({nbytes / 1e9:.4f} GB, "
              f"{flops / 1e9:.3f} GFLOP f32) [{facts}]")
        if main is None:
            print(f"    exp count: the kernel {B * nh * S} (one per token and "
                  f"head); no PyTorch call computes this function (library: "
                  f"none)")
            main = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": by, "library_ms": None}
        del x, bm, cm, la, y, yc
    return {"launches": counts["mamba2_ssd"], **main}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _build_all() -> None:
    """Every kernel library, one nvcc per source, all started together so
    that the build time does not grow with the number of kernels."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import build as kbuild

    root = Path(__file__).resolve().parent
    flags = {m.SOURCE: m.NVCC_FLAGS for m in _kernel_mods().values()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(flags)) as ex:
        libs = list(ex.map(lambda s: kbuild.build(s, flags[s], force=True),
                           flags))
    print(f"  {len(libs)} libraries built in {time.perf_counter() - t0:.1f} s")
    for src, lib in zip(flags, libs):
        print(f"  {lib.relative_to(root)}")
        for line in kbuild.BUILD_LOGS[src].strip().splitlines():
            print(f"  | {line}")
        for line in _ptxas_summary(kbuild.BUILD_LOGS[src]):
            print(f"  {src}: {line}")


def _ptxas_summary(log: str) -> list[str]:
    """One line per compiled kernel from ptxas's -v report: registers,
    spill stores/loads, stack frame and static shared memory (the dynamic
    shared memory is the wrapper's, printed where each kernel is timed)."""
    import re

    out, name, frame = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            frame = (f"stack {m.group(1)} B, spills {m.group(2)} B stored / "
                     f"{m.group(3)} B loaded")
            continue
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and name:
            out.append(f"{name}: {m.group(1)} registers, {frame}, "
                       f"{m.group(2) or 0} B static smem")
            name, frame = None, ""
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

    dev = torch.device("cuda")
    print("[1] facts")
    facts = _gpu_facts()
    print(f"  {facts}")
    print(f"  python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
          f"x{torch.cuda.device_count()}")
    print("[2] build")
    _build_all()
    print("[3] kernel against plain")
    row = phase_kernels(dev, facts)
    print("[4] main path")
    main_row = phase_main(dev, facts)
    print("[5] small-input check")
    phase_check(dev)
    print("[6] flash-attention kernel against plain")
    attn_row = phase_attention(dev, facts)
    print("[7] serve path")
    serve_row = phase_serve(dev, facts)
    print("[8] wkv kernel against plain")
    wkv_row = phase_wkv(dev, facts)
    print("[9] RWKV-6 path")
    rwkv_row = phase_rwkv(dev, facts)
    print("[10] SSD kernel through ops.mamba2_ssd, against plain")
    ssd_row = phase_ssd(dev, facts)
    kernels = [
        {"name": "fleet_tick_window", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fleet_tick.cu",
         "replaces": "src/repro/kernels/fleet_tick.py:387",
         "launches": main_row["launches"], **row, "library_ms": None},
        {"name": "flash_attention_bhsd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:88",
         "launches": serve_row["launches"], **attn_row},
        {"name": "rwkv6_wkv", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/rwkv6_wkv.cu",
         "replaces": "src/repro/kernels/rwkv6_wkv.py:81",
         "launches": rwkv_row["launches"], **wkv_row},
        {"name": "mamba2_ssd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/mamba2_ssd.cu",
         "replaces": "src/repro/kernels/mamba2_ssd.py:72", **ssd_row},
    ]
    for row in kernels:
        row["bound_frac"] = row["bound_ms"] / row["ms"]
    print(facts)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
