"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure raises and exits non-zero):

1. facts    the card's name and power limit (nvidia-smi), torch and CUDA
2. build    nvcc builds every kernel of both paths from the checkout's
            sources into build/kernels/ (one nvcc per source, all started
            together) and prints ptxas's report
3. kernels  fleet_tick against its plain PyTorch version on the card at the
            tuning path's shapes (and ragged / K>S ones), with the stated
            tolerance, then both timed with CUDA events beside the bound
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
            serve shape (bf16 and f32), SmolLM's heads with a ragged tail,
            a q_offset case and a full (non-causal) case, with the stated
            tolerances; CUDA-event times of kernel, plain version and
            scaled_dot_product_attention (the library yardstick, never on a
            path) beside the bound
7. serve    the serving path through its entry points: StreamEngine over
            the full Qwen2-7B config (28 layers, bf16, random weights from a
            seed, attn_impl="pallas"), a 640-event backlog of LocalEngine's
            default traffic drained in full micro-batches, then a short batch
            of 5 events; the attention kernel's launches must be 28 per
            forward pass. Then forward_prefill on the same weights and
            tokens with the kernel and with naive attention must agree

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


def _attn_inputs(B, Hq, Hkv, Sq, Skv, hd, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    mk = lambda *shape: torch.randn(shape, generator=g, device=dev).to(dtype)
    return mk(B, Hq, Sq, hd), mk(B, Hkv, Skv, hd), mk(B, Hkv, Skv, hd)


def phase_attention(dev, facts: str) -> dict:
    """The flash-attention kernel against its plain version on the same
    tensors, then CUDA-event times at each shape beside the bound."""
    from repro_torch.kernels import flash_attention as fa

    bf16, f32 = torch.bfloat16, torch.float32
    # (label, B, Hq, Hkv, Sq, Skv, hd, causal, q_offset, dtype)
    shapes = [
        ("qwen2-serve", 32, 28, 4, 64, 64, 128, True, 0, bf16),
        ("qwen2-serve", 32, 28, 4, 64, 64, 128, True, 0, f32),
        ("smollm-ragged", 8, 9, 3, 40, 40, 64, True, 0, f32),
        ("qwen2-offset", 2, 28, 4, 16, 80, 128, True, 64, bf16),
        ("full", 4, 8, 2, 50, 72, 32, False, 0, f32),
    ]
    main = None
    for i, (label, B, Hq, Hkv, Sq, Skv, hd, causal, off, dt) in enumerate(shapes):
        q, k, v = _attn_inputs(B, Hq, Hkv, Sq, Skv, hd, dt, dev, seed=i)
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
            raise AssertionError(f"flash_attention out of tolerance at {label}")
        ms = _time_ms(lambda: fa.flash_attention_bhsd(q, k, v, **kw))
        plain_ms = _time_ms(lambda: fa.flash_attention_bhsd_ref(q, k, v, **kw))
        nbytes, flops = fa.attention_cost(B, Hq, Hkv, Sq, Skv, hd, causal=causal,
                                          q_offset=off, itemsize=q.element_size())
        peak = BF16_OPS_S if dt == bf16 else F32_OPS_S
        t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / peak
        bound_ms = max(t_bytes, t_ops) * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        print(f"    kernel {ms * 1e3:.3f} us, plain {plain_ms * 1e3:.3f} us, "
              f"bound {bound_ms * 1e3:.3f} us by {by} ({nbytes / 1e6:.2f} MB, "
              f"{flops / 1e9:.4f} GFLOP) [{facts}]")
        if main is None:
            main = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": bound_ms, "bound_by": by,
                    "library_ms": _sdpa_ms(q, k, v, Hq // Hkv)}
            print(f"    scaled_dot_product_attention(is_causal=True, "
                  f"enable_gqa=True): {main['library_ms'] * 1e3:.3f} us "
                  f"(yardstick only, never on a path)")
    return main


def _sdpa_ms(q, k, v, group: int) -> float:
    """One PyTorch call computing the same function: causal GQA attention,
    the library's yardstick for the table."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = sdpa(q, k, v, is_causal=True, enable_gqa=True)
    want = sdpa(q, k.repeat_interleave(group, 1), v.repeat_interleave(group, 1),
                is_causal=True)
    torch.cuda.synchronize()
    assert out.shape == q.shape and torch.isfinite(out.float()).all()
    assert float((out.float() - want.float()).abs().max()) <= 3e-2
    return _time_ms(lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))


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
    fa.LAUNCHES = 0
    ft.LAUNCHES = 0
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
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import fleet_tick as ft

    root = Path(__file__).resolve().parent
    flags = {ft.SOURCE: ft.NVCC_FLAGS, fa.SOURCE: fa.NVCC_FLAGS}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(flags)) as ex:
        libs = list(ex.map(lambda s: kbuild.build(s, flags[s], force=True),
                           flags))
    print(f"  {len(libs)} libraries built in {time.perf_counter() - t0:.1f} s")
    for src, lib in zip(flags, libs):
        print(f"  {lib.relative_to(root)}")
        for line in kbuild.BUILD_LOGS[src].strip().splitlines():
            print(f"  | {line}")


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
    row = phase_kernels(dev)
    print("[4] main path")
    main_row = phase_main(dev, facts)
    print("[5] small-input check")
    phase_check(dev)
    print("[6] flash-attention kernel against plain")
    attn_row = phase_attention(dev, facts)
    print("[7] serve path")
    serve_row = phase_serve(dev, facts)
    kernels = [
        {"name": "fleet_tick_window", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/fleet_tick.cu",
         "replaces": "src/repro/kernels/fleet_tick.py:387",
         "launches": main_row["launches"], **row, "library_ms": None},
        {"name": "flash_attention_bhsd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/kernels/flash_attention.py:88",
         "launches": serve_row["launches"], **attn_row},
    ]
    print(facts)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
