"""The lean tick scan (``window_impl="scan"``) against the reference's
``backend="jax"``, on the CPU.

The port's scan arm is the lane-free ``fleet_scan`` kernel's plain version
(``tick_scan_ref``) plus the analytic window mean, the sampled p99 and the
analytic emitted latency columns. The reference's jax backend runs
``_tick_body`` under ``lax.scan`` with the same statistics; with its
threefry draws injected (``JaxDraws`` of tests/test_torch_window.py, which
replays the lane key in the scan's (T, N, Sp) layout), the two agree to f32
rounding: ``RTOL, ATOL = 2e-5, 1e-4`` (XLA fuses multiply-adds, and its
``erfinv`` differs from torch's in the last bits).

Covered: ``tick_scan_ref`` against ``lax.scan(_tick_body)`` on the same
xs; the observe window (``observe_stats`` and ``observe``); the fused
loop's ``build_step_window(window_impl="scan")``; a greedy fused episode
batch and one policy update on the scan; two exploring updates on each
side's own draws (tests/chaos_harness.py tolerances); the calibration
(``preferred_window_impl``) twins of the reference's three tests in
tests/test_fleet_jax.py; both launchers with ``--window-impl scan``; on a
card (``gpu``), the CUDA kernel bitwise against its plain version.
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.engine import FleetEnv  # noqa: E402
from repro_torch.engine import fleet_torch as fj  # noqa: E402
from repro_torch.kernels import fleet_scan as fs  # noqa: E402

try:  # the reference; absent where only the port is installed
    import jax
    import jax.numpy as jnp
    from repro.engine import FleetEnv as RefFleetEnv
    from repro.engine import fleet_jax as ref_fj
except ImportError:  # pragma: no cover - a port-only install
    jax = jnp = RefFleetEnv = ref_fj = None

needs_reference = pytest.mark.skipif(ref_fj is None,
                                     reason="needs jax and the reference")

METRICS = ["latency_p99_ms", "latency_mean_ms", "queue_depth", "device_util",
           "sched_queue_depth"]
LEVERS = ["max_batch_events", "prefetch_depth", "driver_memory_gb",
          "sink_partitions", "backup_tasks"]
MIX = ("poisson_low", "trapezoid", "yahoo_ads", "switching")
FROZEN = dict(split_after=10**9, extend_after=10**9, merge_after=10**9)
#: tests/test_torch_window.py's f32-allclose
RTOL, ATOL = 2e-5, 1e-4
KW = dict(noise=0.05, retention_s=60.0, straggler_prob=0.05, slo=1.5,
          shi=3.0)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _no_env_overrides(monkeypatch):
    """tests/test_kernels.py sets ``REPRO_PALLAS_INTERPRET`` at import,
    which every xdist worker inherits when it collects that module; the
    calibration reads ``REPRO_FLEET_IMPL``."""
    for var in ("REPRO_PALLAS_INTERPRET", "REPRO_REQUIRE_COMPILED",
                "REPRO_FLEET_IMPL"):
        monkeypatch.delenv(var, raising=False)


def _close(name, got, ref, rtol=RTOL, atol=ATOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=name)


def _scan_inputs(T, N, seed, *, fmult, partial):
    """Raw operands of one window: real packed constants of a heterogeneous
    fleet, seeded noise, rates that load some clusters past their retention
    cap, an optional chaos multiplier and a ragged ``active``."""
    env = FleetEnv.heterogeneous(N, seed=seed, mix=MIX, device="cpu")
    cc = {k: torch.as_tensor(v, dtype=torch.float32)
          for k, v in env.packed().items()}
    mc = {k: torch.as_tensor(v, dtype=torch.bool if v.dtype == bool
                             else torch.float32) for k, v in env.mc.items()}
    from repro_torch.kernels.fleet_tick import pack_tick_consts

    rng = np.random.default_rng(seed)
    f = lambda a: np.asarray(a, np.float32)
    n_ticks = rng.integers(T // 2, T + 1, N) if partial else np.full(N, T)
    ops = dict(
        state=f(np.stack([rng.uniform(0, 5e5, N), rng.uniform(0, 20, N)])),
        consts=pack_tick_consts(cc, mc, env.spec, env.chips).numpy(),
        rate=f(rng.uniform(5e3, 6e4, (T, N))),
        size=f(rng.uniform(0.001, 5.0, (T, N))),
        z=f(rng.standard_normal((T, N))),
        u_strag=f(rng.random((T, N))), u_raw=f(rng.random((T, N))),
        u_fail=f(rng.random((T, N))),
        active=f(np.arange(T)[:, None] < n_ticks[None, :]),
        fmult=(f(np.where(rng.random((T, N)) < 0.2,
                          rng.uniform(1.0, 4.0, (T, N)), 1.0))
               if fmult else None))
    return ops


def _ref_scan(ops):
    """The reference: its (T, N) prep, then ``lax.scan(_tick_body)``."""
    import functools

    c = jnp.asarray(ops["consts"])
    (T_b, max_b, a_comp, c_coll, b_mem, kvp, ovh, slow_cap, backup,
     fail_frac, inflight) = tuple(c[i] for i in range(11))
    g = {k: jnp.asarray(v) for k, v in ops.items() if v is not None}
    slo, shi = KW["slo"], KW["shi"]
    smask = g["u_strag"] < KW["straggler_prob"]
    raw = slo + (shi - slo) * g["u_raw"]
    slow = jnp.where(smask, jnp.where(backup != 0, 1.1,
                                      jnp.minimum(raw, slow_cap)), 1.0)
    fmask = g["u_fail"] < fail_frac
    slow = jnp.where(fmask, slow * 2.0, slow)
    if "fmult" in g:
        slow = slow * g["fmult"]
    rg, sg = g["rate"], g["size"]
    arr = jnp.maximum(rg * T_b * (1.0 + KW["noise"] * g["z"]), 0.0)
    xs = (arr, rg * KW["retention_s"], slow, sg * 16.0,
          1.0 / jnp.maximum(rg, 1.0), g["active"] != 0)
    body = functools.partial(ref_fj._tick_body, T_b=T_b, max_b=max_b,
                             a_comp=a_comp, c_coll=c_coll, b_mem=b_mem,
                             kvp=kvp, ovh=ovh, inflight=inflight)
    (b, s), ys = jax.lax.scan(body, (g["state"][0], g["state"][1]), xs)
    return (b, s), ys, smask, fmask


@needs_reference
@pytest.mark.parametrize("fmult,partial", [(False, False), (True, True),
                                           (False, True)])
def test_tick_scan_ref_matches_the_reference_scan(fmult, partial):
    ops = _scan_inputs(48, 40, seed=5, fmult=fmult, partial=partial)
    (rb, rs), rys, smask, fmask = _ref_scan(ops)
    t = {k: None if v is None else torch.from_numpy(v) for k, v in ops.items()}
    state, ys = fs.fleet_scan(*t.values(), **KW)       # CPU: the plain version
    assert ys.shape == (7, 48, 40) and state.shape == (2, 40)
    _close("backlog", state[0], rb)
    _close("sfree", state[1], rs)
    for name, row, ref in zip(("service", "qd", "batch", "processed",
                               "backlog_after"), (0, 1, 2, 3, 6), rys):
        _close(name, ys[row], ref)
    _close("straggler", ys[4], smask.astype(np.float32), rtol=0, atol=0)
    _close("failure", ys[5], fmask.astype(np.float32), rtol=0, atol=0)
    if partial:   # inactive ticks hold the carry
        assert (ops["active"] == 0).any()


def test_wrapper_runs_the_plain_version_on_the_cpu():
    ops = _scan_inputs(8, 5, seed=1, fmult=True, partial=True)
    t = [None if v is None else torch.from_numpy(v) for v in ops.values()]
    before = fs.LAUNCHES
    a = fs.fleet_scan(*t, **KW)
    b = fs.tick_scan_ref(*t, **KW)
    assert fs.LAUNCHES == before              # no kernel on a CPU tensor
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    nbytes, ops_ = fs.scan_cost(48, 1024)
    assert nbytes == 4 * 1024 * (2 + 11 + 15 * 48 + 2)   # ~60 T N bytes
    assert ops_ == 48 * 1024 * fs.TICK_OPS


def _fleets(n, seed=0, impl="scan"):
    ref = RefFleetEnv.heterogeneous(n, seed=seed, mix=MIX, backend="jax")
    port = FleetEnv.heterogeneous(n, seed=seed, mix=MIX, device="cpu",
                                  window_impl=impl)
    return ref, port


@needs_reference
def test_observe_stats_and_observe_match_the_jax_backend():
    """The engine's observe window on the scan (one ``fleet_scan`` call,
    all 90 metrics) on the reference's draws: a stabilisation preroll,
    then a window carrying the device state, then the window views."""
    from test_torch_window import JaxDraws

    ref_env, env = _fleets(8, seed=3)
    assert env.window_impl == "scan"
    env._dev.draws = JaxDraws(ref_env._dev._key)
    stabs = np.linspace(30.0, 180.0, 8)
    for preroll in (stabs, None):
        r = ref_env.observe_stats(240.0, preroll_s=preroll)
        p = env.observe_stats(240.0, preroll_s=preroll)
        for k in ("mean_ms", "p99_ms", "processed", "per_node"):
            _close(k, p[k], r[k])
        np.testing.assert_allclose(env.clock, ref_env.clock, rtol=1e-12)
        _close("backlog", env._dev._backlog, ref_env._dev._backlog)
    rw, pw = ref_env.observe(240.0), env.observe(240.0)
    for a, b in zip(pw, rw):
        assert a.p99_ms == pytest.approx(b.p99_ms, rel=RTOL)
        assert a.mean_ms == pytest.approx(b.mean_ms, rel=RTOL)
        assert a.processed_events == pytest.approx(b.processed_events,
                                                   rel=RTOL)
        _close("node_matrix", a.node_matrix, b.node_matrix)
        _close("latencies", a.latencies_ms, b.latencies_ms)


@needs_reference
@pytest.mark.parametrize("n,shared_noise,slo_ms", [
    (8, False, 0.0),      # per-node emission noise (N <= 256)
    (8, True, 2000.0),    # shared per-cluster noise + the SLO breach term
])
def test_step_window_matches_the_jax_backend(n, shared_noise, slo_ms):
    from test_torch_window import JaxWindow

    from repro.data.workloads import pack_device_workloads as ref_pack

    ref_env, env = _fleets(n, impl="kernel")   # the keyword picks the scan
    if shared_noise:
        ref_env._dev.node_noise = False
        env._dev.node_noise = False
    sel = tuple(env.metric_names.index(m) for m in METRICS)
    T, E = 24, 4
    ref_step = jax.jit(ref_fj.build_step_window(ref_env, sel, T, E,
                                                pallas=False, slo_ms=slo_ms))
    step = fj.build_step_window(env, sel, T, E, slo_ms=slo_ms,
                                window_impl="scan")
    rng = np.random.default_rng(n)
    backlog = rng.uniform(0, 3e5, n).astype(np.float32)
    sfree = rng.uniform(0, 20, n).astype(np.float32)
    clock = rng.uniform(0, 5e3, n).astype(np.float32)
    stab = rng.uniform(30, 120, n).astype(np.float32)
    reconf = rng.integers(0, 5, n).astype(np.float32)
    cc = {k: np.asarray(v, np.float32) for k, v in env.packed().items()}
    wl = ref_pack(ref_env.workloads).asdict()
    key = jax.random.PRNGKey(n)
    (rb, rs, rc), rstats = ref_step(
        key, jnp.asarray(backlog), jnp.asarray(sfree), jnp.asarray(clock),
        {k: jnp.asarray(v) for k, v in cc.items()},
        {k: jnp.asarray(v) for k, v in wl.items()}, jnp.asarray(stab),
        jnp.asarray(reconf), 120.0)
    tt = torch.from_numpy
    before = fs.LAUNCHES
    (b, s, c), stats = step(
        JaxWindow(key), tt(backlog), tt(sfree), tt(clock),
        {k: tt(v) for k, v in cc.items()}, {k: tt(v) for k, v in wl.items()},
        tt(stab), tt(reconf), 120.0)
    assert fs.LAUNCHES == before
    _close("backlog", b, rb)
    _close("sfree", s, rs)
    _close("clock", c, rc)
    for k in ("mean_ms", "p99_ms", "processed", "per_node") + (
            ("breach_frac",) if slo_ms else ()):
        _close(k, stats[k], rstats[k])
    with pytest.raises(ValueError, match="auto"):
        fj.build_step_window(env, sel, T, E, window_impl="auto")


def _pair(n, *, seed=0, steps=3, **over):
    from repro.core import Configurator as RefConfigurator
    from repro_torch.core import Configurator

    ref_env, env = _fleets(n, seed=seed)
    kw = dict(seed=seed, steps_per_episode=steps, window_s=240.0,
              device_loop="on", bin_kw=FROZEN)
    kw.update(over)
    ref = RefConfigurator(ref_env, METRICS, LEVERS, mesh="off", **kw)
    port = Configurator(env, METRICS, LEVERS, **kw)
    return ref_env, ref, env, port


@needs_reference
@pytest.mark.parametrize("over", [{}, {"reward_mode": "slo"}],
                         ids=["default", "slo-reward"])
def test_greedy_batch_and_one_update_match_the_jax_backend(over):
    """A greedy fused episode batch on the scan with the reference's draws
    injected, then one policy update on each side's own batch."""
    from test_torch_window import JaxDraws

    from repro_torch.core import policy as pol

    ref_env, ref, env, port = _pair(8, **over)
    port.agent.load_reference_params(
        {k: np.asarray(v) for k, v in ref.agent.params.items()})
    env._dev.draws = JaxDraws(ref_env._dev._key)
    rb, rrec = ref.run_fleet_episodes_device(explore=False)
    pb, prec = port.run_fleet_episodes_device(explore=False)
    np.testing.assert_array_equal(pb["actions"].numpy(),
                                  np.asarray(rb["actions"]))
    np.testing.assert_allclose(pb["states"].numpy(), np.asarray(rb["states"]),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(pb["rewards"].numpy(),
                               np.asarray(rb["rewards"]), rtol=RTOL, atol=0.0)
    assert len(prec) == len(rrec) == 8 * 3
    for a, b in zip(prec, rrec):
        assert a.lever == b.lever and a.direction == b.direction
        assert a.config == b.config
        assert a.p99_ms == pytest.approx(b.p99_ms, rel=RTOL)
        assert a.clock_s == pytest.approx(b.clock_s, rel=1e-6)
    _close("backlog", env._dev._backlog, ref_env._dev._backlog)
    assert env.current_configs() == ref_env.current_configs()
    # one update on each side's own batch
    mask = np.ones(pb["actions"].shape, np.float32)
    r_params, _, r_loss, _ = ref.agent._update_jit(
        ref.agent.params, ref.agent.opt_state, rb["states"], rb["actions"],
        rb["rewards"], jnp.asarray(mask))
    stats = port.agent.update_batch(pb["states"].numpy(),
                                    pb["actions"].numpy(),
                                    pb["rewards"].numpy(), mask)
    assert stats["pg_loss"] == pytest.approx(float(r_loss), rel=1e-4)
    for rname, (name, transpose) in pol._REF_NAMES.items():
        got = port.agent.params[name].detach().numpy()
        _close(rname, got.T if transpose else got, r_params[rname],
               atol=1e-6)


@needs_reference
def test_exploring_updates_statistically_match_the_jax_backend():
    """Two exploring ``run_update``s per side on a stable-regime fleet, the
    port on the scan and its own Philox draws, the reference on its jax
    backend and threefry: the chaos-harness tolerances."""
    from chaos_harness import assert_loop_equivalent

    from repro.core import Configurator as RefConfigurator
    from repro.data.workloads import PoissonWorkload, SwitchingWorkload
    from repro_torch.core import Configurator
    from repro_torch.data.workloads import PoissonWorkload as TPoisson
    from repro_torch.data.workloads import SwitchingWorkload as TSwitching

    def fleet(P, S, n):
        return [P(10_000, 0.5) if i % 2 == 0 else
                S(P(6_000, 0.5), P(12_000, 0.5), period_s=700.0 + 60.0 * i)
                for i in range(n)]

    n = 24
    ref_env = RefFleetEnv(fleet(PoissonWorkload, SwitchingWorkload, n),
                          seeds=list(range(n)), backend="jax")
    env = FleetEnv(fleet(TPoisson, TSwitching, n), seeds=list(range(n)),
                   device="cpu", window_impl="scan")
    kw = dict(seed=0, steps_per_episode=3, window_s=240.0, device_loop="on",
              bin_kw=FROZEN)
    ref = RefConfigurator(ref_env, METRICS, LEVERS, mesh="off", **kw)
    port = Configurator(env, METRICS, LEVERS, **kw)
    w0 = port.agent.policy.l2.weight.detach().clone()
    for _ in range(2):
        ref.run_update()
        st = port.run_update()
    assert st["episodes"] == n and st["steps"] == n * 3
    assert not torch.equal(w0, port.agent.policy.l2.weight)
    r = np.array([x.reward for x in port.history])
    p = np.array([x.p99_ms for x in port.history])
    assert np.isfinite(r).all() and (p > 0).all()
    assert_loop_equivalent(np.array([x.reward for x in ref.history]),
                           np.array([x.p99_ms for x in ref.history]), r, p)


def test_fused_loop_keys_and_replays_carry_the_impl():
    """The fused loop's static bundle and step-window cache carry the
    env's resolved impl (the reference's skey carries ``pallas``)."""
    from repro_torch.core import Configurator

    env = FleetEnv.heterogeneous(4, seed=0, mix=MIX, device="cpu",
                                 window_impl="scan")
    cfgr = Configurator(env, METRICS, LEVERS, device="cpu",
                        steps_per_episode=2, device_loop="on", bin_kw=FROZEN)
    cfgr.run_update()
    runner = cfgr._runner
    assert runner._skey(False, False)[-1] == "scan"
    assert runner._step_windows and all(k[-1] == "scan"
                                        for k in runner._step_windows)


# ------------------------------------------------------------ calibration
def test_calibration_verdict_computed_once_per_bucket(monkeypatch):
    """The twin of tests/test_fleet_jax.py's: one measurement per (device
    type, fleet-size bucket), every later call in the bucket a dict hit."""
    calls = []
    real = fj.window_impl_timings
    monkeypatch.setattr(fj, "window_impl_timings",
                        lambda N, T=32, reps=5, device=None: calls.append(N)
                        or real(N, T, reps=1, device=device))
    monkeypatch.setattr(fj, "_IMPL_CACHE", {})
    v1 = fj.preferred_window_impl(6, device="cpu")
    assert v1 in ("kernel", "scan") and len(calls) == 1
    for n in (6, 7, 5):
        assert fj.preferred_window_impl(n, device="cpu") == v1
    assert len(calls) == 1
    assert fj._IMPL_CACHE == {("cpu", fj._bucket(6)): v1}
    # an "auto" fleet resolves once, at construction, from the cache
    env = FleetEnv(n=5, device="cpu", window_impl="auto")
    assert env.window_impl == v1 and len(calls) == 1


def test_calibration_override_wins_without_measuring(monkeypatch):
    """``REPRO_FLEET_IMPL`` short-circuits before the cache and the probe
    (``pallas`` is the reference's name of ``"kernel"``); a bogus value
    falls through to the probe."""
    class ProbeRan(RuntimeError):
        pass

    def _probe(*a, **k):
        raise ProbeRan

    monkeypatch.setattr(fj, "window_impl_timings", _probe)
    monkeypatch.setattr(fj, "_IMPL_CACHE", {"poisoned": "scan"})
    for forced, want in (("pallas", "kernel"), ("kernel", "kernel"),
                         ("scan", "scan")):
        monkeypatch.setenv("REPRO_FLEET_IMPL", forced)
        assert fj.preferred_window_impl(6, device="cpu") == want
        assert FleetEnv(n=2, device="cpu",
                        window_impl="auto").window_impl == want
    assert fj._IMPL_CACHE == {"poisoned": "scan"}   # untouched
    monkeypatch.setenv("REPRO_FLEET_IMPL", "bogus")
    with pytest.raises(ProbeRan):
        fj.preferred_window_impl(6, device="cpu")


def test_calibration_cleared_cache_remeasures(monkeypatch):
    """A cleared ``_IMPL_CACHE`` re-measures, and ``calibrate_window_impl``
    always does: its verdict and timings are the same sample."""
    calls = []
    real = fj.window_impl_timings
    monkeypatch.setattr(fj, "window_impl_timings",
                        lambda N, T=32, reps=5, device=None: calls.append(N)
                        or real(N, T, reps=1, device=device))
    monkeypatch.setattr(fj, "_IMPL_CACHE", {})
    fj.preferred_window_impl(4, device="cpu")
    fj._IMPL_CACHE.clear()
    fj.preferred_window_impl(4, device="cpu")
    assert len(calls) == 2
    verdict, timings = fj.calibrate_window_impl(4, device="cpu")
    assert len(calls) == 3
    assert set(timings) == {"kernel", "scan"}
    assert all(t > 0 for t in timings.values())
    assert verdict == ("kernel" if timings["kernel"] <= timings["scan"]
                       else "scan")


def test_window_impl_is_validated_and_defaults_to_the_kernel():
    env = FleetEnv(n=2, device="cpu")
    assert env.window_impl == "kernel"
    with pytest.raises(ValueError, match="window_impl"):
        FleetEnv(n=2, device="cpu", window_impl="jax")
    if not torch.cuda.is_available():   # no CPU path taken without a card
        with pytest.raises(RuntimeError, match="CUDA"):
            fj.preferred_window_impl(10_000)


# -------------------------------------------------------------- launchers
def test_tune_launcher_runs_on_the_scan(tmp_path, capsys):
    from repro_torch.launch import tune

    out = tmp_path / "t"
    tune.main(["--device", "cpu", "--fleet", "4", "--collect", "40",
               "--updates", "1", "--steps-per-episode", "2",
               "--window-impl", "scan", "--out", str(out)])
    log = capsys.readouterr().out
    assert "scan window" in log and "ACTIVE" in log
    for f in ("analysis.json", "history.json"):
        json.loads((out / f).read_text())


def test_serve_launcher_runs_on_the_scan_by_default(tmp_path, capsys):
    from repro_torch.launch import serve

    out = tmp_path / "s"
    argv = ["--cycles", "1", "--quick", "--fleet", "2", "--device", "cpu",
            "--out", str(out)]
    serve.main(argv + ["--window-impl", "scan"])
    log = capsys.readouterr().out
    assert "window scan" in log and "ACTIVE" in log
    assert "repro_serve_cycles_total 1" in (out / "metrics.prom").read_text()
    serve.main(argv + ["--resume"])             # the default is the scan
    log = capsys.readouterr().out
    assert "window scan" in log and "[resume] restored" in log
    assert "repro_serve_cycles_total 2" in (out / "metrics.prom").read_text()


# ------------------------------------------------------------------ card
@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version_on_the_card():
    """Builds ``csrc/fleet_scan.cu`` and holds the kernel bitwise against
    its plain version on CUDA tensors: ragged N (not a multiple of the
    block), a window not a multiple of the unroll, with and without
    ``fmult``, partial ``active``; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for T, N, fmult, partial in ((48, 1024, True, True),
                                 (48, 1024, False, False), (7, 80, True, True),
                                 (1, 13, False, True), (770, 1000, True, True)):
        ops = _scan_inputs(T, N, seed=T + N, fmult=fmult, partial=partial)
        t = [None if v is None else torch.from_numpy(v).cuda()
             for v in ops.values()]
        before = fs.LAUNCHES
        got = fs.fleet_scan(*t, **KW)
        torch.cuda.synchronize()
        assert fs.LAUNCHES == before + 1
        ref = fs.tick_scan_ref(*t, **KW)
        for a, b in zip(got, ref):
            assert torch.equal(a, b), (T, N, fmult, partial)



def test_each_kernel_module_imports_first_in_a_fresh_process():
    """chip_smoke.py imports the kernel modules before anything else of the
    port: each must import first (fleet_tick's import of the engine reaches
    the captured programs, which import fleet_scan)."""
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    for name in ("fleet_tick", "fleet_scan", "lasso_cd", "flash_attention",
                 "rwkv6_wkv", "mamba2_ssd"):
        code = (f"import sys; sys.path.insert(0, {str(src)!r}); "
                f"import repro_torch.kernels.{name}")
        out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, (name, out.stderr[-2000:])
