"""The torch fleet engine's observation window against the reference's
pallas-backend window, on identical draws.

The reference draws every random number from a threefry key tree; the port
asks a draw source for the same draws by the same addresses
(``repro_torch.engine.draws``). ``JaxDraws`` below is such a source built
from jax: it replays the reference's keys, so the port's window sees the
reference's bits and the two must agree to f32 rounding (f32-allclose: XLA
may fuse multiply-adds and its ``erfinv`` differs from torch's in the last
bits).

Covered: ``build_step_window`` (the fused loop's window, kernel path) with
per-node and shared emission noise and with the SLO breach term,
``DeviceFleetEngine.observe_fleet`` (the engine's observe window), and
``workload_rate_grid`` for every leaf kind, including switching.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.data.workloads import pack_device_workloads as ref_pack  # noqa: E402
from repro.engine import FleetEnv as RefFleetEnv  # noqa: E402
from repro.engine import fleet_jax as ref_fj  # noqa: E402
from repro_torch.engine import FleetEnv  # noqa: E402
from repro_torch.engine import fleet_torch as fj  # noqa: E402

METRICS = ["latency_p99_ms", "latency_mean_ms", "queue_depth", "device_util",
           "sched_queue_depth"]
MIX = ("poisson_low", "trapezoid", "yahoo_ads", "switching")
#: f32-allclose: the same f32 formulas, but XLA fuses multiply-adds and the
#: two erfinv implementations differ by a few ulp; window statistics sum
#: and interpolate over those (measured worst ~1e-6 relative)
RTOL, ATOL = 2e-5, 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_compiled_tier(monkeypatch):
    """Pin the reference's kernel tier to its compiled CPU tier (the port's
    CPU shapes follow it): tests/test_kernels.py sets
    ``REPRO_PALLAS_INTERPRET`` at import, which every xdist worker inherits
    when it collects that module."""
    monkeypatch.delenv("REPRO_PALLAS_INTERPRET", raising=False)
    monkeypatch.delenv("REPRO_REQUIRE_COMPILED", raising=False)


def _bits(x) -> "torch.Tensor":
    return torch.from_numpy(np.asarray(x).astype(np.int64))


@functools.partial(jax.jit, static_argnums=1)
def _flat_bits(key, n):
    return jax.random.bits(key, (n,), jnp.uint32)


def _draw_bits(key, shape) -> "torch.Tensor":
    """``jax.random.bits(key, shape)`` as int64. Partitionable threefry
    counts by flat index, so the bits of any shape are a prefix of a longer
    flat draw: a few power-of-two draw sizes (one compile each) serve every
    shape instead of one compile per shape."""
    shape = tuple(shape)
    if not jax.config.jax_threefry_partitionable:
        return _bits(jax.random.bits(key, shape, jnp.uint32))
    m = math.prod(shape)
    n = max(1024, 1 << (m - 1).bit_length())
    return _bits(_flat_bits(key, n)[:m].reshape(shape))


class JaxWindow:
    """One window's draws from a threefry key, split like the reference's
    window program: (tick, lane, emission)."""

    def __init__(self, key):
        self.k_tick, self.k_lane, self.k_emit = jax.random.split(key, 3)

    def tick_bits(self, T, N):
        return _draw_bits(self.k_tick, (T, 2, N))

    def lane_bits(self, T, S, N):
        return _draw_bits(self.k_lane, (T, S, N))

    def p99_bits(self, T, N, Sp):
        # the jax backend's sampled p99 lanes: the lane key, (T, N, Sp)
        return _draw_bits(self.k_lane, (T, N, Sp))

    def emit_bits(self, shape):
        return _draw_bits(self.k_emit, shape)


class JaxStep:
    """One fused-loop step's draws: the reference splits the step key into
    act / load / window keys."""

    def __init__(self, key):
        self.k_act, self.k_load, self.k_win = jax.random.split(key, 3)

    def act(self, N, A):
        k_full, k_sub, k_gate = jax.random.split(self.k_act, 3)
        t = lambda x: torch.from_numpy(np.array(x, np.float32))
        return (t(jax.random.gumbel(k_full, (N, A))),
                t(jax.random.gumbel(k_sub, (N, 2))),
                t(jax.random.uniform(k_gate, (N,))))

    def load(self, N):
        return torch.from_numpy(np.array(jax.random.normal(self.k_load, (N,)),
                                         np.float32))

    def window(self):
        return JaxWindow(self.k_win)


class JaxEpisode:
    def __init__(self, key, shard=0):
        # the reference program folds the shard's ordinal first (the
        # unsharded program folds 0)
        self.key = jax.random.fold_in(key, shard)

    def step(self, t):
        return JaxStep(jax.random.fold_in(self.key, t))


class JaxDraws:
    """Draw source replaying a reference ``DeviceFleetEngine``'s key stream
    (one ``fold_in(key, counter)`` per window or episode batch)."""

    def __init__(self, key, draws: int = 0):
        self.key = key
        self.n = draws

    def _next(self):
        k = jax.random.fold_in(self.key, self.n)
        self.n += 1
        return k

    def window(self):
        return JaxWindow(self._next())

    def episode(self):
        return JaxEpisode(self._next())

    def for_shard(self, shard):
        """Fleet-mesh shard ``shard``'s draws: the same key stream, the
        shard's ordinal folded into each episode key. Every rank's source
        advances its counter once a batch, so the ranks stay in step."""
        if shard == 0:
            return self
        return JaxShard(self, shard)


class JaxShard:
    def __init__(self, src, shard):
        self.src, self.shard = src, shard

    def window(self):
        return self.src.window()

    def episode(self):
        return JaxEpisode(self.src._next(), self.shard)


def _close(name, got, ref, rtol=RTOL, atol=ATOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=name)


def _fleets(n, seed=0):
    ref = RefFleetEnv.heterogeneous(n, seed=seed, mix=MIX, backend="pallas")
    port = FleetEnv.heterogeneous(n, seed=seed, mix=MIX, backend="torch",
                                  device="cpu")
    return ref, port


@pytest.mark.parametrize("n,shared_noise,slo_ms", [
    (8, False, 0.0),      # per-node emission noise (N <= 256)
    (8, True, 2000.0),    # shared per-cluster noise (forced, as for
                          # N > 256) + the SLO breach-duration term
])
def test_step_window_matches_reference(n, shared_noise, slo_ms):
    ref_env, env = _fleets(n)
    if shared_noise:
        ref_env._dev.node_noise = False
        env._dev.node_noise = False
    sel = tuple(env.metric_names.index(m) for m in METRICS)
    T, E = 24, 4        # a 120 s window + up to 120 s of preroll
    ref_step = jax.jit(ref_fj.build_step_window(ref_env, sel, T, E,
                                                pallas=True, slo_ms=slo_ms))
    step = fj.build_step_window(env, sel, T, E, slo_ms=slo_ms)
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
    (b, s, c), stats = step(
        JaxWindow(key), tt(backlog), tt(sfree), tt(clock),
        {k: tt(v) for k, v in cc.items()}, {k: tt(v) for k, v in wl.items()},
        tt(stab), tt(reconf), 120.0)
    _close("backlog", b, rb)
    _close("sfree", s, rs)
    _close("clock", c, rc)
    for k in ("mean_ms", "p99_ms", "processed", "per_node") + (
            ("breach_frac",) if slo_ms else ()):
        _close(k, stats[k], rstats[k])
    assert stats["per_node"].shape == (n, env.n_nodes, len(METRICS))


def test_observe_stats_matches_reference():
    """The engine's observe window (one kernel launch, all 90 metrics) on
    the reference's draws: a stabilisation preroll, then a second window
    carrying the device state."""
    ref_env, env = _fleets(8, seed=3)
    env._dev.draws = JaxDraws(ref_env._dev._key)
    stabs = np.linspace(30.0, 180.0, 8)
    for preroll in (stabs, None):
        r = ref_env.observe_stats(240.0, preroll_s=preroll)
        p = env.observe_stats(240.0, preroll_s=preroll)
        for k in ("mean_ms", "p99_ms", "processed", "per_node"):
            _close(k, p[k], r[k])
        np.testing.assert_allclose(env.clock, ref_env.clock, rtol=1e-12)


def test_observe_windows_expose_the_window_views():
    """``observe`` hands out per-cluster window views over the same device
    results (lazy numpy, a host-drawn latency sample from the mixture)."""
    _, env = _fleets(4)
    wins = env.observe(240.0)
    stats = env._dev.last_stats
    assert len(wins) == 4
    for i, w in enumerate(wins):
        assert w.node_matrix.shape == (env.n_nodes, len(env.metric_names))
        assert w.p99_ms == pytest.approx(float(stats["p99_ms"][i]))
        assert w.latencies_ms.size > 0 and np.isfinite(w.latencies_ms).all()
        assert w.per_node["queue_depth"].shape == (env.n_nodes,)


def test_workload_rate_grid_matches_reference_for_every_leaf_kind():
    from repro.data.workloads import (PoissonWorkload, SwitchingWorkload,
                                      TrapezoidWorkload, YahooAdsWorkload)

    wls = [PoissonWorkload(10_000, 0.5), TrapezoidWorkload(),
           YahooAdsWorkload(),
           SwitchingWorkload(PoissonWorkload(6_000, 0.5),
                             TrapezoidWorkload(peak=9_000), period_s=700.0),
           SwitchingWorkload(YahooAdsWorkload(), PoissonWorkload(12_000, 5.0),
                             period_s=333.0)]
    wl = ref_pack(wls).asdict()
    times = np.random.default_rng(0).uniform(0, 1e4, (16, len(wls))) \
        .astype(np.float32)
    r_rate, r_size = ref_fj.workload_rate_grid(
        {k: jnp.asarray(v) for k, v in wl.items()}, jnp.asarray(times))
    rate, size = fj.workload_rate_grid(
        {k: torch.from_numpy(v) for k, v in wl.items()},
        torch.from_numpy(times))
    _close("rate", rate, r_rate, rtol=1e-6, atol=0.0)
    _close("size", size, r_size, rtol=0.0, atol=0.0)
    # the numpy host twin agrees too (f64 law, so f32-close)
    h_rate, _ = ref_pack(wls).rates(times.astype(np.float64))
    _close("rate vs host", rate, h_rate, rtol=1e-5, atol=0.0)


def test_switch_regime_of_a_non_switching_row_is_slot_a():
    """``period = inf`` pins slot A: ``(t // inf) % 2`` is 0 in torch."""
    t = torch.tensor([0.0, 1.0, 12345.0, 3.0e7])
    assert torch.equal((t // float("inf")) % 2.0, torch.zeros(4))


def test_rng_helpers_match_reference():
    bits = jax.random.bits(jax.random.PRNGKey(1), (64, 33), jnp.uint32)
    assert torch.equal(_draw_bits(jax.random.PRNGKey(1), (64, 33)),
                       _bits(bits))
    hi, lo = fj.split16(_bits(bits))
    r_hi, r_lo = ref_fj.split16(bits)
    _close("u_hi", hi, r_hi, rtol=0.0, atol=0.0)        # exact
    _close("u_lo", lo, r_lo, rtol=0.0, atol=0.0)
    u, z = fj.split_lane_bits(_bits(bits))
    r_u, r_z = ref_fj.split_lane_bits(bits)
    _close("u_wait", u, r_u, rtol=0.0, atol=0.0)
    _close("|z|", z, r_z, rtol=1e-5, atol=1e-6)
    assert fj.lane_budget(48) == ref_fj.lane_budget(48) == 32
    for T in (8, 24, 48, 192):
        assert fj.compiled_lane_budget(T) == ref_fj.compiled_lane_budget(T)
        assert fj.lane_budget(T) == ref_fj.lane_budget(T)
    assert [fj._bucket(n) for n in (1, 43, 300, 5000)] == \
        [ref_fj._bucket(n) for n in (1, 43, 300, 5000)]


def _engine_state(env) -> dict:
    dev = env._dev
    backlog, sfree = (dev._backlog, dev._sfree_rel)
    return {"clock": env.clocks(),
            "backlog": None if backlog is None else backlog.clone(),
            "sfree": None if sfree is None else sfree.clone(),
            "pending": (dev._pending_arrivals.copy(),
                        dev._pending_gap.copy()),
            "draws": dev.draws.gen.get_state(), "hw": dict(dev._hw),
            "windows": dev._windows, "stats": dev.last_stats}


@pytest.mark.parametrize("window_impl", ["kernel", "scan"])
def test_prewarm_is_state_and_rng_transparent(window_impl):
    """tests/test_fleet_jax.py's prewarm pin, made bitwise: after a window
    and a reconfiguration whose arrivals still wait on the host, prewarm
    runs its ladder and leaves clock, device state, pending buffers, the
    draw stream, the shape marks and the last stats exactly as they were,
    so the next windows equal those of a twin that never prewarmed, to the
    bit."""
    env_a, env_b = (FleetEnv.homogeneous(3, seed=0, device="cpu",
                                         window_impl=window_impl)
                    for _ in range(2))
    for e in (env_a, env_b):
        e.observe(120.0)
        cfgs = e.current_configs()
        cfgs[1]["driver_memory_gb"] = 16.0      # reboot: pending arrivals
        e.apply_configs(cfgs)
    before = _engine_state(env_b)
    assert before["pending"][0][1] > 0
    env_b.prewarm(240.0)
    after = _engine_state(env_b)
    for k in ("clock", "pending"):
        np.testing.assert_array_equal(np.asarray(after[k]),
                                      np.asarray(before[k]), err_msg=k)
    for k in ("backlog", "sfree", "draws"):
        assert torch.equal(after[k], before[k]), k
    assert (after["hw"], after["windows"]) == (before["hw"],
                                               before["windows"])
    assert after["stats"] is before["stats"]
    for _ in range(2):
        sa, sb = env_a.observe_stats(240.0), env_b.observe_stats(240.0)
        for k in ("mean_ms", "p99_ms", "processed", "per_node"):
            assert torch.equal(sa[k], sb[k]), k
    np.testing.assert_array_equal(env_a.clocks(), env_b.clocks())
