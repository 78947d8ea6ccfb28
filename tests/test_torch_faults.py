"""Fault scenarios in the port (DESIGN.md §12) against the reference.

* The numpy copy ``repro_torch.core.faults`` is bitwise the reference's:
  ``chaos_scenario`` tables, ``effects`` (on event edges too), the deploy
  delays, pack / unpack on fixed examples (the reference's own round-trip
  property is red on an explicit ``NoFault`` spec; the port packs and
  unpacks that example exactly as the reference does).
* ``fault_effect_grid`` on CPU tensors against the reference's jnp grid.
* The observe window and the fused loop's window step under a chaos table,
  on the reference's draws (``JaxDraws``): f32-allclose.
* Greedy episode batches with the reference's draws injected, under a
  chaos table that fires inside the batch, with a deploy delay of one step
  added: actions, levers and configs exact; states, rewards and p99
  f32-allclose (the shielded case is in tests/test_torch_shield.py).
* The port's own bitwise laws: an all-padding table and out-of-horizon
  events change nothing; a deploy delay of at least the episode's steps
  freezes the engine's config; the first delayed step equals the frozen
  run.
* Statistical, each side on its own generator, pooled over
  ``chaos_harness.SEED_MATRIX``: every tick-effect kind's window statistics
  against the reference's numpy oracle on the observe path, and the fused
  loop's reward and p99 streams against the oracle's host loop.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from chaos_harness import (DEFAULT_TOL, SEED_MATRIX, Tolerances,  # noqa: E402
                           assert_loop_equivalent,
                           assert_window_stats_equivalent,
                           collect_window_stats)
from test_torch_window import JaxDraws, JaxWindow  # noqa: E402

from repro.core import faults as ref_faults  # noqa: E402
from repro.core.configurator import Configurator as RefConfigurator  # noqa: E402
from repro.data.workloads import PoissonWorkload  # noqa: E402
from repro.data.workloads import pack_device_workloads as ref_pack  # noqa: E402
from repro.engine import FleetEnv as RefFleetEnv  # noqa: E402
from repro.engine import fleet_jax as ref_fj  # noqa: E402
from repro_torch.core import Configurator  # noqa: E402
from repro_torch.core import faults  # noqa: E402
from repro_torch.data.workloads import PoissonWorkload as TPoisson  # noqa: E402
from repro_torch.engine import FleetEnv  # noqa: E402
from repro_torch.engine import fleet_torch as fj  # noqa: E402

METRICS = ["latency_p99_ms", "latency_mean_ms", "queue_depth", "device_util",
           "sched_queue_depth"]
LEVERS = ["max_batch_events", "prefetch_depth", "driver_memory_gb",
          "sink_partitions", "backup_tasks"]
MIX = ("poisson_low", "trapezoid", "yahoo_ads", "switching")
FROZEN = dict(split_after=10**9, extend_after=10**9, merge_after=10**9)
#: the greedy-batch criterion of tests/test_torch_slice.py
RTOL, ATOL = 1e-4, 1e-3
#: the window criterion of tests/test_torch_window.py
W_RTOL, W_ATOL = 2e-5, 1e-4
#: the reference's chaos tolerance (tests/test_faults.py): fault windows
#: amplify the oracle's own seed-to-seed spread
CHAOS_TOL = Tolerances(mean=0.15, p99=0.20, processed=0.06)

#: one event per tick-effect kind, timed to land inside the harness's
#: windows (tests/test_faults.py's KIND_EVENTS)
KIND_EVENTS = {
    "straggler": ("StragglerFault", (300.0, 240.0, 3.0)),
    "failure": ("FailureFault", (300.0, 300.0, 6.0)),
    "shock": ("BacklogShockFault", (300.0, 180.0, 2.5)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_compiled_tier(monkeypatch):
    """The reference's compiled CPU tier (see tests/test_torch_slice.py)."""
    monkeypatch.delenv("REPRO_PALLAS_INTERPRET", raising=False)
    monkeypatch.delenv("REPRO_REQUIRE_COMPILED", raising=False)


def _eq_table(got, ref):
    for name in ("kind", "params"):
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _both(events_of):
    """The same per-cluster spec lists built from each package's classes:
    ``events_of(mod)`` returns them for module ``mod``."""
    return events_of(faults), events_of(ref_faults)


# --------------------------------------------------------------------------
# the numpy copy, bitwise
# --------------------------------------------------------------------------

@pytest.mark.parametrize("deploy_delay", [0, 2])
@pytest.mark.parametrize("seed", [0, 3, 7])
def test_chaos_scenario_tables_are_bitwise_copies(seed, deploy_delay):
    for n in (1, 4, 8, 13):
        got = faults.chaos_scenario(n, seed=seed, deploy_delay=deploy_delay)
        ref = ref_faults.chaos_scenario(n, seed=seed,
                                        deploy_delay=deploy_delay)
        _eq_table(got, ref)
        assert got.max_deploy_delay() == ref.max_deploy_delay()
        np.testing.assert_array_equal(got.deploy_delays(),
                                      ref.deploy_delays())
        assert got.deploy_delays().dtype == ref.deploy_delays().dtype
        assert got.has_tick_effects() == ref.has_tick_effects()


def _edge_table(mod):
    return mod.pack_device_faults([
        [mod.StragglerFault(100.0, 50.0, 3.0)],
        [mod.FailureFault(80.0, 60.0, 4.0)],
        [mod.BacklogShockFault(30.0, 120.0, 2.5),
         mod.StragglerFault(90.0, 40.0, 2.0)],
        [mod.DeployLatencyFault(2)],
        [],
        [mod.FailureFault(0.0, 0.0, 8.0)],      # zero duration: 1e-9 tail
    ])


def test_effects_and_delays_bitwise_on_event_edges():
    got, ref = _edge_table(faults), _edge_table(ref_faults)
    _eq_table(got, ref)
    # every event edge (t0, end, end of the restart tail), ±1 ulp-ish
    edges = np.array([0.0, 30.0, 80.0, 90.0, 100.0, 110.0, 130.0, 140.0,
                      150.0, 170.0])
    times = np.concatenate([edges, np.nextafter(edges, -np.inf),
                            np.nextafter(edges, np.inf),
                            np.linspace(0.0, 400.0, 97)])[:, None] \
        * np.ones((1, got.n_clusters))
    for t in (times, times.astype(np.float32), times[5]):
        s, r = got.effects(t)
        s_r, r_r = ref.effects(t)
        assert s.dtype == s_r.dtype and s.shape == s_r.shape
        np.testing.assert_array_equal(s, s_r)
        np.testing.assert_array_equal(r, r_r)
    assert got.max_deploy_delay() == ref.max_deploy_delay() == 2
    assert got.deploy_delays().tolist() == ref.deploy_delays().tolist() \
        == [0, 0, 0, 2, 0, 0]
    assert got.has_tick_effects() and ref.has_tick_effects()
    for mod in (faults, ref_faults):
        assert not mod.no_faults(4, n_events=3).has_tick_effects()
        only = mod.pack_device_faults([[mod.DeployLatencyFault(3)]] * 2)
        assert not only.has_tick_effects() and only.max_deploy_delay() == 3
        assert mod.no_faults(2).max_deploy_delay() == 0


def test_pack_unpack_bitwise_on_fixed_examples():
    def events(mod):
        return [[mod.StragglerFault(100.0, 50.0, 3.0)],
                [mod.FailureFault(10.0, 20.0), mod.DeployLatencyFault(2)],
                [mod.BacklogShockFault(5.0, 30.0, 2.0)],
                [],
                [mod.FailureFault(0.1, 1e-3, 7.25),
                 mod.StragglerFault(3.3, 4.4, 1.1),
                 mod.DeployLatencyFault(5)]]

    ev, ev_r = _both(events)
    for n_events in (None, 3, 5):
        t = faults.pack_device_faults(ev, n_events=n_events)
        t_r = ref_faults.pack_device_faults(ev_r, n_events=n_events)
        _eq_table(t, t_r)
        back, back_r = faults.unpack_device_faults(t), \
            ref_faults.unpack_device_faults(t_r)
        assert [[(type(f).__name__, vars(f)) for f in row] for row in back] \
            == [[(type(f).__name__, vars(f)) for f in row] for row in back_r]
        # the round trip holds on spec lists without an explicit NoFault
        _eq_table(faults.pack_device_faults(back, n_events=t.n_events), t)
    with pytest.raises(ValueError):
        faults.pack_device_faults(ev, n_events=2)
    with pytest.raises(ValueError):
        faults.pack_device_faults([[object()]])
    with pytest.raises(ValueError):
        FleetEnv(n=2, device="cpu", faults=faults.no_faults(3))


def test_explicit_nofault_packs_and_unpacks_as_the_reference_does():
    """The reference packs an explicit ``NoFault()`` as kind 0, the padding
    code, and its unpack drops it — so this example does not round-trip
    (the reference's hypothesis property is red on it). The copy keeps
    that behaviour, bit for bit."""
    ev, ev_r = _both(lambda m: [[m.NoFault(), m.DeployLatencyFault(0)]])
    t, t_r = faults.pack_device_faults(ev), ref_faults.pack_device_faults(ev_r)
    _eq_table(t, t_r)
    assert t.kind.tolist() == [[0, 4]]
    back = faults.unpack_device_faults(t)
    back_r = ref_faults.unpack_device_faults(t_r)
    assert [type(f).__name__ for f in back[0]] == \
        [type(f).__name__ for f in back_r[0]] == ["DeployLatencyFault"]
    t2 = faults.pack_device_faults(back)
    t2_r = ref_faults.pack_device_faults(back_r)
    _eq_table(t2, t2_r)
    assert t2.kind.shape != t.kind.shape        # the NoFault slot is gone


# --------------------------------------------------------------------------
# the device grid
# --------------------------------------------------------------------------

def test_fault_effect_grid_matches_reference_grid():
    tab = _edge_table(ref_faults)
    wide = ref_faults.pack_device_faults(
        [[ref_faults.StragglerFault(100.0, 50.0, 3.0)],
         [ref_faults.FailureFault(80.0, 60.0, 4.0)],
         [ref_faults.BacklogShockFault(30.0, 120.0, 2.5),
          ref_faults.StragglerFault(90.0, 40.0, 2.0)],
         [ref_faults.DeployLatencyFault(2)], [],
         [ref_faults.FailureFault(0.0, 0.0, 8.0)]], n_events=4)
    rng = np.random.default_rng(0)
    times = np.concatenate([np.linspace(0.0, 400.0, 161)[:, None]
                            * np.ones((1, 6)),
                            rng.uniform(0.0, 400.0, (40, 6))]).astype(
                                np.float32)
    for table in (tab, wide):
        ft = {k: torch.from_numpy(v) for k, v in table.asdict().items()}
        s, r = fj.fault_effect_grid(ft, torch.from_numpy(times))
        s_j, r_j = ref_fj.fault_effect_grid(
            {k: jnp.asarray(v) for k, v in table.asdict().items()},
            jnp.asarray(times))
        assert s.dtype == r.dtype == torch.float32
        assert s.shape == r.shape == times.shape
        np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-6,
                                   atol=0.0)
        np.testing.assert_allclose(r.numpy(), np.asarray(r_j), rtol=1e-6,
                                   atol=0.0)
        # rows that only hold padding (or deploy latency) are exactly 1.0
        for i in (3, 4):
            assert (s[:, i] == 1.0).all() and (r[:, i] == 1.0).all()
        assert torch.isfinite(s).all() and torch.isfinite(r).all()
        # the f64 numpy twin agrees to f32 rounding
        s_h, r_h = table.effects(times.astype(np.float64))
        np.testing.assert_allclose(s.numpy(), s_h, rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(r.numpy(), r_h, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# the windows under chaos, on the reference's draws
# --------------------------------------------------------------------------

def _chaos_fleets(n, seed=0, t0_s=100.0, deploy_delay=0):
    ref = RefFleetEnv.heterogeneous(
        n, seed=seed, mix=MIX, backend="pallas",
        faults=ref_faults.chaos_scenario(n, t0_s=t0_s, seed=seed,
                                         deploy_delay=deploy_delay))
    port = FleetEnv.heterogeneous(
        n, seed=seed, mix=MIX, backend="torch", device="cpu",
        faults=faults.chaos_scenario(n, t0_s=t0_s, seed=seed,
                                     deploy_delay=deploy_delay))
    return ref, port


def _close(name, got, ref, rtol=W_RTOL, atol=W_ATOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), rtol=rtol, atol=atol,
                               err_msg=name)


def test_observe_stats_under_chaos_matches_reference():
    """The observe path: host-evaluated f64 effect grids, the rate grid
    premultiplied and f_slow through the kernel's fmult operand."""
    ref_env, env = _chaos_fleets(8, seed=3)
    env._dev.draws = JaxDraws(ref_env._dev._key)
    for preroll in (np.linspace(30.0, 180.0, 8), None, None):
        r = ref_env.observe_stats(240.0, preroll_s=preroll)
        p = env.observe_stats(240.0, preroll_s=preroll)
        for k in ("mean_ms", "p99_ms", "processed", "per_node"):
            _close(k, p[k], r[k])
        np.testing.assert_allclose(env.clock, ref_env.clock, rtol=1e-12)
    assert env.clock.min() > 600.0     # every event began inside the run


def test_step_window_under_chaos_matches_reference():
    """The fused loop's window step with the fault grid on the device."""
    import jax

    n = 8
    ref_env, env = _chaos_fleets(n, seed=1)
    sel = tuple(env.metric_names.index(m) for m in METRICS)
    T, E = 24, 4
    ref_step = jax.jit(ref_fj.build_step_window(ref_env, sel, T, E,
                                                pallas=True, slo_ms=2000.0))
    step = fj.build_step_window(env, sel, T, E, slo_ms=2000.0)
    rng = np.random.default_rng(n)
    backlog = rng.uniform(0, 3e5, n).astype(np.float32)
    sfree = rng.uniform(0, 20, n).astype(np.float32)
    clock = rng.uniform(0, 400, n).astype(np.float32)   # events at 100 s+
    stab = rng.uniform(30, 120, n).astype(np.float32)
    reconf = rng.integers(0, 5, n).astype(np.float32)
    cc = {k: np.asarray(v, np.float32) for k, v in env.packed().items()}
    wl = ref_pack(ref_env.workloads).asdict()
    ft = ref_env._faults.asdict()
    key = jax.random.PRNGKey(5)
    (rb, rs, rc), rstats = ref_step(
        key, jnp.asarray(backlog), jnp.asarray(sfree), jnp.asarray(clock),
        {k: jnp.asarray(v) for k, v in cc.items()},
        {k: jnp.asarray(v) for k, v in wl.items()}, jnp.asarray(stab),
        jnp.asarray(reconf), 120.0,
        ft={k: jnp.asarray(v) for k, v in ft.items()})
    tt = torch.from_numpy
    (b, s, c), stats = step(
        JaxWindow(key), tt(backlog), tt(sfree), tt(clock),
        {k: tt(v) for k, v in cc.items()}, {k: tt(v) for k, v in wl.items()},
        tt(stab), tt(reconf), 120.0,
        ft={k: tt(v) for k, v in env._faults.asdict().items()})
    _close("backlog", b, rb)
    _close("sfree", s, rs)
    _close("clock", c, rc)
    for k in ("mean_ms", "p99_ms", "processed", "per_node", "breach_frac"):
        _close(k, stats[k], rstats[k])
    # and the faults bit: the same step without the table differs
    (b0, _, _), st0 = step(
        JaxWindow(key), tt(backlog), tt(sfree), tt(clock),
        {k: tt(v) for k, v in cc.items()}, {k: tt(v) for k, v in wl.items()},
        tt(stab), tt(reconf), 120.0)
    assert not torch.equal(st0["mean_ms"], stats["mean_ms"])


# --------------------------------------------------------------------------
# greedy episode batches with the reference's draws
# --------------------------------------------------------------------------

def _greedy_pair(n=8, *, seed=0, steps=3, deploy_delay=0, t0_s=500.0,
                 **over):
    ref_env, env = _chaos_fleets(n, seed=seed, t0_s=t0_s,
                                 deploy_delay=deploy_delay)
    kw = dict(seed=seed, steps_per_episode=steps, window_s=240.0,
              device_loop="on", bin_kw=FROZEN)
    kw.update(over)
    ref = RefConfigurator(ref_env, METRICS, LEVERS, mesh="off", **kw)
    port = Configurator(env, METRICS, LEVERS, **kw)
    port.agent.load_reference_params(
        {k: np.asarray(v) for k, v in ref.agent.params.items()})
    env._dev.draws = JaxDraws(ref_env._dev._key)
    rb, rrec = ref.run_fleet_episodes_device(explore=False)
    pb, prec = port.run_fleet_episodes_device(explore=False)
    return (ref_env, ref, rb, rrec), (env, port, pb, prec)


def assert_greedy_batches_equal(ref_side, port_side, n, steps):
    """tests/test_torch_slice.py's greedy-batch criterion."""
    ref_env, ref, rb, rrec = ref_side
    env, port, pb, prec = port_side
    np.testing.assert_array_equal(pb["actions"].numpy(),
                                  np.asarray(rb["actions"]))
    np.testing.assert_allclose(pb["states"].numpy(), np.asarray(rb["states"]),
                               rtol=RTOL, atol=1e-5)
    np.testing.assert_allclose(pb["rewards"].numpy(),
                               np.asarray(rb["rewards"]), rtol=RTOL, atol=0.0)
    assert len(prec) == len(rrec) == n * steps
    for a, b in zip(prec, rrec):
        assert a.lever == b.lever and a.direction == b.direction
        assert a.config == b.config
        assert a.p99_ms == pytest.approx(b.p99_ms, rel=RTOL)
        assert a.clock_s == pytest.approx(b.clock_s, rel=1e-6)
    np.testing.assert_allclose(env._dev._backlog.numpy(),
                               np.asarray(ref_env._dev._backlog),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(env.clock, ref_env.clock, rtol=1e-6)
    assert env.reconfigs.tolist() == ref_env.reconfigs.tolist()
    assert env.current_configs() == ref_env.current_configs()


@pytest.mark.parametrize("deploy_delay", [0, 1], ids=["chaos", "chaos-delay1"])
def test_greedy_batch_under_chaos_matches_reference_exactly(deploy_delay):
    n, steps = 8, 3
    ref_side, port_side = _greedy_pair(n, steps=steps,
                                       deploy_delay=deploy_delay)
    assert_greedy_batches_equal(ref_side, port_side, n, steps)
    ref_env, ref = ref_side[:2]
    env, port = port_side[:2]
    clock = np.array([r.clock_s for r in port_side[3]])
    # the events begin at 500 s, inside the batch's windows
    assert (clock - 240.0).min() < 500.0 < clock.max()
    runner, ref_runner = port._runner, ref._runner
    assert runner._R_max == ref_runner._R_max == deploy_delay
    assert runner.chaos.fault_events == ref_runner.chaos.fault_events
    assert runner.chaos.as_dict()["windows"] == n * steps
    if deploy_delay:
        np.testing.assert_array_equal(runner._hist.numpy(),
                                      np.asarray(ref_runner._hist))


# --------------------------------------------------------------------------
# the port's own bitwise laws
# --------------------------------------------------------------------------

def _port_run(faults_table, *, steps=3, updates=1, greedy=True, n=6,
              reward_mode="neg_mean"):
    env = FleetEnv([TPoisson(10_000, 0.5) for _ in range(n)],
                   seeds=list(range(n)), device="cpu", faults=faults_table)
    cfgr = Configurator(env, METRICS, LEVERS, seed=0, device="cpu",
                        steps_per_episode=steps, window_s=240.0,
                        device_loop="on", bin_kw=FROZEN,
                        reward_mode=reward_mode)
    if greedy:
        _, recs = cfgr.run_fleet_episodes_device(explore=False)
    else:
        for _ in range(updates):
            cfgr.run_update()
        recs = cfgr.history
    return recs, env, cfgr


def _stream(recs):
    return ([r.reward for r in recs], [r.p99_ms for r in recs],
            [r.clock_s for r in recs], [(r.lever, r.direction) for r in recs])


def test_padding_and_out_of_horizon_tables_replay_no_faults_bitwise():
    n = 6
    far = 1e5
    out_of_horizon = faults.pack_device_faults(
        [[faults.StragglerFault(far, 50.0, 3.0)], [faults.FailureFault(far, 60.0)],
         [faults.BacklogShockFault(far, 60.0, 2.0)], [], [], []])
    base, env0, _ = _port_run(None, greedy=False, updates=2)
    backlog0 = env0._dev._backlog.clone()
    configs0 = env0.current_configs()
    s0 = env0.observe_stats(240.0)       # the observe path too
    for table in (faults.no_faults(n, n_events=2), out_of_horizon):
        recs, env, _ = _port_run(table, greedy=False, updates=2)
        assert _stream(recs) == _stream(base)
        assert env.current_configs() == configs0
        assert torch.equal(env._dev._backlog, backlog0)
        s1 = env.observe_stats(240.0)
        for k in ("mean_ms", "p99_ms", "processed", "per_node"):
            assert torch.equal(s0[k], s1[k]), k


def _delayed(delay, n=6):
    return (faults.pack_device_faults([[faults.DeployLatencyFault(delay)]
                                       for _ in range(n)]) if delay else None)


def test_deploy_delay_beyond_episode_freezes_the_config():
    r3, _, c3 = _port_run(_delayed(3))
    r5, _, _ = _port_run(_delayed(5))
    assert _stream(r3)[:3] == _stream(r5)[:3]
    assert c3._runner._R_max == 3


def test_first_delayed_step_equals_the_frozen_run():
    S = 3
    r0, _, _ = _port_run(None)
    r1, _, _ = _port_run(_delayed(1))
    rf, _, _ = _port_run(_delayed(3))
    step0_levers = lambda recs: [(r.lever, r.direction) for r in recs[0::S]]
    assert step0_levers(r0) == step0_levers(r1) == step0_levers(rf)
    step0 = lambda recs: [(r.reward, r.p99_ms) for r in recs[0::S]]
    assert step0(r1) == step0(rf)
    assert step0(r0) != step0(r1)
    last = lambda recs: [r.reward for r in recs[S - 1::S]]
    assert last(r1) != last(rf)


# --------------------------------------------------------------------------
# statistical, each side on its own generator
# --------------------------------------------------------------------------

def _kind_table(mod, kind, n):
    if kind is None:
        return None
    cls, args = KIND_EVENTS[kind]
    return mod.pack_device_faults([[getattr(mod, cls)(*args)]
                                   for _ in range(n)])


_STATS: dict = {}


def _pooled_window_stats(side, kind, n=6):
    key = (side, kind)
    if key not in _STATS:
        per = []
        for s in SEED_MATRIX:
            if side == "numpy":
                env = RefFleetEnv([PoissonWorkload(10_000, 0.5)
                                   for _ in range(n)],
                                  seeds=[s + i for i in range(n)],
                                  backend="numpy",
                                  faults=_kind_table(ref_faults, kind, n))
            else:
                env = FleetEnv([TPoisson(10_000, 0.5) for _ in range(n)],
                               seeds=[s + i for i in range(n)], device="cpu",
                               faults=_kind_table(faults, kind, n))
            per.append(collect_window_stats(env, windows=2))
        _STATS[key] = {k: float(np.mean([p[k] for p in per]))
                       for k in per[0]}
    return _STATS[key]


@pytest.mark.parametrize("kind", sorted(KIND_EVENTS))
def test_fault_kind_window_stats_match_reference_oracle(kind):
    got = _pooled_window_stats("torch", kind)
    ref = _pooled_window_stats("numpy", kind)
    assert_window_stats_equivalent(got, ref, CHAOS_TOL)
    # and the kind bites: a pin between two no-op runs would pass vacuously
    clean = _pooled_window_stats("torch", None)
    if kind == "shock":
        assert got["processed"] > 1.3 * clean["processed"], (clean, got)
    else:
        assert got["mean"] > 1.05 * clean["mean"], (kind, clean, got)


def _loop_streams(side, kind, n=6, steps=3, updates=2):
    r_all, p_all = [], []
    for s in SEED_MATRIX:
        kw = dict(seed=s, steps_per_episode=steps, window_s=240.0,
                  bin_kw=FROZEN)
        if side == "numpy":
            env = RefFleetEnv([PoissonWorkload(10_000, 0.5)
                               for _ in range(n)],
                              seeds=[s + i for i in range(n)],
                              backend="numpy",
                              faults=_kind_table(ref_faults, kind, n))
            cfgr = RefConfigurator(env, METRICS, LEVERS, device_loop="off",
                                   mesh="off", **kw)
        else:
            env = FleetEnv([TPoisson(10_000, 0.5) for _ in range(n)],
                           seeds=[s + i for i in range(n)], device="cpu",
                           faults=_kind_table(faults, kind, n))
            cfgr = Configurator(env, METRICS, LEVERS, device_loop="on",
                                device="cpu", **kw)
        for _ in range(updates):
            cfgr.run_update()
        r_all.append([x.reward for x in cfgr.history])
        p_all.append([x.p99_ms for x in cfgr.history])
    return np.concatenate(r_all), np.concatenate(p_all)


@pytest.mark.parametrize("kind", sorted(KIND_EVENTS))
def test_fault_kind_fused_loop_matches_reference_oracle_loop(kind):
    """The fused loop on a faulted fleet (the grid on the device, the
    kernel's fmult) against the reference's numpy oracle under its host
    loop, at the chaos harness's loop tolerances."""
    r_ref, p_ref = _loop_streams("numpy", kind)
    r, p = _loop_streams("torch", kind)
    assert np.isfinite(r).all() and (p > 0).all()
    assert_loop_equivalent(r_ref, p_ref, r, p, tol=DEFAULT_TOL)
