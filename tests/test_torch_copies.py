"""Bitwise pins of the port's numpy copies against the reference.

The port imports nothing of ``repro`` (its ``engine``/``core`` packages pull
jax in), so it carries its own copies of the numpy-only modules: configs,
levers, discretisation, workloads, the metric registry, the heat-map
encoder and the simulator's numpy model. Each copy must stay bitwise-equal
to the reference on numpy inputs; where the port runs the same formula on
torch tensors (``xp=txp``) the result must match the numpy one (float64
tensors: allclose at 1e-12, libm's ``log2``/``pow`` may differ in the last
bit; integer index arithmetic: exact).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as ref_configs  # noqa: E402
from repro.core import discretize as ref_disc  # noqa: E402
from repro.core import heatmap as ref_heat  # noqa: E402
from repro.data import workloads as ref_wl  # noqa: E402
from repro.engine import FleetEnv as RefFleetEnv  # noqa: E402
from repro.engine import levers as ref_levers  # noqa: E402
from repro.engine import simcluster as ref_sim  # noqa: E402
from repro.monitoring import metrics as ref_metrics  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import discretize as disc  # noqa: E402
from repro_torch.core import heatmap as heat  # noqa: E402
from repro_torch.data import workloads as wl  # noqa: E402
from repro_torch.engine import FleetEnv  # noqa: E402
from repro_torch.engine import levers  # noqa: E402
from repro_torch.engine import simcluster as sim  # noqa: E402
from repro_torch.monitoring import metrics  # noqa: E402
from repro_torch.utils import txp  # noqa: E402

MIX = ("poisson_low", "trapezoid", "yahoo_ads", "iot", "switching",
       "poisson_high")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _eq(a, b, label=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), label
        for k in a:
            _eq(a[k], b[k], f"{label}.{k}")
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (label, a.dtype,
                                                           b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=label)


def _random_configs(n, seed=0):
    """N configs with every lever moved to a random bin/choice."""
    rng = np.random.default_rng(seed)
    d = ref_disc.LeverDiscretiser(list(ref_levers.LEVER_SPECS), seed=seed)
    cfgs = []
    for _ in range(n):
        c = d.default_config()
        for s in ref_levers.LEVER_SPECS:
            if s.kind == "choice":
                c[s.name] = s.choices[rng.integers(len(s.choices))]
            elif s.kind == "bool":
                c[s.name] = bool(rng.integers(2))
            else:
                v = d.bins[s.name].value(int(rng.integers(10)))
                c[s.name] = v
        cfgs.append(c)
    return cfgs


def test_lever_specs_registry_and_configs_are_copies():
    assert [dataclasses.asdict(s) for s in levers.LEVER_SPECS] == \
        [dataclasses.asdict(s) for s in ref_levers.LEVER_SPECS]
    assert levers.EFFECTIVE == ref_levers.EFFECTIVE
    assert metrics.FACTORS == ref_metrics.FACTORS
    assert [dataclasses.asdict(m) for m in metrics.REGISTRY] == \
        [dataclasses.asdict(m) for m in ref_metrics.REGISTRY]
    for name in ref_configs.ARCH_IDS:
        for reduced in (False, True):
            assert dataclasses.asdict(configs.get(name, reduced)) == \
                dataclasses.asdict(ref_configs.get(name, reduced)), name
    _eq(sim._emission_constants(), ref_sim._emission_constants())


def test_pack_configs_and_service_terms_bitwise():
    cfgs = _random_configs(40, seed=1)
    packed = sim.pack_configs(cfgs)
    _eq(packed, ref_sim.pack_configs(cfgs), "pack_configs")
    models = [ref_configs.get(a) for a in ref_configs.ARCH_IDS] * 4
    pmodels = [configs.get(a) for a in ref_configs.ARCH_IDS] * 4
    mc = sim.model_constants(pmodels)
    _eq(mc, ref_sim.model_constants(models), "model_constants")
    rng = np.random.default_rng(2)
    rate = rng.uniform(1e3, 2e5, 40)
    size = rng.uniform(0.001, 5.0, 40)
    spec = sim.SimSpec()
    assert dataclasses.asdict(spec) == dataclasses.asdict(ref_sim.SimSpec())
    for batch in (None, rng.uniform(0, 4e5, 40)):
        got = sim.service_terms_arrays(packed, mc, spec, 72, rate, size, batch)
        ref = ref_sim.service_terms_arrays(packed, mc, ref_sim.SimSpec(), 72,
                                           rate, size, batch)
        _eq(got, ref, "service_terms_arrays")
        # the same formula on float64 torch tensors through txp
        tt = lambda a: torch.from_numpy(np.asarray(a, np.float64))
        t_out = sim.service_terms_arrays(
            {k: tt(v) if v.dtype != bool else torch.from_numpy(v)
             for k, v in packed.items()},
            {k: tt(v) if v.dtype != bool else torch.from_numpy(v)
             for k, v in mc.items()},
            spec, 72, tt(rate), tt(size), None if batch is None else tt(batch),
            xp=txp)
        for k, v in ref.items():
            np.testing.assert_allclose(t_out[k].numpy(), v, rtol=1e-12,
                                       atol=0.0, err_msg=k)


def test_lever_table_indexing_and_step_index():
    d_ref = ref_disc.LeverDiscretiser(list(ref_levers.LEVER_SPECS), seed=3)
    d = disc.LeverDiscretiser(list(levers.LEVER_SPECS), seed=3)
    # adapt both oracles identically: splits/extends change the ladders
    rng = np.random.default_rng(3)
    cfg_r, cfg = d_ref.default_config(), d.default_config()
    for _ in range(300):
        s = ref_levers.LEVER_SPECS[rng.integers(len(ref_levers.LEVER_SPECS))]
        direction = int(rng.choice([-1, 1]))
        cfg_r = d_ref.apply(cfg_r, s.name, direction)
        cfg = d.apply(cfg, s.name, direction)
    assert cfg == cfg_r
    t_ref = ref_disc.DeviceLeverTable.from_discretiser(d_ref)
    t = disc.DeviceLeverTable.from_discretiser(d)
    _eq(t.centres, t_ref.centres)
    _eq(t.n_valid, t_ref.n_valid)
    cfgs = _random_configs(30, seed=4) + [cfg]
    idx = t.index_configs(cfgs)
    _eq(idx, t_ref.index_configs(cfgs), "index_configs")
    lever = rng.integers(0, t.n_levers, 31)
    direction = rng.choice([-1, 1], 31)
    rows = np.arange(31)
    cur = idx[rows, lever]
    np_new = t.step_index(cur, lever, direction)
    _eq(np_new, t_ref.step_index(cur, lever, direction), "step_index")
    # the fused loop runs the same index arithmetic on torch tensors
    tl = lambda a: torch.from_numpy(np.asarray(a, np.int64))
    got = t.step_index(tl(cur), tl(lever), tl(direction), xp=txp,
                       n_valid=tl(t.n_valid), kind_code=tl(t.kind_code))
    np.testing.assert_array_equal(got.numpy(), np_new)
    assert [t.value_of(int(l), int(b)) for l, b in zip(lever, np_new)] == \
        [t_ref.value_of(int(l), int(b)) for l, b in zip(lever, np_new)]


def test_pack_device_workloads_and_rate_laws():
    wls_r = ref_wl.fleet_workloads(12, seed=5, mix=MIX[:3] + MIX[4:])
    wls = wl.fleet_workloads(12, seed=5, mix=MIX[:3] + MIX[4:])
    _eq(wl.pack_device_workloads(wls).asdict(),
        ref_wl.pack_device_workloads(wls_r).asdict(), "workload table")
    assert wl.device_workload_reason(wl.fleet_workloads(6, mix=MIX)) == \
        ref_wl.device_workload_reason(ref_wl.fleet_workloads(6, mix=MIX))
    t = np.random.default_rng(5).uniform(0, 2e4, 64)
    for a, b in zip(wls, wls_r):
        _eq(a.rate(t), b.rate(t), a.name)
        _eq(a.mean_size(t), b.mean_size(t), a.name)
        assert a.rate(123.0) == b.rate(123.0)
    # the same laws on torch tensors through txp (float64)
    tab = wl.pack_device_workloads(wls)
    tt = torch.from_numpy(t)
    for code, cls in wl.DEVICE_LEAF_CLASSES.items():
        rows = tab.kind_a == code
        p = tab.params_a[rows].astype(np.float64)
        np.testing.assert_allclose(
            cls.device_rate(torch.from_numpy(p)[:, None, :].expand(-1, 64, -1),
                            tt, xp=txp).numpy(),
            cls.device_rate(p[:, None, :], t, np), rtol=1e-12, atol=0.0)
    assert isinstance(wls[0].rate(tt), torch.Tensor)


def test_heatmap_encode_fleet_bitwise():
    spec_r = ref_heat.HeatmapSpec(["a", "b", "c"], ["x", "y"], 10)
    spec = heat.HeatmapSpec(["a", "b", "c"], ["x", "y"], 10)
    assert spec.state_dim == spec_r.state_dim == 3 * 12 + 2
    enc_r, enc = ref_heat.HeatmapEncoder(spec_r), heat.HeatmapEncoder(spec)
    rng = np.random.default_rng(6)
    for _ in range(3):
        mats = rng.normal(size=(7, 10, 3)) * rng.uniform(1, 100, 3)
        fracs = rng.random((7, 2))
        _eq(enc.encode_fleet(mats, fracs), enc_r.encode_fleet(mats, fracs))


def test_configurator_state_encoding_bitwise():
    """The port's ``Configurator`` encodes fleet windows exactly as the
    reference's (dense fleet path and per-cluster path): both encode the
    same windows — the reference numpy oracle's, with every ranked lever
    moved off its default."""
    from repro.core.configurator import Configurator as RefConfigurator
    from repro_torch.core import Configurator

    metric_names = ["latency_p99_ms", "queue_depth", "device_util"]
    lever_names = ["max_batch_events", "prefetch_depth", "backup_tasks",
                   "sink_partitions"]
    env_r = RefFleetEnv.heterogeneous(6, seed=10, mix=MIX)
    ref = RefConfigurator(env_r, metric_names, lever_names, seed=10)
    port = Configurator(FleetEnv.heterogeneous(6, seed=10, mix=MIX,
                                               device="cpu"),
                        metric_names, lever_names, seed=10, device="cpu")
    cfgs = _random_configs(6, seed=10)
    env_r.apply_configs(cfgs)
    wins = env_r.observe(120.0)
    _eq(port._encode_fleet(wins, cfgs), ref._encode_fleet(wins, cfgs),
        "encode_fleet")
    _eq(np.stack([port._encode(w, c) for w, c in zip(wins, cfgs)]),
        np.stack([ref._encode(w, c) for w, c in zip(wins, cfgs)]), "encode")


def test_fleet_core_construction_bitwise():
    env_r = RefFleetEnv.heterogeneous(9, seed=7, mix=MIX, backend="jax")
    env = FleetEnv.heterogeneous(9, seed=7, mix=MIX, device="cpu")
    _eq(env.node_speed, env_r.node_speed, "node_speed")
    _eq(env._emit_factor, env_r._emit_factor, "_emit_factor")
    _eq(env.mc, env_r.mc, "mc")
    _eq(env.packed(), env_r.packed(), "packed")
    assert env.chips == env_r.chips and env.n_nodes == env_r.n_nodes == 10
    assert env.metric_names == env_r.metric_names
    assert env.current_configs() == env_r.current_configs()
    assert np.array_equal(env.runnable_mask(env.current_configs()),
                          env_r.runnable_mask(env_r.current_configs()))
    np.testing.assert_array_equal(env.stabilisation_times(),
                                  env_r.stabilisation_times())


@pytest.mark.parametrize("seed", [8, 11])
@pytest.mark.parametrize("hint", [False, True], ids=["diff", "hint"])
def test_fleet_core_host_ops_bitwise(seed, hint):
    """The host half of ``FleetCore`` the torch engine keeps: installing
    configs (loading noise, Kafka buffering, clocks), the packed levers, the
    stabilisation times and the allow-list guard, bit for bit against the
    reference. Without a ``changed_levers`` hint the loading noise comes from
    the per-cluster streams (reference numpy fleet); with it, from the
    device engine's bulk host RNG (reference jax fleet)."""
    env_r = RefFleetEnv.heterogeneous(7, seed=seed, mix=MIX,
                                      backend="jax" if hint else "numpy")
    env = FleetEnv.heterogeneous(7, seed=seed, mix=MIX, device="cpu")
    for e in (env_r, env):
        e.packed()
    for rnd in range(2):
        cfgs, cfgs_r = env.current_configs(), env_r.current_configs()
        changed = []
        for i in range(env.n):
            lever = ("prefetch_depth", "backup_tasks", "sink_partitions",
                     "max_batch_events")[(i + rnd) % 4]
            v = {"prefetch_depth": i + rnd, "backup_tasks": bool(i % 2),
                 "sink_partitions": 4 + i, "max_batch_events": 4096 * (i + 1)
                 }[lever]
            cfgs[i][lever] = cfgs_r[i][lever] = v
            changed.append([lever])
        kw = dict(changed_levers=changed) if hint else {}
        rep = env.apply_configs(cfgs, **kw)
        rep_r = env_r.apply_configs(cfgs_r, **kw)
        assert rep == rep_r
        _eq(env.clock, env_r.clock, "clock")
        _eq(env.last_load_s, env_r.last_load_s, "last_load_s")
        _eq(env.reconfigs, env_r.reconfigs, "reconfigs")
        _eq(env._dev._pending_arrivals,
            env_r._dev._pending_arrivals if hint else env_r.backlog,
            "buffered arrivals")
        _eq(env.packed(), env_r.packed(), "packed")
        _eq(env.stabilisation_times(), env_r.stabilisation_times(), "stabs")
        props = _random_configs(env.n, seed=seed + rnd)
        moved = [["max_batch_events", "batch_interval_s"]] * env.n
        _eq(env.runnable_delta(props, moved),
            env_r.runnable_delta(props, moved), "runnable_delta")
        _eq(env.runnable_mask(props), env_r.runnable_mask(props), "runnable")


def test_counters_are_copies():
    rng = np.random.default_rng(9)
    c, c_r = metrics.ChaosCounters(), ref_metrics.ChaosCounters()
    for _ in range(3):
        r, p, bf = rng.normal(size=(4, 3)), rng.uniform(0, 3e3, (4, 3)), \
            rng.random((4, 3))
        c.record_batch(r, p, bf, slo_ms=1000.0)
        c_r.record_batch(r, p, bf, slo_ms=1000.0)
    c.add_wall(2.0)
    c_r.add_wall(2.0)
    assert c.as_dict() == c_r.as_dict()
    assert c.prometheus_text() == c_r.prometheus_text()
    s = metrics.ShieldCounters(clamped_actions=3, trust_radius=1.5)
    assert s.as_dict() == ref_metrics.ShieldCounters(
        clamped_actions=3, trust_radius=1.5).as_dict()
    assert metrics.retrace_counts() >= 0
