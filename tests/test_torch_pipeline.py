"""The pipelined actor/learner of the port (``tune_pipelined`` /
``DeviceEpisodeRunner.run_pipelined``) and the programs under it, on the CPU
(the same program objects run eagerly there, on the same buffers they
capture on the card).

* ``depth=1`` bitwise equal to the port's own sequential ``tune``.
* ``depth=2`` statistically equal to the reference's ``tune_pipelined``
  (each side on its own RNG, ``tests/chaos_harness.py`` tolerances), with
  the full record accounting.
* The programs are built once per static bundle (``CAPTURE_COUNTS`` flat
  across outer iterations), the carry and the agent's state live at fixed
  addresses, and the entry points need the fused loop, as in the reference.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chaos_harness import assert_loop_equivalent  # noqa: E402
from test_torch_slice import (FROZEN, LEVERS, METRICS, MIX,  # noqa: E402
                              _stable_fleet)

from repro.core.configurator import Configurator as RefConfigurator  # noqa: E402
from repro.data.workloads import PoissonWorkload, SwitchingWorkload  # noqa: E402
from repro.engine import FleetEnv as RefFleetEnv  # noqa: E402
from repro_torch.core import Configurator  # noqa: E402
from repro_torch.core.device_loop import CAPTURE_COUNTS  # noqa: E402
from repro_torch.data.workloads import PoissonWorkload as TPoisson  # noqa: E402
from repro_torch.data.workloads import SwitchingWorkload as TSwitching  # noqa: E402
from repro_torch.engine import FleetEnv  # noqa: E402


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _reference_compiled_tier(monkeypatch):
    """The reference's kernel tier pinned to its compiled CPU tier, as in
    tests/test_torch_slice.py."""
    monkeypatch.delenv("REPRO_PALLAS_INTERPRET", raising=False)
    monkeypatch.delenv("REPRO_REQUIRE_COMPILED", raising=False)


def _port(n=8, *, seed=0, bin_kw=FROZEN, **kw):
    env = FleetEnv.heterogeneous(n, seed=seed, mix=MIX, backend="torch",
                                 device="cpu")
    return Configurator(env, METRICS, LEVERS, seed=seed, steps_per_episode=3,
                        window_s=240.0, device_loop="on", bin_kw=bin_kw, **kw)


def assert_same_run(a, b, record_configs: bool = True):
    """Two port configurators that ran the same schedule: parameters,
    rmsprop state, record streams, final configs and clocks bit for bit
    (``record_configs=False``: the records' config dicts aside)."""
    for (name, x), y in zip(a.agent.params.items(), b.agent.params.values()):
        assert torch.equal(x, y), name
    for name, x in a.agent.opt_state["nu"].items():
        assert torch.equal(x, b.agent.opt_state["nu"][name]), name
    assert torch.equal(a.agent.opt_state["count"], b.agent.opt_state["count"])
    assert a.agent.n_updates == b.agent.n_updates
    assert len(a.history) == len(b.history)
    for x, y in zip(a.history, b.history):
        assert (x.lever, x.direction) == (y.lever, y.direction)
        assert x.config == y.config or not record_configs
        assert (x.reward, x.p99_ms, x.clock_s) == (y.reward, y.p99_ms,
                                                   y.clock_s)
    assert a.env.configs == b.env.configs
    assert np.array_equal(a.env.clock, b.env.clock)
    assert np.array_equal(a.env.reconfigs, b.env.reconfigs)


def test_pipeline_depth1_bitwise_equals_sequential():
    a, b = _port(), _port()
    a.tune(3)
    b.tune_pipelined(3, depth=1)
    assert_same_run(a, b)
    # depth 1 through the runner itself: run_cycle per update
    c = _port()
    stats, recs, upds = c._device_runner().run_pipelined(3, depth=1)
    assert len(stats) == len(upds) == 3 and len(recs) == 3 * 8 * 3
    assert [r.reward for r in recs] == [r.reward for r in a.history]


def test_pipeline_depth2_statistically_matches_reference():
    """depth=2 against the reference's depth=2 on a stable-regime fleet,
    each side on its own RNG; the record accounting in full."""
    n, updates = 24, 3
    ref_env = RefFleetEnv(_stable_fleet(PoissonWorkload, SwitchingWorkload,
                                        n), seeds=list(range(n)),
                          backend="pallas")
    env = FleetEnv(_stable_fleet(TPoisson, TSwitching, n),
                   seeds=list(range(n)), backend="torch", device="cpu")
    kw = dict(seed=0, steps_per_episode=3, window_s=240.0, device_loop="on",
              bin_kw=FROZEN)
    ref = RefConfigurator(ref_env, METRICS, LEVERS, mesh="off", **kw)
    port = Configurator(env, METRICS, LEVERS, **kw)
    seen = []
    ref.tune_pipelined(updates, depth=2)
    port.tune_pipelined(updates, depth=2,
                        callback=lambda k, st, h: seen.append((k, st)))
    assert len(port.history) == len(ref.history) == updates * n * 3
    assert port.agent.n_updates == ref.agent.n_updates == updates
    assert [k for k, _ in seen] == list(range(updates))
    for _, st in seen:
        assert st["episodes"] == n and st["steps"] == n * 3
        assert np.isfinite(st["pg_loss"]) and np.isfinite(st["p99_ms"])
    # one update_s per batch, on its batch's last record
    upd = [r.phases["update_s"] for r in port.history]
    assert sum(u > 0.0 for u in upd) == updates
    for p in port.agent.params.values():
        assert torch.isfinite(p).all()
    assert_loop_equivalent(
        np.array([r.reward for r in ref.history]),
        np.array([r.p99_ms for r in ref.history]),
        np.array([r.reward for r in port.history]),
        np.array([r.p99_ms for r in port.history]))


def test_pipeline_depth2_acts_on_stale_params():
    """depth=2 enqueues batch k+1 before update k, so batch 2 acts on the
    initial parameters: the same first two batches as a sequential run
    whose first update never lands before batch 2."""
    a, b = _port(), _port()
    a.tune_pipelined(2, depth=2)
    # the sequential twin: both batches chained before any update
    runner = b._device_runner()
    g0, g1 = runner._dispatch_group(1), runner._dispatch_group(1)
    recs = runner.finalize()
    assert [r.reward for r in a.history] == [r.reward for r in recs]
    for g in (g0, g1):
        b.agent.update_batch(g["states"], g["actions"], g["rewards"])
    for x, y in zip(a.agent.params.values(), b.agent.params.values()):
        assert torch.equal(x, y)


def test_programs_are_built_once_per_bundle_and_read_fixed_buffers():
    cfgr = _port()
    agent = cfgr.agent
    addr = {k: p.data_ptr() for k, p in agent.params.items()}
    nu = {k: v.data_ptr() for k, v in agent.opt_state["nu"].items()}
    cfgr.tune(3)                      # crosses the exploit warm-up (2)
    runner = cfgr._runner
    bufs = [b.data_ptr() for b in runner._bufs]
    tabs = {k: v.data_ptr() for k, v in runner._tabs.items()}
    before = dict(CAPTURE_COUNTS)
    cfgr.tune(3)
    cfgr.tune_pipelined(2, depth=2)
    assert dict(CAPTURE_COUNTS) == before
    assert [b.data_ptr() for b in runner._bufs] == bufs
    assert {k: v.data_ptr() for k, v in runner._tabs.items()} == tabs
    assert {k: p.data_ptr() for k, p in agent.params.items()} == addr
    assert {k: v.data_ptr() for k, v in agent.opt_state["nu"].items()} == nu
    # two episode bundles (exploit off, on) and one update shape
    assert [k[0] for k in runner._programs] == ["episode", "episode"]
    assert len(agent._updates) == 1
    # the engine holds copies of the queueing state, not the buffers
    assert cfgr.env._dev._backlog.data_ptr() != runner._bufs[1].data_ptr()


def test_live_bins_repack_into_the_same_tables():
    """A §2.4.1 split inside a bin rung re-packs the lever tables into the
    same tensors, and the programs stay; the first update's splits cross
    from the 16-bin rung to the 32-bin one (new tables, new programs)."""
    cfgr = _port(bin_kw=dict(split_after=4, extend_after=10**9,
                             merge_after=10**9))
    cfgr.tune(3)                      # and past the exploit warm-up
    runner = cfgr._runner
    assert runner._hw_B == 32
    sig, nv = runner._disc_sig, runner._n_valid.clone()
    tabs = {k: v.data_ptr() for k, v in runner._tabs.items()}
    nv_ptr = runner._n_valid.data_ptr()
    before = dict(CAPTURE_COUNTS)
    cfgr.tune(2)
    assert runner._disc_sig != sig               # the bins split again
    assert not torch.equal(runner._n_valid, nv)
    assert runner._hw_B == 32
    assert {k: v.data_ptr() for k, v in runner._tabs.items()} == tabs
    assert runner._n_valid.data_ptr() == nv_ptr
    assert dict(CAPTURE_COUNTS) == before


def test_adopt_update_and_reference_state_keep_the_buffers():
    cfgr = _port()
    agent = cfgr.agent
    ptrs = [p.data_ptr() for p in agent.params.values()]
    nu_ptrs = [v.data_ptr() for v in agent.opt_state["nu"].values()]
    new = {k: p.detach() + 1.0 for k, p in agent.params.items()}
    opt = {"nu": {k: v + 2.0 for k, v in agent.opt_state["nu"].items()},
           "count": agent.opt_state["count"] + 5}
    agent.adopt_update(new, opt, 3)
    assert agent.n_updates == 3
    for k, p in agent.params.items():
        assert torch.equal(p, new[k])
    assert int(agent.opt_state["count"]) == 5
    ref = {"w1": np.ones((agent.state_dim, 20), np.float32),
           "b1": np.zeros(20, np.float32),
           "w2": np.ones((20, agent.n_actions), np.float32),
           "b2": np.zeros(agent.n_actions, np.float32)}
    agent.load_reference_params(ref, {"nu": ref, "count": np.int32(7)})
    assert int(agent.opt_state["count"]) == 7
    assert [p.data_ptr() for p in agent.params.values()] == ptrs
    assert [v.data_ptr() for v in agent.opt_state["nu"].values()] == nu_ptrs


def test_pipeline_requires_device_loop():
    env = FleetEnv.heterogeneous(2, seed=0, mix=("iot",), device="cpu")
    cfgr = Configurator(env, METRICS, LEVERS, device="cpu",
                        steps_per_episode=2)
    assert cfgr.device_loop_reason() is not None
    with pytest.raises(RuntimeError, match="fused device loop"):
        cfgr.tune_pipelined(2, depth=2)
    # depth 1 is plain tune, which falls back to the host loop
    cfgr.tune_pipelined(1, depth=1)
    assert len(cfgr.history) == 2 * 2 * 2
