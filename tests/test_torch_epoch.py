"""The epoch mega-scan of the port (``run_epoch`` / ``tune_megascan`` and
``AutoTuner.run(epoch_k>1)``), on the CPU, where the epoch's body program
runs eagerly on the buffers it captures on the card.

Against the port's own sequential path, bit for bit:
* ``run_epoch(1)`` three times equals ``tune(3)`` across the exploit
  warm-up boundary, with frozen and with live bins;
* one ``run_epoch(3, records="full")`` equals ``tune(3)`` (frozen bins);
* the shielded chaos twin (``safe=True``, deploy delay 1):
  ``run_epoch(2)`` equals ``tune(2)``, the shield's counters too;
* ``EPOCH_DISPATCHES`` grows by K an epoch, ``CAPTURE_COUNTS`` stays flat.

Against the reference:
* a greedy ``run_epoch(2, explore=False)`` on the reference's draws
  (``JaxDraws``): actions exact, rewards, p99 and parameters f32-allclose;
* ``_epoch_summary`` fed the same count tensor and summaries: the
  ``DynamicBins`` state, the final configs, the counters and the stats
  bitwise, in ``"summary"`` and ``"off"`` mode;
* a K=4 ``"full"`` exploring megascan on the reference's draws and
  weights: actions equal, streams within ``assert_loop_equivalent``;
* the same megascan with each side on its own weights and draws, pooled
  over ``SEED_MATRIX``: streams within ``assert_loop_equivalent``;
* the stats keys of each records mode; ``RuntimeError`` without the loop.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chaos_harness import SEED_MATRIX, assert_loop_equivalent  # noqa: E402
from test_torch_pipeline import _port, assert_same_run  # noqa: E402
from test_torch_slice import (ATOL, FROZEN, LEVERS, METRICS, RTOL,  # noqa: E402
                              _pair, _stable_fleet)
from test_torch_window import JaxDraws  # noqa: E402

from repro.core.configurator import Configurator as RefConfigurator  # noqa: E402
from repro.core.discretize import DeviceLeverTable as RefTable  # noqa: E402
from repro.data.workloads import PoissonWorkload, SwitchingWorkload  # noqa: E402
from repro.engine import FleetEnv as RefFleetEnv  # noqa: E402
from repro_torch.core import AutoTuner, Configurator  # noqa: E402
from repro_torch.core.device_loop import (CAPTURE_COUNTS,  # noqa: E402
                                          EPOCH_DISPATCHES)
from repro_torch.core.discretize import DeviceLeverTable  # noqa: E402
from repro_torch.core.faults import chaos_scenario  # noqa: E402
from repro_torch.data.workloads import PoissonWorkload as TPoisson  # noqa: E402
from repro_torch.data.workloads import SwitchingWorkload as TSwitching  # noqa: E402
from repro_torch.engine import FleetEnv  # noqa: E402

#: the per-update stats keys of each records mode (the reference's
#: ``_epoch_full`` / ``_epoch_summary``; ``p99_ms`` in "full" comes from
#: the configurator's bookkeeping)
BASE_KEYS = {"pg_loss", "mean_return", "episodes", "steps"}
SUMMARY_KEYS = BASE_KEYS | {"reward_mean", "p99_mean_ms", "p99_ms"}


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


# ------------------------------------------------------ the port, bitwise
@pytest.mark.parametrize("bin_kw", [FROZEN, None], ids=["frozen", "live"])
def test_epoch_k1_bitwise_equals_sequential(bin_kw):
    """``run_epoch(1)`` is one sequential outer iteration, §2.4.1 replay
    included; three of them cross the exploit warm-up (2 updates)."""
    a, b = _port(bin_kw=bin_kw), _port(bin_kw=bin_kw)
    a.tune(3)
    for _ in range(3):
        stats = b.run_epoch(1)
        assert len(stats) == 1 and set(stats[0]) == BASE_KEYS | {"p99_ms"}
    assert_same_run(a, b)


def test_epoch_full_records_bitwise_equals_sequential():
    """One K=3 epoch against three sequential updates: frozen bins make
    the sequential path's between-update replay a no-op, so the deferred
    materialisation reproduces the same parameters, records and state."""
    a, b = _port(), _port()
    a.tune(3)
    dispatches = EPOCH_DISPATCHES[0]
    stats = b.run_epoch(3, records="full")
    assert EPOCH_DISPATCHES[0] - dispatches == 3
    assert len(stats) == 3
    assert_same_run(a, b)
    # the callback fires per update, at the epoch's end
    c, seen = _port(), []
    c.tune_megascan(3, k=2, callback=lambda i, st, h: seen.append(
        (i, len(h))))
    assert seen == [(0, 48), (1, 48), (2, 72)]
    assert_same_run(a, c)


def _chaos(n):
    env = FleetEnv([TPoisson(10_000, 0.5) for _ in range(n)],
                   seeds=list(range(n)), backend="torch", device="cpu",
                   faults=chaos_scenario(n, t0_s=500.0, deploy_delay=1))
    return Configurator(env, METRICS, LEVERS, seed=3, steps_per_episode=3,
                        window_s=240.0, device_loop="on", bin_kw=FROZEN,
                        reward_mode="slo", slo_ms=2000.0, safe=True,
                        shield_kw=dict(trust_radius=1, breach_budget=2))


@pytest.mark.parametrize("records", ["full", "summary"])
def test_shielded_chaos_epoch_bitwise_equals_sequential(records):
    """Chaos, deploy delay 1 and the shield: ``run_epoch(2)`` against
    ``tune(2)`` — the shield's counters equal and engaged; in "full" mode
    the whole record stream and the configs re-synced from the indices."""
    a, b = _chaos(8), _chaos(8)
    a.tune(2)
    b.run_epoch(2, records=records)
    sa, sb = a.shield_counters.as_dict(), b.shield_counters.as_dict()
    assert sa == sb
    assert sa["clamped_actions"] + sa["fallbacks"] > 0
    ca, cb = a._runner.chaos.as_dict(), b._runner.chaos.as_dict()
    for key in ("windows", "breached_windows", "fault_events",
                "breach_frac_sum", "p99_max_ms"):
        assert ca[key] == cb[key], key
    assert ca["windows"] == 2 * 8 * 3
    # the summary sums rewards on the device in f32, the records in f64
    assert cb["reward_sum"] == pytest.approx(ca["reward_sum"], rel=1e-6)
    assert b._runner._R_max == 1
    if records == "full":
        # a fallback reverts whole rows, which the record stream's configs
        # do not show: the final configs are re-synced from the indices
        assert_same_run(a, b, record_configs=False)
        return
    for x, y in zip(a.agent.params.values(), b.agent.params.values()):
        assert torch.equal(x, y)
    assert np.array_equal(a.env.clock, b.env.clock)
    for x, y in zip(a._runner._shield, b._runner._shield):
        assert torch.equal(x, y)
    assert torch.equal(a._runner._hist, b._runner._hist)


def test_epochs_dispatch_k_bodies_and_build_no_more_programs():
    cfgr = _port()
    cfgr.run_epoch(3)                       # crosses the exploit warm-up
    cfgr.run_epoch(2, records="summary")
    cfgr.run_epoch(2, records="off")
    before, d0 = dict(CAPTURE_COUNTS), EPOCH_DISPATCHES[0]
    for records in ("full", "summary", "off"):
        cfgr.run_epoch(4, records=records)
    assert EPOCH_DISPATCHES[0] - d0 == 12
    assert dict(CAPTURE_COUNTS) == before
    runner = cfgr._runner
    # one body per (exploit, records mode); none of the per-update programs
    kinds = sorted((k[0], k[1][4], k[3]) for k in runner._programs)
    assert kinds == [("epoch", False, "full"), ("epoch", True, "full"),
                     ("epoch", True, "off"), ("epoch", True, "summary")]
    assert cfgr.agent._updates == {}
    assert cfgr.agent.n_updates == 19 and len(cfgr.history) == 7 * 8 * 3


def test_tuner_runs_epochs_when_asked():
    tuner = AutoTuner(FleetEnv(n=4, backend="torch", device="cpu"), seed=0)
    seen = []
    tuner.run(3, collect_windows=24, epoch_k=2, records="summary",
              configurator_kw=dict(steps_per_episode=2, device_loop="on",
                                   bin_kw=FROZEN),
              callback=lambda i, st, h: seen.append(sorted(st)))
    assert len(seen) == 3 and all(set(k) == SUMMARY_KEYS for k in seen)
    assert tuner.configurator.agent.n_updates == 3
    assert tuner.configurator.history == []


# ------------------------------------------------------ against the reference
def test_greedy_epoch_matches_reference_on_its_draws():
    """``run_epoch(2, explore=False)`` with the reference's draws injected:
    the epoch's ``fold_in(key, draws0 + k·passes + p)`` keys are the same
    stream ``JaxDraws`` replays."""
    ref_env, ref, env, port = _pair(8)
    port.agent.load_reference_params(
        {k: np.asarray(v) for k, v in ref.agent.params.items()})
    env._dev.draws = JaxDraws(ref_env._dev._key, ref_env._dev._draws)
    r_stats, r_recs = ref._device_runner().run_epoch(2, explore=False)
    p_stats, p_recs = port._device_runner().run_epoch(2, explore=False)
    assert [set(s) for s in p_stats] == [set(s) for s in r_stats] \
        == [BASE_KEYS] * 2
    for a, b in zip(p_stats, r_stats):
        assert a["episodes"] == b["episodes"] and a["steps"] == b["steps"]
        assert a["pg_loss"] == pytest.approx(b["pg_loss"], rel=RTOL, abs=ATOL)
        assert a["mean_return"] == pytest.approx(b["mean_return"], rel=RTOL)
    assert len(p_recs) == len(r_recs) == 2 * 8 * 3
    for a, b in zip(p_recs, r_recs):
        assert (a.lever, a.direction, a.config) == (b.lever, b.direction,
                                                    b.config)
        assert a.reward == pytest.approx(b.reward, rel=RTOL)
        assert a.p99_ms == pytest.approx(b.p99_ms, rel=RTOL)
        assert a.clock_s == pytest.approx(b.clock_s, rel=1e-6)
    for name, (ref_name, transpose) in {
            "l1.weight": ("w1", True), "l1.bias": ("b1", False),
            "l2.weight": ("w2", True), "l2.bias": ("b2", False)}.items():
        want = np.asarray(ref.agent.params[ref_name])
        got = port.agent.params[name].detach().numpy()
        np.testing.assert_allclose(got.T if transpose else got, want,
                                   rtol=RTOL, atol=ATOL, err_msg=name)
    assert port.agent.n_updates == ref.agent.n_updates == 2
    assert env.current_configs() == ref_env.current_configs()
    np.testing.assert_allclose(env.clock, ref_env.clock, rtol=1e-6)


def _summary_inputs(n, mode, seed=0):
    """Twin runners with their epoch tables set, and one epoch's count
    tensor, final indices and per-update summaries (seeded)."""
    ref_env, ref, env, port = _pair(n, bin_kw=None)
    rng = np.random.default_rng(seed)
    table = DeviceLeverTable.from_discretiser(port.disc)
    idx0 = table.index_configs(env.current_configs())
    assert np.array_equal(idx0, RefTable.from_discretiser(
        ref.disc).index_configs(ref_env.current_configs()))
    counts = np.zeros((table.n_levers, 16), np.int32)
    idx_f = idx0.copy()
    for name in LEVERS:
        li = table.index_of[name]
        nv = int(table.n_valid[li])
        # a dominant bin and a spread: splits and streaks both fire
        counts[li, :nv] = rng.integers(0, 6, nv)
        counts[li, rng.integers(nv)] += 40
        idx_f[:, li] = rng.integers(0, nv, n)
    k = 2
    ys = {"pg_loss": rng.normal(size=k).astype(np.float32),
          "mean_return": rng.normal(size=k).astype(np.float32),
          "reward_sum": rng.normal(size=k).astype(np.float32),
          "p99_max": rng.uniform(100, 900, k).astype(np.float32),
          "breach_windows": rng.integers(0, 9, k)}
    if mode == "summary":
        ys["reward_mean"] = rng.normal(size=(k, n)).astype(np.float32)
        ys["p99_mean"] = rng.uniform(100, 900, (k, n)).astype(np.float32)
        ys["p99_last"] = rng.uniform(100, 900, (k, n)).astype(np.float32)
    runners = []
    for cfgr, tab_cls in ((ref, RefTable), (port, DeviceLeverTable)):
        runner = cfgr._device_runner()
        runner._table = tab_cls.from_discretiser(cfgr.disc)
        runner._epoch_configs = cfgr.env.current_configs()
        runners.append(runner)
    return runners, [(k, ys)], counts, idx0, idx_f


def _bins_state(disc):
    return {name: (d._edges.tobytes(), d._hits.tobytes(),
                   d._since_used.tobytes(), d._top_streak, d._bot_streak,
                   d._same_streak, d._last_bin,
                   d._rng.bit_generator.state["state"]["state"])
            for name, d in disc.bins.items()}


@pytest.mark.parametrize("mode", ["summary", "off"])
def test_epoch_summary_replays_counts_as_the_reference(mode):
    n = 8
    (ref_r, port_r), ys_segs, counts, idx0, idx_f = _summary_inputs(n, mode)
    before = _bins_state(port_r.cfgr.disc)
    assert before == _bins_state(ref_r.cfgr.disc)
    r_stats = ref_r._epoch_summary(ys_segs, counts, idx0, idx_f, n, 3, 1)
    p_stats = port_r._epoch_summary(
        ys_segs, torch.as_tensor(counts), idx0, torch.as_tensor(idx_f), n,
        3, 1)
    assert p_stats == r_stats
    assert [set(s) for s in p_stats] == [
        SUMMARY_KEYS if mode == "summary" else BASE_KEYS] * 2
    after = _bins_state(port_r.cfgr.disc)
    assert after == _bins_state(ref_r.cfgr.disc)
    assert after != before                       # the replay split bins
    assert port_r.env.configs == ref_r.env.configs
    assert port_r.chaos.as_dict() == ref_r.chaos.as_dict()


def test_megascan_k4_matches_reference_on_its_draws():
    """A K=4 "full" megascan across the exploit warm-up, exploring, with
    the reference's initial weights and draws: every action equal to the
    reference's, the streams within the chaos-harness tolerances. (On its
    own Philox draws the port's exploit phase takes other directions on
    the top lever; which direction a 2-update policy favours is a coin flip
    of the draws, and the trimmed means part.)"""
    n = 24
    ref_env = RefFleetEnv(_stable_fleet(PoissonWorkload, SwitchingWorkload,
                                        n), seeds=list(range(n)),
                          backend="pallas")
    env = FleetEnv(_stable_fleet(TPoisson, TSwitching, n),
                   seeds=list(range(n)), backend="torch", device="cpu")
    kw = dict(seed=0, steps_per_episode=3, window_s=240.0, device_loop="on",
              bin_kw=FROZEN)
    ref = RefConfigurator(ref_env, METRICS, LEVERS, mesh="off", **kw)
    port = Configurator(env, METRICS, LEVERS, **kw)
    port.agent.load_reference_params(
        {k: np.asarray(v) for k, v in ref.agent.params.items()})
    env._dev.draws = JaxDraws(ref_env._dev._key, ref_env._dev._draws)
    ref.tune_megascan(4, k=4, records="full")
    port.tune_megascan(4, k=4, records="full")
    assert len(port.history) == len(ref.history) == 4 * n * 3
    assert port.agent.n_updates == ref.agent.n_updates == 4
    for a, b in zip(port.history, ref.history):
        assert (a.lever, a.direction) == (b.lever, b.direction)
        assert a.reward == pytest.approx(b.reward, rel=RTOL)
    assert_loop_equivalent(
        np.array([r.reward for r in ref.history]),
        np.array([r.p99_ms for r in ref.history]),
        np.array([r.reward for r in port.history]),
        np.array([r.p99_ms for r in port.history]))


def test_megascan_k4_matches_reference_on_own_draws_over_seed_matrix():
    """The exploring K=4 "full" megascan with each package on its own
    initial weights and draws (threefry against Philox), pooled over the
    harness's ``SEED_MATRIX``: the record streams' medians, trimmed means
    and returns agree within the chaos-harness tolerances. (Over seeds 0-31,
    ``tools/seed_matrix.py megascan`` finds the same: pooled medians within
    0.1 %, and the per-seed trimmed means of updates 3 and 4 drawn from one
    distribution by a Mann-Whitney test.)"""
    n = 24
    kw = dict(steps_per_episode=3, window_s=240.0, device_loop="on",
              bin_kw=FROZEN)
    streams = {"ref": ([], []), "port": ([], [])}
    for seed in SEED_MATRIX:
        seeds = [seed * 1000 + i for i in range(n)]
        ref_env = RefFleetEnv(_stable_fleet(PoissonWorkload,
                                            SwitchingWorkload, n),
                              seeds=seeds, backend="pallas")
        env = FleetEnv(_stable_fleet(TPoisson, TSwitching, n), seeds=seeds,
                       backend="torch", device="cpu")
        for side, cfgr in (
                ("ref", RefConfigurator(ref_env, METRICS, LEVERS, mesh="off",
                                        seed=seed, **kw)),
                ("port", Configurator(env, METRICS, LEVERS, seed=seed,
                                      **kw))):
            cfgr.tune_megascan(4, k=4, records="full")
            assert len(cfgr.history) == 4 * n * 3
            streams[side][0].extend(r.reward for r in cfgr.history)
            streams[side][1].extend(r.p99_ms for r in cfgr.history)
    assert_loop_equivalent(*streams["ref"], *streams["port"])


def test_epoch_requires_device_loop():
    env = FleetEnv.heterogeneous(2, seed=0, mix=("iot",), device="cpu")
    cfgr = Configurator(env, METRICS, LEVERS, device="cpu",
                        steps_per_episode=2)
    with pytest.raises(RuntimeError, match="fused device loop"):
        cfgr.run_epoch(2)
    with pytest.raises(RuntimeError, match="fused device loop"):
        cfgr.tune_megascan(2, k=2)
    with pytest.raises(ValueError, match="records"):
        _port()._device_runner().run_epoch(1, records="some")
