"""``repro_torch.core.tuner.AutoTuner`` (collect -> analyse -> tune), the
configurator's per-step host loops, the serial ``SimCluster`` and the
``repro_torch.launch.tune`` launcher, against the reference where the
numbers can be matched.

* §2.1 fleet sweep on a constant-rate fleet: the proposals come from the
  tuner's numpy generator and the allow-list guard is host numpy, so the
  lever rows, source clusters and guard count equal the reference's numpy
  ``FleetEnv`` sweep exactly; the metric rows (each engine draws its own
  noise) agree statistically at the ``tests/chaos_harness.py`` tolerances.
* ``analyse`` on one fixed training matrix fed to both packages: ranked
  levers equal; selected metrics equal with the reference's k-means++
  picks injected; the reference's ``save_analysis`` JSON loads.
* The host fleet loop: greedy device actions equal ``act_batch`` (host)
  and the reference's on the same states; host loop against the fused loop
  statistically (``assert_loop_equivalent``).
* ``run_episode`` on ``SimCluster(device="cpu")``; the launcher's files,
  and its serial path. (tests/test_torch_tuner_e2e.py mirrors
  tests/test_tuner_e2e.py.)
"""
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chaos_harness import DEFAULT_TOL, assert_loop_equivalent, rel  # noqa: E402
from test_torch_metrics_selection import ref_picks  # noqa: E402
from test_torch_slice import (FROZEN, LEVERS, METRICS,  # noqa: E402
                              _stable_fleet)

from repro.core import AutoTuner as RefAutoTuner  # noqa: E402
from repro.core.policy import ReinforceAgent as RefAgent  # noqa: E402
from repro.engine import FleetEnv as RefFleetEnv  # noqa: E402
from repro_torch.core import AutoTuner, Configurator  # noqa: E402
from repro_torch.core import metrics_selection as msel  # noqa: E402
from repro_torch.core.configurator import reward_from_latency  # noqa: E402
from repro_torch.data.workloads import PoissonWorkload  # noqa: E402
from repro_torch.data.workloads import SwitchingWorkload  # noqa: E402
from repro_torch.engine import FleetEnv, SimCluster  # noqa: E402

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sweeps():
    """The §2.1 fleet sweep on twin 8-cluster constant-rate fleets."""
    port = AutoTuner(FleetEnv(n=8, device="cpu"), seed=0)
    ref = RefAutoTuner(RefFleetEnv(n=8), seed=0)
    port.collect(320, windows_per_cluster=6)
    ref.collect(320, windows_per_cluster=6)
    return port, ref


def test_collect_fleet_lever_rows_equal_reference(sweeps):
    port, ref = sweeps
    assert len(port.matrix.lever_rows) == len(ref.matrix.lever_rows) == 320
    assert port.matrix.lever_rows == ref.matrix.lever_rows
    assert port.matrix.cluster == ref.matrix.cluster
    assert port.guard_exhausted == ref.guard_exhausted
    assert len({tuple(sorted(r.items())) for r in port.matrix.lever_rows}) \
        > 200


def test_collect_fleet_metric_rows_match_statistically(sweeps):
    port, ref = sweeps
    names = list(port.env.metric_names)
    assert names == list(ref.env.metric_names)
    Xp = port.matrix.metrics_array(names)
    Xr = ref.matrix.metrics_array(names)
    assert Xp.shape == Xr.shape == (320, 90) and np.isfinite(Xp).all()
    for tgt, tol in (("target_mean", DEFAULT_TOL.mean),
                     ("target", DEFAULT_TOL.p99)):
        a = np.median(getattr(port.matrix, tgt))
        b = np.median(getattr(ref.matrix, tgt))
        assert rel(a, b) < tol, (tgt, a, b)
    # every metric's median that is not 0 (each engine draws the emission
    # model's noise; a few metrics are constant 0 at the default config)
    med_p, med_r = np.median(Xp, axis=0), np.median(Xr, axis=0)
    live = np.abs(med_r) > 1e-9
    assert live.sum() > 80
    worst = max(rel(a, b) for a, b in zip(med_p[live], med_r[live]))
    assert worst < DEFAULT_TOL.mean, worst


@pytest.fixture(scope="module")
def analysed(sweeps, tmp_path_factory):
    """Both packages' ``analyse`` on the reference's training matrix, with
    the reference's k-means++ picks injected into the port."""
    _, ref = sweeps
    port = AutoTuner(FleetEnv(n=8, device="cpu"), seed=0)
    for f in ("metric_rows", "lever_rows", "target", "target_mean",
              "cluster"):
        setattr(port.matrix, f, list(getattr(ref.matrix, f)))
    mp = pytest.MonkeyPatch()
    mp.setattr(msel, "select_metrics",
               functools.partial(msel.select_metrics, init=ref_picks))
    try:
        port.analyse(k=8)
    finally:
        mp.undo()
    ref.analyse(k=8)
    path = tmp_path_factory.mktemp("analysis") / "analysis.json"
    ref.save_analysis(path)
    return port, ref, path


def test_analyse_matches_reference_on_one_fixed_matrix(analysed):
    port, ref, _ = analysed
    assert port.ranked_levers == ref.ranked_levers
    assert len(port.ranked_levers) == 8
    assert port.selected_metrics == ref.selected_metrics
    assert port.selection.k == ref.selection.k == 8
    assert port.selection.reduction == ref.selection.reduction
    assert set(port.analyse_s) == {"fa", "kmeans", "lasso", "total"}


def test_reference_save_analysis_loads_into_the_port(analysed):
    _, ref, path = analysed
    d = json.loads(path.read_text())
    assert d["guard_exhausted"] == ref.guard_exhausted
    fresh = AutoTuner(SimCluster(seed=9, device="cpu"), seed=9)
    fresh.load_analysis(path)
    assert fresh.ranked_levers == ref.ranked_levers
    assert fresh.selected_metrics == ref.selected_metrics
    cfgr = fresh.build_configurator(steps_per_episode=2)
    assert cfgr.levers == [l for l in ref.ranked_levers]


def test_host_fleet_loop_greedy_actions_equal_act_batch():
    env = FleetEnv.heterogeneous(6, seed=1, device="cpu")
    cfgr = Configurator(env, METRICS, LEVERS, device_loop="off",
                        steps_per_episode=2, window_s=240.0, seed=3)
    trajs, recs = cfgr.run_fleet_episodes()
    assert len(trajs) == 6 and all(len(t) == 2 for t in trajs)
    assert len(recs) == 12 and env.reconfigs.tolist() == [2] * 6
    states = np.stack([s for t in trajs for s in t.states])
    agent = cfgr.agent
    greedy_dev = agent.act_batch_device(states, greedy=True).numpy()
    np.testing.assert_array_equal(greedy_dev,
                                  agent.act_batch(states, greedy=True))
    ref = RefAgent(agent.state_dim, agent.lever_names, seed=3)
    agent.load_reference_params({k: np.asarray(v)
                                 for k, v in ref.params.items()})
    np.testing.assert_array_equal(agent.act_batch(states, greedy=True),
                                  ref.act_batch(states, greedy=True))
    # the host draws come off the reference's numpy stream
    np.testing.assert_array_equal(agent.act_batch(states[:8]),
                                  ref.act_batch(states[:8]))


def test_host_loop_matches_fused_loop_statistically():
    """Two exploring updates per side on twin stable fleets: the per-step
    host loop against the fused device loop, each drawing its own numbers."""
    n, steps = 24, 3
    sides = {}
    for loop in ("off", "on"):
        env = FleetEnv(_stable_fleet(PoissonWorkload, SwitchingWorkload, n),
                       seeds=list(range(n)), device="cpu")
        cfgr = Configurator(env, METRICS, LEVERS, seed=0,
                            steps_per_episode=steps, window_s=240.0,
                            device_loop=loop, bin_kw=FROZEN)
        w0 = cfgr.agent.policy.l2.weight.detach().clone()
        for _ in range(2):
            st = cfgr.run_update()
        assert st["episodes"] == n and st["steps"] == n * steps
        assert not torch.equal(w0, cfgr.agent.policy.l2.weight)
        sides[loop] = (np.array([x.reward for x in cfgr.history]),
                       np.array([x.p99_ms for x in cfgr.history]))
    (r_host, p_host), (r_fused, p_fused) = sides["off"], sides["on"]
    assert np.isfinite(r_host).all() and (p_host > 0).all()
    assert_loop_equivalent(r_fused, p_fused, r_host, p_host, steps=steps)


def test_run_episode_on_simcluster():
    env = SimCluster(PoissonWorkload(10_000, 0.5), seed=4, device="cpu")
    assert env.device.type == "cpu" and env.n_nodes == 10
    cfgr = Configurator(env, METRICS, ["batch_interval_s", *LEVERS],
                        steps_per_episode=3, window_s=240.0, seed=4)
    assert not cfgr.fleet and "serial" in cfgr.device_loop_reason()
    clock0 = env.clock
    traj, recs = cfgr.run_episode()
    assert len(traj) == len(recs) == 3
    assert env.current_config() == recs[-1].config
    clocks = [clock0] + [r.clock_s for r in recs]
    for r, (a, b) in zip(recs, zip(clocks, clocks[1:])):
        ph = r.phases
        assert set(ph) == {"generation_s", "loading_s", "stabilisation_s",
                           "update_s"}
        assert ph["loading_s"] >= 10.0 and 30.0 <= ph["stabilisation_s"] <= 180.0
        # load + stabilisation + the 240 s window, on whole batch ticks
        assert b - a >= ph["loading_s"] + ph["stabilisation_s"] + 200.0
        assert np.isfinite(r.reward) and r.reward < 0 and r.p99_ms > 0
    w = cfgr._last_window
    assert recs[-1].reward == reward_from_latency(w.latencies_ms)
    stats = cfgr.run_update()        # 4 episodes, then the REINFORCE update
    assert stats["episodes"] == 4 and len(cfgr.history) == 12


def _launch(tmp_path, *args):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.tune", "--device", "cpu",
         "--out", str(tmp_path), *args], capture_output=True, text=True,
        env=env, timeout=600)
    assert out.returncode == 0, out.stderr
    return out.stdout


@pytest.mark.parametrize("fleet", [4, 1], ids=["fleet", "serial"])
def test_launcher_writes_its_three_files(tmp_path, fleet):
    args = ["--fleet", str(fleet), "--collect", "80" if fleet > 1 else "40",
            "--updates", "1", "--steps-per-episode", "2"]
    if fleet == 1:
        args += ["--episodes", "2"]
    text = _launch(tmp_path, *args)
    if fleet > 1:
        assert "[fleet] 4 clusters" in text and "ACTIVE" in text
    else:
        assert "serial TuningEnv" in text and "[fleet]" not in text
    analysis = json.loads((tmp_path / "analysis.json").read_text())
    assert len(analysis["ranked_levers"]) == 8 and analysis["k"] >= 1
    hist = json.loads((tmp_path / "history.json").read_text())
    assert len(hist["history"]) == 2 * max(fleet, 2)
    assert hist["best_p99_ms"] == min(h["p99_ms"] for h in hist["history"])
    prom = (tmp_path / "metrics.prom").read_text()
    assert "repro_chaos_" in prom


def test_flush_guard_writes_the_dump_when_interrupted(tmp_path):
    from repro_torch.monitoring import flush_guard

    path = tmp_path / "out" / "metrics.prom"
    with pytest.raises(KeyboardInterrupt):
        with flush_guard(path, lambda: "repro_chaos_windows_total 3\n"):
            raise KeyboardInterrupt
    assert path.read_text() == "repro_chaos_windows_total 3\n"


def test_unported_launcher_options_raise(tmp_path):
    from repro_torch.launch import tune

    # --safe is ported (tests/test_torch_shield.py); without the SLO reward
    # it exits with the reference's message before any work
    with pytest.raises(SystemExit, match="--safe needs --reward slo"):
        tune.main(["--safe", "--device", "cpu", "--out", str(tmp_path)])
